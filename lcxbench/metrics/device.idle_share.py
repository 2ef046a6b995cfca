"""The share of the profiled sub-window, on the card's clock, in which no
kernel, copy or fill ran, in %."""


def read(run):
    p = run.profile
    if p is None or p.window_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us() / p.window_us)

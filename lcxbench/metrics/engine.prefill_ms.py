"""Mean of the engine's ``timings["prefill_ms"]`` (host clock, ending in
the host copy of the first token) of the window's prefills, the profiled
sub-window left out."""
from lcxbench.readers import host_ticks


def read(run):
    v = [ms for t in host_ticks(run) for ms in t.prefill_ms]
    return sum(v) / len(v) if v else None

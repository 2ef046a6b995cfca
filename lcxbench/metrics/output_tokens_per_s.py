"""Output tokens delivered inside the window over the window's length."""


def read(run):
    close = run.window.close
    n = sum(1 for r in run.window.records.values() for t in r.times
            if t <= close)
    return n / close if n else None

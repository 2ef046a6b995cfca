"""95th percentile of every gap between consecutive output tokens of one
request, both delivered inside the window."""
from lcxbench.stats import percentile


def read(run):
    close = run.window.close
    gaps = []
    for r in run.window.records.values():
        t = [x for x in r.times if x <= close]
        gaps += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return percentile(gaps, 95)

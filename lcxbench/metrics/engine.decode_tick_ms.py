"""Mean of the engine's ``timings["decode_ms"]`` (host clock, ending in the
host copy of the sampled tokens) of the window's decode ticks, the
profiled sub-window left out."""
from lcxbench.readers import host_ticks


def read(run):
    v = [ms for t in host_ticks(run) for ms in t.decode_ms]
    return sum(v) / len(v) if v else None

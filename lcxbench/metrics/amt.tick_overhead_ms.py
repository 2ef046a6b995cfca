"""Mean, over the window's ticks, of the harness's span around
``tick()`` less the engine's prefill and decode times inside it: the AMT
executor's task graph and the LCX runtime under it (the profiled
sub-window left out)."""
from lcxbench.readers import host_ticks


def read(run):
    v = [(t.end - t.start) * 1e3 - sum(t.prefill_ms) - sum(t.decode_ms)
         for t in host_ticks(run)]
    return sum(v) / len(v) if v else None

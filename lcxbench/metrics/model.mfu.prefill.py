"""Counted operations of the window's prefills (``counts.prefill_flops``
of each admitted prompt) over their summed ``prefill_ms``, as a share of
the H100's bf16 peak (the profiled sub-window left out)."""
from lcxbench import counts
from lcxbench.readers import host_ticks


def read(run):
    ticks = [t for t in host_ticks(run) if t.prompts]
    ms = sum(sum(t.prefill_ms) for t in ticks)
    if not ms:
        return None
    flops = sum(counts.prefill_flops(run.cfg, n) for t in ticks
                for n in t.prompts)
    return 100.0 * flops / (ms / 1e3) / counts.PEAK_FLOPS_BF16

"""Counted operations of the window's decode ticks (each live slot's token
at its true context, ``counts.decode_flops``) over their summed
``decode_ms``, as a share of the H100's bf16 peak (the profiled
sub-window left out)."""
from lcxbench import counts
from lcxbench.readers import host_ticks


def read(run):
    ticks = [t for t in host_ticks(run) if t.decode_ms]
    ms = sum(sum(t.decode_ms) for t in ticks)
    if not ms:
        return None
    flops = sum(counts.decode_flops(run.cfg, t.decode_lengths)
                for t in ticks)
    return 100.0 * flops / (ms / 1e3) / counts.PEAK_FLOPS_BF16

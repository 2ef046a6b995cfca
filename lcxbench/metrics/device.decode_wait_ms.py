"""Mean of the program's ``decode.sync`` spans (``ServingEngine.trace``) over
the window's decode ticks, the profiled sub-window left out: the host copy
of the sampled tokens, which waits for the card to finish what the dispatch
enqueued, in ms (how far the card lagged the host).  Once the dispatch has
filled the card's launch queue (about a thousand launches, PERF.md, section
5), this reads only the drain of its last launches; the rest of the card's
lag then sits in the dispatch span.  That happens in every prefill of the
open cells and in internlm2-code's decode ticks; ``trace_report.py`` counts
the launches of each dispatch on the card's clock."""
from lcxbench.program_trace import mean_span


def read(run):
    return mean_span(run, "decode.sync")

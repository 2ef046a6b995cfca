"""Mean of the program's ``prefill.dispatch`` spans (``ServingEngine.trace``)
over the window's prefills, the profiled sub-window left out: the prompt's
copy to the card, enqueuing ``prefill`` and ``sample_token``, in ms.  This
is host time only while the card keeps up.  The card's launch queue holds
about a thousand launches (PERF.md, section 5): a dispatch of more, behind
a card that lags, waits inside this span for free slots, so the span then
holds card time as well.  That happens in every prefill of the open cells
and in internlm2-code's decode ticks; ``trace_report.py`` counts the
launches of each dispatch on the card's clock."""
from lcxbench.program_trace import mean_span


def read(run):
    return mean_span(run, "prefill.dispatch")

"""The share of the profiled sub-window, on the card's clock, in %, in
which no kernel ran while the host was inside the program's
``decode.dispatch`` or ``prefill.dispatch`` span: the card waiting for the
host to enqueue.  The spans are placed on the card's clock by
``program_trace.on_card``."""
from lcxbench.program_trace import idle_share_under


def read(run):
    return idle_share_under(run, ("decode.dispatch", "prefill.dispatch"))

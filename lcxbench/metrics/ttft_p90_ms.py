"""90th percentile, over every request due in the window, of the time from
its due time to the end of the ``tick()`` that returned its first token; a
request that failed or never got one counts as infinite (then nothing is
read)."""
import math

from lcxbench.stats import percentile


def read(run):
    v = percentile([(r.first - r.req.due) * 1e3
                    if r.first is not None and not r.failed else math.inf
                    for r in run.window.due_in_window()], 90)
    return None if v is None or math.isinf(v) else v

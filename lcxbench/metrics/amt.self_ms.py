"""Mean over the window's ticks, the profiled sub-window left out, of the
program's ``amt.run`` span less the ``amt.task`` spans inside it
(``ServingEngine.trace``): the AMT executor's own time a tick (its graph
walk, the LCX progress calls, retirement), in ms."""
from lcxbench.program_trace import mean_self


def read(run):
    return mean_self(run, "amt.run", "amt.task")

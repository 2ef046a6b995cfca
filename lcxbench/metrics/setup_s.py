"""Seconds from the process's start to the window's opening (the first
request due): imports, building or loading the kernels, drawing the
weights, the engine and its cache, the warm-up."""


def read(run):
    return run.setup_s

"""The card's peak of allocated memory over set-up and the window, in GiB
(``torch.cuda.max_memory_allocated``, the same reading as the result's
``device.memory_peak_bytes``): weights, the engine's cache and the largest
step's activations, what a deployment of the cell has to hold.  None
without a card."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None

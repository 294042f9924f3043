"""The share of the profiled stretch that the training step's backward
pass takes on the host: the ``train.backward`` ranges (the gradients,
the recomputation under ``remat`` included) over the stretch's
seconds."""

from portbench.spans import share


def read(ctx):
    return share(ctx, "train.backward")

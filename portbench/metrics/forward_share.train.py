"""The share of the profiled stretch that the training step's forward
pass takes on the host: the ``train.forward`` ranges (the compute
copy's refill, ``train.cast``, included) over the stretch's seconds."""

from portbench.spans import share


def read(ctx):
    return share(ctx, "train.forward")

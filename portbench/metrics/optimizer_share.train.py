"""The share of the profiled stretch that the optimizer takes on the
host: the ``train.optimizer`` ranges (AdamW's update and the
parameters' ``add_``) over the stretch's seconds."""

from portbench.spans import share


def read(ctx):
    return share(ctx, "train.optimizer")

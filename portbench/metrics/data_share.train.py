"""The share of the profiled stretch that the data takes on the host:
the ``train.batch`` ranges (the step's batch from the feed, and its
copy to the card) over the stretch's seconds."""

from portbench.spans import share


def read(ctx):
    return share(ctx, "train.batch")

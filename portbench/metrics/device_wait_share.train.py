"""The share of the profiled stretch in which the training step's host
waits for the card: the runtime calls inside the ``train.step`` ranges
that return only once the card has run the work queued before them
(stream, device and event synchronisations, and copies to or from
pageable memory: ``float(loss)``, the batch, AdamW's scalars, the
checksums' transfers, the slot step's copy to the host) over the
stretch's seconds. None on a machine whose trace has no device
operations."""

from portbench.spans import wait_share


def read(ctx):
    return wait_share(ctx)

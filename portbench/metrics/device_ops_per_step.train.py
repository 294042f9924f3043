"""The device operations (kernels, copies, sets) of one training step:
those that the host events inside the profiled stretch's ``train.step``
ranges launched, tied to them by correlation id, over the number of
those ranges. None on a machine whose trace has no device operations."""

from portbench.spans import ops_per_step


def read(ctx):
    return ops_per_step(ctx)

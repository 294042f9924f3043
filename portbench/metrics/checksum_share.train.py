"""The share of the profiled stretch that the ADCC checksums take on the
host: the step's ``train.checksums`` ranges (the squared gradients'
sums, the norm, the checksum trees of the parameters, the optimizer's
state and the update; computed in every mode) and the trainer's
``adcc.record`` ranges (their transfers into the ledger's record;
``adcc`` mode only) over the stretch's seconds."""

from portbench.spans import share


def read(ctx):
    return share(ctx, "train.checksums", "adcc.record")

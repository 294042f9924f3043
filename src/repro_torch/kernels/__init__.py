"""Hand-written CUDA kernels for the paper's integrity math.

  abft_matmul      matrix product with fused ABFT checksum epilogue
  checksum_verify  one-pass row/column sums for checksum verification

Each kernel lives in ``csrc/`` as CUDA C++ for ``sm_90a``; ``_build``
compiles it at its first launch. Each wrapper launches its kernel for a
CUDA tensor and takes the plain PyTorch version beside it only for a
tensor that lies on the CPU.
"""

from typing import Dict

from ..device import get_device

__all__ = ["launch_counts", "on_cuda"]


def on_cuda() -> bool:
    """Whether the selected device (:func:`repro_torch.get_device`) is a
    CUDA card — the choice between the dense kernel route and the
    sparse host route of the batched CG scan."""
    return get_device().type == "cuda"


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel name."""
    from .abft_matmul import kernel as mm_kernel
    from .checksum_verify import kernel as cv_kernel
    return {"abft_matmul": mm_kernel.launches,
            "tile_sums": cv_kernel.launches}

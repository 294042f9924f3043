"""Hand-written CUDA kernels: the paper's integrity math, the serving
prefill's attention and the SSD's scan across chunks.

  abft_matmul      matrix product with fused ABFT checksum epilogue
  checksum_verify  one-pass row/column sums for checksum verification
  flash_attention  blockwise causal GQA attention, forward only
  ssd_scan         the SSD's state passing across chunks, both directions

Each kernel lives in ``csrc/`` as CUDA C++ for ``sm_90a``; ``_build``
compiles it at its first launch. Each wrapper launches its kernel for a
CUDA tensor and takes the plain PyTorch version beside it only for a
tensor that lies on the CPU (``ssd_scan``: any tensor off the card, the
dry run's ``meta`` included).
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
    from .flash_attention import kernel as fa_kernel
    from .ssd_scan import kernel as ss_kernel
    return {"abft_matmul": mm_kernel.launches,
            "tile_sums": cv_kernel.launches,
            "flash_attention": fa_kernel.launches,
            "ssd_state_pass": ss_kernel.launches}

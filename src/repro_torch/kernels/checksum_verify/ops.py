"""Public wrappers: checksum verification via the tile-sums kernel.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version beside it; nothing else decides
the route. The kernel masks ragged edges and follows the input's
strides, so neither padding nor a contiguous copy is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import tile_sums_cuda, tile_sums_plain

__all__ = ["verify_checksums", "tile_sums", "tile_sums_batch"]


def tile_sums_batch(x: torch.Tensor, *,
                    acc_dtype: torch.dtype = torch.float32,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched row/col sums of a stack of matrices x (B, m, n).

    Returns (row_sums (B, m), col_sums (B, n)) accumulated in
    ``acc_dtype``. The batched sweep engine's ABFT chunk screen calls
    this over the examined chunk images of a whole sweep matrix, one
    launch per transfer group. The route follows the tensor: the kernel
    on the card, the plain version on the CPU. ``use_kernel`` only
    asserts which one the caller expects and raises when the tensor
    lies elsewhere."""
    if use_kernel is not None and bool(use_kernel) != x.is_cuda:
        raise ValueError(f"tile_sums_batch(use_kernel={use_kernel}) on a "
                         f"tensor that lies on {x.device}")
    if x.device.type == "cpu":
        return tile_sums_plain(x, acc_dtype=acc_dtype)
    rowp, colp = tile_sums_cuda(x, acc_dtype=acc_dtype)
    # cross-tile reduction of the kernel's partials: a fixed-order second
    # step, so the sums repeat from run to run
    return rowp.sum(dim=2), colp.sum(dim=1)


def tile_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row_sums (m,), col_sums (n,)) of x (m, n) in one pass over x,
    accumulated in float32 (float64 for float64 input)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    row, col = tile_sums_batch(x[None], acc_dtype=acc)
    return row[0], col[0]


def verify_checksums(cf: torch.Tensor, rtol: float = 1e-6,
                     atol: float = 1e-4):
    """Kernel-backed verdict for a full-checksum matrix cf (m+1, n+1).
    Returns (ok, row_resid (m,), col_resid (n,)) like ref.verify_ref."""
    row_sums, col_sums = tile_sums(cf[:-1, :-1])
    row_resid = cf[:-1, -1].to(row_sums.dtype) - row_sums
    col_resid = cf[-1, :-1].to(col_sums.dtype) - col_sums
    scale = torch.clamp(cf.abs().max().to(row_sums.dtype), min=1.0)
    tol = atol + rtol * scale
    ok = (row_resid.abs().max() <= tol) & (col_resid.abs().max() <= tol)
    return ok, row_resid, col_resid

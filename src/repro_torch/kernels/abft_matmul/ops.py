"""Public wrappers around the ABFT matmul kernel.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version beside it; nothing else decides
the route. The kernel masks ragged edges itself, so shapes need no
padding. ``abft_matmul_full`` assembles the paper's full-checksum matrix
C_f.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import abft_matmul_cuda, abft_matmul_plain

__all__ = ["abft_matmul", "abft_matmul_full", "gemm_batch"]


def _product_with_checksums(a: torch.Tensor, b: torch.Tensor,
                            acc_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return abft_matmul_plain(a, b, acc_dtype=acc_dtype)
    c, rowp, colp = abft_matmul_cuda(a, b, acc_dtype=acc_dtype)
    # cross-tile reduction of the kernel's partials: a fixed-order second
    # step, so the checksums repeat from run to run
    return c, rowp.sum(dim=1), colp.sum(dim=0)


def abft_matmul(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C = a @ b plus fused row/col checksums. Returns (C, row_cs,
    col_cs): C in a's dtype, the checksums in float32. The product is
    accumulated in float32 whatever the inputs' type, float64 included,
    as the reference's wrapper calls its kernel with the default
    accumulator; :func:`gemm_batch` is the entry that names another."""
    return _product_with_checksums(a, b, torch.float32)


def gemm_batch(a: torch.Tensor, b: torch.Tensor, *,
               acc_dtype: torch.dtype = torch.float64,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Row-stack GEMM ``a (B, k) @ b (k, n)`` accumulated in ``acc_dtype``.

    The batched sweep engine's CG invariant scan stacks every candidate
    overlay row of a wave into ``a`` and evaluates the residual matvecs
    as one launch of the fused-epilogue kernel (checksum partials
    computed and discarded — the epilogue is fused, not an extra pass).
    The route follows the tensors: the kernel on the card, the plain
    version on the CPU. ``use_kernel`` only asserts which one the caller
    expects and raises when the tensors lie elsewhere."""
    on_card = a.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(f"gemm_batch(use_kernel={use_kernel}) on a tensor "
                         f"that lies on {a.device}")
    c, _row, _col = _product_with_checksums(
        a.to(acc_dtype), b.to(acc_dtype), acc_dtype)
    return c


def abft_matmul_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's C_f = A_c @ B_r as an (m+1, n+1) full-checksum matrix,
    produced without materializing the encoded inputs."""
    c, row_cs, col_cs = abft_matmul(a, b)
    total = row_cs.sum()[None]
    top = torch.cat([c.to(row_cs.dtype), row_cs[:, None]], dim=1)
    bottom = torch.cat([col_cs, total])[None, :]
    return torch.cat([top, bottom], dim=0)

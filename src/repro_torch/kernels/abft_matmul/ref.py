"""Pure-PyTorch oracle for the ABFT matmul kernel."""

from __future__ import annotations

import torch

from .kernel import abft_matmul_plain

__all__ = ["abft_matmul_ref", "abft_encode_full_ref"]


def abft_matmul_ref(a: torch.Tensor, b: torch.Tensor):
    """Reference: (C, row_checksums (m,), col_checksums (n,)) in float32
    accumulation regardless of input dtype (the kernel's accumulation
    semantics for float32 and bfloat16 inputs)."""
    return abft_matmul_plain(a, b, acc_dtype=torch.float32)


def abft_encode_full_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-checksum product C_f = A_c @ B_r (paper Eq. 5), (m+1, n+1)."""
    c, row, col = abft_matmul_ref(a, b)
    top = torch.cat([c.to(torch.float32), row[:, None]], dim=1)
    bottom = torch.cat([col, row.sum()[None]])[None, :]
    return torch.cat([top, bottom], dim=0)

"""Pure-PyTorch oracle for checksum verification."""

from __future__ import annotations

import torch

__all__ = ["verify_ref"]


def verify_ref(cf: torch.Tensor, rtol: float = 1e-6, atol: float = 1e-4):
    """Residuals + verdict for a full-checksum matrix cf (m+1, n+1).

    Returns (ok: bool scalar, row_resid (m,), col_resid (n,)).
    """
    data = cf[:-1, :-1].to(torch.float32)
    row_resid = cf[:-1, -1].to(torch.float32) - data.sum(dim=1)
    col_resid = cf[-1, :-1].to(torch.float32) - data.sum(dim=0)
    scale = torch.clamp(cf.abs().max().to(torch.float32), min=1.0)
    tol = atol + rtol * scale
    ok = (row_resid.abs().max() <= tol) & (col_resid.abs().max() <= tol)
    return ok, row_resid, col_resid

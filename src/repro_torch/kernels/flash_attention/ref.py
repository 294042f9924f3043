"""Pure-PyTorch oracle for blockwise causal attention."""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  groups: int = 1, causal: bool = True) -> torch.Tensor:
    """q: (BH, S, hd); k/v: (BH//groups, S, hd)."""
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=0)
        v = torch.repeat_interleave(v, groups, dim=0)
    S = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) / (q.shape[-1] ** 0.5)
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        logits = torch.where(mask[None], logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs,
                        v.to(torch.float32)).to(q.dtype)

"""Public wrapper: (B, S, H, hd) GQA attention through the flash kernel.

Forward only (serving prefill). A CUDA tensor goes through the
hand-written kernel (``kernel.py``), a CPU tensor through the plain
version beside it; nothing else decides the route. The kernel reads the
(B, S, heads, hd) layout through its strides, handles GQA by indexing
and masks a ragged S itself, so there are no transposes, no KV repeat
and no padding here.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda, flash_attention_plain

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd), H % KV == 0. Returns
    (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)

"""Public wrapper: the SSD's state passing across chunks, with gradients.

A CUDA tensor goes through the hand-written kernel pair (``kernel.py``)
behind an autograd function; any other tensor (the CPU's, the dry run's
``meta``) through the plain loop beside it, which autograd
differentiates as it always did. Nothing else decides the route.

On the card each launch adds one to the counter ``ssd.state_pass.kernel``
and a loop call one to ``ssd.state_pass.loop`` (``repro_torch.tracing``),
so a collected trace shows which route ran. The forward's launch runs
inside the span ``ssd.state_pass``; the backward's runs on autograd's
device thread, where a profiler names it by its node,
``_StatePassBackward``.
"""

from __future__ import annotations

import torch

from ... import tracing
from .kernel import (row_view, state_pass_bwd_cuda, state_pass_fwd_cuda,
                     state_pass_plain)

__all__ = ["state_pass"]


class _StatePass(torch.autograd.Function):
    """``a (B, nc, H)`` decays and ``S_c (B, nc, H, hd, N)`` contributions
    -> the states entering the chunks. Saves ``a`` and the output; the
    decays' gradient is the kernel's per-warp partials added in one fixed
    order (no atomics: the step's replay stays bitwise)."""

    @staticmethod
    def forward(ctx, a, S_c):
        with tracing.span("ssd.state_pass"):
            out = state_pass_fwd_cuda(a, row_view(S_c)).view(S_c.shape)
        tracing.count("ssd.state_pass.kernel", 1)
        ctx.save_for_backward(a, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, out = ctx.saved_tensors
        ds, dap = state_pass_bwd_cuda(a, row_view(out), row_view(g))
        tracing.count("ssd.state_pass.kernel", 1)
        return dap.sum(dim=-1), ds.view(out.shape)


def state_pass(la_tot: torch.Tensor, S_c: torch.Tensor) -> torch.Tensor:
    """The states entering each chunk, (B, nc, H, hd, N) float32:
    ``state_0 = 0``, ``state_{c+1} = state_c * exp(la_tot[:, c]) +
    S_c[:, c]``. ``la_tot (B, nc, H)`` is each chunk's summed log decay,
    ``S_c (B, nc, H, hd, N)`` its contribution to the state, both float32
    on one device. Raises on another type or shapes that do not match."""
    if la_tot.dtype != torch.float32 or S_c.dtype != torch.float32:
        raise TypeError(f"state_pass takes float32, got la_tot {la_tot.dtype}"
                        f" and S_c {S_c.dtype}")
    if S_c.dim() != 5 or tuple(la_tot.shape) != tuple(S_c.shape[:3]):
        raise ValueError(f"state_pass: la_tot {tuple(la_tot.shape)} must be "
                         f"S_c {tuple(S_c.shape)}'s (B, nc, H) of "
                         f"(B, nc, H, hd, N)")
    if la_tot.device != S_c.device:
        raise ValueError(f"state_pass: la_tot on {la_tot.device}, S_c on "
                         f"{S_c.device}")
    if not S_c.is_cuda:
        tracing.count("ssd.state_pass.loop", 1)
        return state_pass_plain(la_tot, S_c)
    return _StatePass.apply(torch.exp(la_tot), S_c)

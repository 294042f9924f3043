"""Mixture-of-Experts FFN: the router and the dense expert path.

The JAX package's ``models/moe.py`` on one card:

* :func:`router_topk` — float32 logits, softmax, the top ``K`` experts of
  each token, their probabilities renormalised to sum to one.
* :func:`moe_apply_dense` — every expert on every token (the reference's
  branch without a mesh), each token's output the combine-weighted sum
  of its ``K`` experts' outputs. O(T·E·F) work; the expert products stay
  ``torch.einsum``, as the reference leaves them to XLA outside any
  Pallas kernel.

Two choices keep the port's routing equal to the reference's:

* ``jax.lax.top_k`` returns the lower index first among equal values and
  ``torch.topk`` promises no order, so the top ``K`` are the first ``K``
  of a *stable* descending sort.
* The reference builds the (T, E) combine matrix by a scatter-add
  (``.at[...].add``). A token's ``K`` ids are distinct, so the sum over
  ``K`` of one-hot rows times their weights puts each weight at its
  expert with nothing added to it: the same matrix, exactly, with no
  scatter, and deterministic on the card (the trainer runs under
  ``torch.use_deterministic_algorithms``).

The expert-parallel path (``moe_apply_ep``: token all-to-all and grouped
products under a mesh) comes with ROADMAP A10b.7.

Two runs of a model in bf16 that round at other points (two packages,
flash and plain attention, decode and prefill) reach a router with
inputs an ulp apart, and a token whose K-th and (K+1)-th probabilities
are that close takes another expert in each. :func:`same_routing` and
:func:`check_flip_share` hold such runs to one rule: every token whose
margin exceeds ``ROUTING_MARGIN`` is routed alike, and the tokens that
flip stay under ``ROUTING_FLIP_SHARE`` of the decisions.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["MoE", "router_topk", "moe_apply_dense", "moe_apply_ep",
           "ROUTING_MARGIN", "ROUTING_FLIP_SHARE", "routing_margin",
           "same_routing", "check_flip_share"]

F32 = torch.float32
ROUTING_MARGIN = 1e-2
ROUTING_FLIP_SHARE = 0.05


class MoE(nn.Module):
    """router (D, E) float32, always; expert stacks w_gate / w_up (E, D, F)
    and w_down (E, F, D) in ``cfg.param_dtype``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        dt = L.dtype_of(cfg.param_dtype)
        self.router = L.empty_weight((D, E), F32, device)
        self.w_gate = L.empty_weight((E, D, F), dt, device)
        self.w_up = L.empty_weight((E, D, F), dt, device)
        self.w_down = L.empty_weight((E, F, D), dt, device)

    def init_(self, generator: torch.Generator) -> None:
        # sqrt(2 / (in + out)) of each expert's own (in, out), as the
        # reference's expert_stack draws them
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            L.dense_init_(w, generator)


def router_topk(cfg: ModelConfig, router_w: torch.Tensor,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, K) float32 renormalised, ids (T, K) int64) for tokens
    x (T, D). Ties go to the lower expert id, as in ``jax.lax.top_k``."""
    K = cfg.experts_per_token
    logits = x.to(F32) @ router_w.to(F32)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :K]
    # the selected probabilities by a one-hot product (exact: one nonzero
    # term), differentiable without a scatter in the backward pass
    onehot = nn.functional.one_hot(ids, cfg.n_experts).to(F32)   # (T, K, E)
    weights = (onehot * probs[:, None, :]).sum(dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights, ids


def moe_apply_dense(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (T, D) -> (T, D) in x's type. Computes every expert on every
    token; the (T, E, D) expert outputs are combined in float32."""
    dt = x.dtype
    weights, ids = router_topk(cfg, p.router, x)                 # (T, K)
    onehot = nn.functional.one_hot(ids, cfg.n_experts).to(F32)
    combine = (onehot * weights[..., None]).sum(dim=1)            # (T, E)
    gate = nn.functional.silu(torch.einsum("td,edf->tef", x,
                                           p.w_gate.to(dt)))
    up = torch.einsum("td,edf->tef", x, p.w_up.to(dt))
    y = torch.einsum("tef,efd->ted", gate * up, p.w_down.to(dt))
    return torch.einsum("ted,te->td", y.to(F32), combine).to(dt)


def moe_apply_ep(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh, **kwargs):
    raise NotImplementedError(
        "moe_apply_ep: the expert-parallel path (token all-to-all, grouped "
        "expert products on a mesh) comes with ROADMAP A10b.7's sharding "
        "slice; without a mesh the port runs moe_apply_dense")


# ---------------------------------------------------------------------------
# routing compared across two runs
# ---------------------------------------------------------------------------

def routing_margin(cfg: ModelConfig, probs: torch.Tensor) -> torch.Tensor:
    """Per token of probs (T, E), its K-th minus its (K+1)-th probability."""
    K = cfg.experts_per_token
    ranked = torch.sort(probs, dim=-1, descending=True).values
    return ranked[:, K - 1] - ranked[:, K]


def same_routing(cfg: ModelConfig, ids: torch.Tensor, probs: torch.Tensor,
                 other_ids: torch.Tensor,
                 margin: float = ROUTING_MARGIN) -> torch.Tensor:
    """Per token (T,), whether ids and other_ids (T, K) name the same set
    of experts. Raises AssertionError where a token whose margin in probs
    (T, E), the probabilities behind ids, exceeds ``margin`` does not."""
    same = (torch.sort(ids, dim=-1).values
            == torch.sort(other_ids, dim=-1).values).all(dim=-1)
    above = routing_margin(cfg, probs.to(F32)).to(same.device) > margin
    if bool((~same & above).any()):
        raise AssertionError(f"routing differs on a token whose margin "
                             f"exceeds {margin}")
    return same


def check_flip_share(sames) -> int:
    """The tokens that flipped over a run's routing decisions (a sequence
    of :func:`same_routing` results): their count, which must stay under
    ``ROUTING_FLIP_SHARE`` of the decisions."""
    same = torch.cat([s.reshape(-1) for s in sames])
    flips = int((~same).sum())
    if flips >= ROUTING_FLIP_SHARE * same.numel():
        raise AssertionError(f"routing flipped on {flips} of {same.numel()} "
                             f"decisions, over {ROUTING_FLIP_SHARE}")
    return flips

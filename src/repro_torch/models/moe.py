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

* :func:`moe_apply_ep` — the reference's expert-parallel path on its
  one-device mesh, which is where the reference's trainer runs its MoE
  layers: each expert computes a window of equal capacity over the
  expert-sorted assignments, and an expert's assignments beyond its
  window are dropped (their outputs are zero). On one card the token
  all-to-alls are the identity. Meshes of several cards come with
  ROADMAP A10b.7.

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
           "EP_COUNTS", "ROUTING_MARGIN", "ROUTING_FLIP_SHARE",
           "routing_margin", "same_routing", "check_flip_share"]

F32 = torch.float32
ROUTING_MARGIN = 1e-2
ROUTING_FLIP_SHARE = 0.05
# assignments that reached moe_apply_ep, and those its expert windows
# dropped, since the counts were last set to 0
EP_COUNTS = {"assignments": 0, "dropped": 0}


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


def _local_expert_ffn(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                      wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                      block_factor: float = 2.0) -> torch.Tensor:
    """Equal-capacity grouped SwiGLU over rows sorted by expert (the
    reference's ``_local_expert_ffn``). Expert ``e`` computes a window of
    ``cap`` rows starting at its group's offset, rows past its group's
    size masked to zero; the reference writes the windows in expert
    order, so that a later expert's rows overwrite an earlier window's
    zero tail, and a group's rows beyond ``cap`` stay zero (dropped). The
    rows are padded by ``cap`` so that no window is cut short.

    Here the windows are one gather (E, cap, D) and three batched
    products, and the writes in expert order are one gather too: row r
    takes its value from the last window that covers it, the window of
    the last expert whose offset is at most r. No value leaves the card
    and the backward pass is deterministic."""
    R, D = x_sorted.shape
    E = wg.shape[0]
    dt = x_sorted.dtype
    cap = int(-(-R * block_factor // E))
    cap = max(8, ((cap + 7) // 8) * 8)
    dev = x_sorted.device
    offsets = torch.cumsum(group_sizes, 0) - group_sizes     # (E,)
    win = torch.arange(cap, device=dev)
    x_pad = nn.functional.pad(x_sorted, (0, 0, 0, cap))
    blk = x_pad[offsets[:, None] + win]                      # (E, cap, D)
    h = nn.functional.silu(torch.bmm(blk, wg.to(dt))) \
        * torch.bmm(blk, wu.to(dt))
    keep = (win[None, :] < group_sizes[:, None])[..., None]
    out = torch.where(keep, torch.bmm(h, wd.to(dt)), 0.0).to(dt)
    rows = torch.arange(R, device=dev)
    last = torch.searchsorted(offsets, rows, right=True) - 1  # (R,)
    within = rows - offsets[last]
    covered = (within < cap)[:, None]
    y = out.reshape(E * cap, D)[last * cap + within.clamp(max=cap - 1)]
    # the same operations in a forward pass and in its recomputation under
    # remat, whatever the counts hold (a read to the host, not a tensor
    # that accumulates)
    EP_COUNTS["dropped"] += int(torch.clamp(group_sizes - cap, min=0).sum())
    return torch.where(covered, y, 0.0).to(dt)


def moe_apply_ep(cfg: ModelConfig, p: MoE, x: torch.Tensor,
                 mesh) -> torch.Tensor:
    """x: (T, D) -> (T, D) in x's type: the reference's ``moe_apply_ep``
    on a mesh of one card (its ``_ep_shard_fn`` at ``ep = 1``). Raises
    for a mesh of several cards (ROADMAP A10b.7).

    The ``T * K`` assignments, in token-major order, fill a send buffer
    of ``capacity`` rows (``ceil(T * K * capacity_factor)``; rows left
    over belong to the "trash group" ``E``, which is never computed).
    The rows are sorted by expert id (stably, as ``jnp.argsort``),
    computed by :func:`_local_expert_ffn`, put back in order and combined
    in float32 over each token's ``K`` assignments with its router
    weights. The permutation and its inverse are gathers, so the
    backward pass is deterministic on the card."""
    from ..launch.mesh import one_card
    if one_card(mesh) is None:
        raise ValueError("moe_apply_ep needs a mesh; without one the "
                         "reference runs moe_apply_dense")
    T, D = x.shape
    K, E = cfg.experts_per_token, cfg.n_experts
    capacity = max(1, int(-(-T * K * cfg.capacity_factor // 1)))
    weights, ids = router_topk(cfg, p.router, x)                 # (T, K)
    n = T * K
    # one destination: an assignment's rank in its bucket is its place in
    # token-major order, and the all-to-alls there and back are identities
    rank = torch.arange(n, device=x.device)
    keep = rank < capacity
    slot = torch.where(keep, rank, 0)
    kept = min(capacity, n)
    tok = x[:, None, :].expand(T, K, D).reshape(n, D)            # repeat K
    send = torch.cat([tok[:kept], x.new_zeros((capacity - kept, D))])
    send_lid = torch.cat([ids.reshape(-1)[:kept],
                          ids.new_full((capacity - kept,), E)])
    order = torch.argsort(send_lid, stable=True)
    inv = torch.argsort(order, stable=True)
    gs = torch.bincount(send_lid, minlength=E + 1)[:E]
    EP_COUNTS["assignments"] += n
    EP_COUNTS["dropped"] += n - kept
    y = _local_expert_ffn(send[order], gs, p.w_gate, p.w_up, p.w_down)[inv]
    y_assign = y[slot] * keep[:, None].to(y.dtype)
    y_tok = (y_assign.to(F32).reshape(T, K, D)
             * weights.reshape(T, K, 1)).sum(dim=1)
    return y_tok.to(x.dtype)


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

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

* :func:`moe_apply_ep` — the reference's expert-parallel path: tokens
  sharded over every mesh axis, experts over "model", each rank running
  :func:`ep_body` (top-K routing, a capacity-bucketed all-to-all to the
  experts' owners, an equal-capacity grouped SwiGLU over the rank's
  experts, the all-to-all back and a float32 combine). On a mesh of one
  card, where the reference's trainer runs its MoE layers, the
  all-to-alls are identities; across the ranks of a ``DeviceMesh`` they
  are ``all_to_all_single`` on the "model" group, whose backward is the
  reverse exchange, and each rank holds only its ``E / ep`` experts'
  stacks (the reference's ``P(ep_axis, None, None)``).

Two runs of a model in bf16 that round at other points (two packages,
flash and plain attention, decode and prefill) reach a router with
inputs an ulp apart, and a token whose K-th and (K+1)-th probabilities
are that close takes another expert in each. :func:`same_routing` and
:func:`check_flip_share` hold such runs to one rule: every token whose
margin exceeds ``ROUTING_MARGIN`` is routed alike, and the tokens that
flip stay under ``ROUTING_FLIP_SHARE`` of the decisions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["MoE", "router_topk", "moe_apply_dense", "moe_apply_ep",
           "ep_body", "ep_capacity", "local_experts",
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

    AXES = {"router": ("embed", "experts_r"),
            "w_gate": ("experts", "embed", "mlp_e"),
            "w_up": ("experts", "embed", "mlp_e"),
            "w_down": ("experts", "mlp_e", "embed")}
    # the router routes this rank's block of the tokens only
    TP_PARTIAL = ("router",)

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


def _local_expert_ffn_ragged(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                             wg: torch.Tensor, wu: torch.Tensor,
                             wd: torch.Tensor) -> torch.Tensor:
    """The reference's grouped SwiGLU by ``jax.lax.ragged_dot``: group
    ``e``'s rows (consecutive, ``group_sizes[e]`` of them) times expert
    ``e``'s weights, nothing dropped; rows past the groups are zero. No
    arch takes it (the reference keeps it as an option for backends with
    native ragged products); one product per expert here."""
    dt = x_sorted.dtype
    out = torch.zeros_like(x_sorted)
    sizes = [int(g) for g in group_sizes]
    off = 0
    for e, g in enumerate(sizes):
        xe = x_sorted[off:off + g]
        h = nn.functional.silu(xe @ wg[e].to(dt)) * (xe @ wu[e].to(dt))
        out[off:off + g] = h @ wd[e].to(dt)
        off += g
    return out


def ep_capacity(cfg: ModelConfig, t_loc: int, ep: int) -> int:
    """Rows each destination takes from one rank: ``ceil(T_loc * K *
    capacity_factor / ep)``, computed as the reference does."""
    return max(1, int(-(-t_loc * cfg.experts_per_token
                        * cfg.capacity_factor // ep)))


def ep_body(cfg: ModelConfig, p: MoE, x: torch.Tensor, idx: int, ep: int,
            capacity: int, exchange) -> torch.Tensor:
    """One rank's share of the expert-parallel MoE (the reference's
    ``_ep_shard_fn``): x (T, D), the rank's tokens -> (T, D) in x's type.
    ``idx`` is the rank's index on the expert axis, whose ``ep`` ranks
    hold ``E / ep`` experts each: ``p`` holds the router and this rank's
    expert stacks, (E / ep, D, F) from expert ``idx * E_loc`` on;
    ``exchange(t)`` is the all-to-all of that axis, sending the i-th of
    ``ep`` equal row blocks of ``t`` to rank i and returning the blocks
    received, in rank order.

    The ``T * K`` assignments, in token-major order, go to the rank that
    owns their expert; each destination takes the first ``capacity`` of
    them and drops the rest (their outputs are zero). Rows left empty
    carry the local expert id ``E_loc``, the "trash group", which sorts
    after every expert and is never computed. The reference fills its
    send buffer by one scatter in which a dropped assignment writes a
    zero row and ``E_loc`` at its bucket's first slot, after the kept
    ones; its CPU backend applies the writes in order, so a bucket that
    overflows also loses its first assignment, and so does the port's.
    The owner sorts what it received by local expert (stably), computes
    it by :func:`_local_expert_ffn`, sends it back in place, and each
    token combines its ``K`` outputs in float32 with its router weights.
    The permutations are gathers, so a backward pass is deterministic on
    the card."""
    T, D = x.shape
    K = cfg.experts_per_token
    E_loc = cfg.n_experts // ep
    weights, ids = router_topk(cfg, p.router, x)                 # (T, K)
    n = T * K
    fids = ids.reshape(-1)
    dest, lid = fids // E_loc, fids % E_loc
    if ep == 1:
        # one destination: an assignment's rank is its place in order
        rank = torch.arange(n, device=x.device)
    else:
        onehot = nn.functional.one_hot(dest, ep)
        rank = (torch.cumsum(onehot, 0) - 1).gather(1, dest[:, None])[:, 0]
    keep = rank < capacity
    slot = dest * capacity + torch.where(keep, rank, 0)
    tok = x[:, None, :].expand(T, K, D).reshape(n, D)            # repeat K
    kept_slots = slot[keep]
    send = x.new_zeros((ep * capacity, D))
    send[kept_slots] = tok[keep]
    send_lid = ids.new_full((ep * capacity,), E_loc)
    send_lid[kept_slots] = lid[keep]
    n_kept = int(keep.sum())
    if n_kept < n:
        overflow = torch.unique(dest[~keep]) * capacity
        send[overflow] = 0.0
        send_lid[overflow] = E_loc
    EP_COUNTS["assignments"] += n
    EP_COUNTS["dropped"] += n - n_kept
    recv, rlid = exchange(send), exchange(send_lid)
    order = torch.argsort(rlid, stable=True)
    inv = torch.argsort(order, stable=True)
    gs = torch.bincount(rlid, minlength=E_loc + 1)[:E_loc]
    y = _local_expert_ffn(recv[order], gs, p.w_gate, p.w_up,
                          p.w_down)[inv]
    back = exchange(y)
    y_assign = back[slot] * keep[:, None].to(back.dtype)
    y_tok = (y_assign.to(F32).reshape(T, K, D)
             * weights.reshape(T, K, 1)).sum(dim=1)
    return y_tok.to(x.dtype)


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks over a group; its backward is
    the reverse exchange, which for equal blocks is the same one."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Exchange.apply(grad, ctx.group), None


def _all_to_all(group):
    """The all-to-all of one process group as an ``exchange`` for
    :func:`ep_body` (differentiable)."""
    return lambda t: _Exchange.apply(t, group)


def local_experts(cfg: ModelConfig, p: MoE, mesh):
    """The router and this rank's (E / ep, ...) expert stacks of ``p`` on
    a DeviceMesh, ``sharding.partition.tp_local`` of each (a layer under
    ``layers.tp_weights`` holds them already)."""
    if p.w_gate.shape[0] != cfg.n_experts:
        return p
    from types import SimpleNamespace

    from ..sharding.partition import tp_local
    return SimpleNamespace(**{
        k: tp_local(getattr(p, k), MoE.AXES[k], mesh,
                    partial=k in MoE.TP_PARTIAL) for k in MoE.AXES})



def moe_apply_ep(cfg: ModelConfig, p: MoE, x, mesh, *,
                 ep_axis: str = "model", capacity: Optional[int] = None):
    """The reference's ``moe_apply_ep``: tokens sharded over every axis of
    ``mesh``, experts over ``ep_axis``, each rank running :func:`ep_body`.

    On a mesh of one card (``launch.mesh.single_device_mesh()``) x is
    (T, D) and so is the result, and the all-to-alls are identities. On
    a ``DeviceMesh`` x is a DTensor (N, D) of every token, placed as the
    caller's rows are; the N tokens are padded to a multiple of the mesh
    size, rank ``r`` (in row-major order of the mesh) takes the r-th
    block of them, the all-to-alls run over the ``ep_axis`` group
    (``all_to_all_single``), and the result is a DTensor placed as x.
    Where ``ep_axis`` has one rank, x may instead be this rank's own
    block of the tokens, a plain (T, D) tensor, and so is the result: its
    body runs on that tensor as on one card, gradients summed alike.
    ``capacity`` overrides :func:`ep_capacity`, as the reference's
    does."""
    from ..launch.mesh import check_mesh, is_ranked, mesh_shape
    if check_mesh(mesh) is None:
        raise ValueError("moe_apply_ep needs a mesh; without one the "
                         "reference runs moe_apply_dense")
    if not is_ranked(mesh):
        return ep_body(cfg, p, x, 0, 1,
                       capacity or ep_capacity(cfg, x.shape[0], 1),
                       lambda t: t)
    from torch.distributed.tensor import DTensor, Shard

    from ..sharding.partition import place
    shape = mesh_shape(mesh)
    ep = shape[ep_axis]
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{ep} ranks of {ep_axis!r}")
    if not isinstance(x, DTensor):
        if ep != 1:
            raise ValueError(f"a plain tensor is one rank's own tokens, "
                             f"for {ep_axis!r} of one rank, not {ep}")
        return ep_body(cfg, local_experts(cfg, p, mesh), x, 0, 1,
                       capacity or ep_capacity(cfg, x.shape[0], 1),
                       _all_to_all(mesh.get_group(ep_axis)))
    n_total = mesh.size()
    N, D = x.shape
    pad = (-N) % n_total
    t_loc = (N + pad) // n_total
    by_all = (Shard(0),) * mesh.ndim
    if pad:
        flat = 0
        for a, c in zip(shape, mesh.get_coordinate()):
            flat = flat * shape[a] + c
        xg = nn.functional.pad(x.full_tensor(), (0, 0, 0, pad))
        x_loc = xg[flat * t_loc:(flat + 1) * t_loc]
    else:
        x_loc = x.redistribute(mesh, by_all).to_local()
    y_loc = ep_body(cfg, local_experts(cfg, p, mesh), x_loc,
                    mesh.get_local_rank(ep_axis), ep,
                    capacity or ep_capacity(cfg, t_loc, ep),
                    _all_to_all(mesh.get_group(ep_axis)))
    y = DTensor.from_local(y_loc, mesh, by_all, run_check=False,
                           shape=(N + pad, D), stride=(D, 1))
    if pad:
        return place(y.full_tensor()[:N], mesh, x.placements)
    return y.redistribute(mesh, x.placements)


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

"""Transformer layers of the LM: RMSNorm, RoPE and M-RoPE, GQA attention
with its flash prefill branch and KV-cache decode branch, SwiGLU.

Conventions, as in the JAX package's ``models/layers.py``:

* Weights keep the ``(in, out)`` layout of ``x @ w`` (not ``nn.Linear``'s
  ``(out, in)``), so the reference's parameters carry over untransposed.
* Weights are stored in ``cfg.param_dtype`` (float32) and cast to the
  activations' type, ``cfg.compute_dtype`` (bfloat16), per matmul.
  Attention logits and softmax run in float32; RMSNorm statistics and
  RoPE angles too.
* Attention rotates q and k by M-RoPE where ``cfg.mrope_sections`` (the
  vlm family), not at all for the audio family (its frontend embeds
  positions), and by RoPE otherwise.
* Sharding follows the reference's. ``mesh`` is ``None``, a mesh of one
  card (``launch.mesh.single_device_mesh``) or a ``DeviceMesh``
  (``launch.mesh.make_mesh``). Across the ranks of a ``DeviceMesh`` each
  rank runs its block of the batch rows (:func:`batch_rows`, split over
  the data axes) through every layer, and a layer is tensor parallel
  over the "model" axis, Megatron's way: under :func:`tp_weights` each
  weight is the rank's part of it (``sharding.partition.tp_local``: a
  DTensor weight gathered over the data axes, the reference's
  ``gather_weights``, and never read whole), the input of the split
  products passes :func:`tp_enter` and the row-parallel output
  :func:`tp_reduce`. Attention splits by query heads (the flash branch
  launches the kernel on the rank's heads, :func:`flash_tp_body`), the
  SwiGLU by its hidden columns.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["RMSNorm", "rmsnorm", "rope_freqs", "apply_rope", "apply_mrope",
           "ranked", "shard_act", "gather_weights", "tp_weights",
           "tp_body", "tp_enter", "tp_reduce", "tp_gather", "dp_reduce",
           "batch_rows", "rows_of", "rows_split", "gather_rows", "rows_like",
           "heads_tile", "kv_heads", "flash_sdpa", "flash_tp_body",
           "flash_applicable", "Attention", "attention_apply",
           "attention_body",
           "attention_cache_init", "SwiGLU", "swiglu_apply", "dtype_of",
           "empty_weight", "dense_init_"]

NEG_INF = -1e30

# logical dim names of the embedding table and the output head; each
# module class names its own weights' dims in ``AXES`` (attribute ->
# names), which ``models.carry.param_axes`` reads
TABLE_AXES = {"embed": ("vocab", "embed"), "head": ("embed", "vocab")}


def dtype_of(name: str) -> torch.dtype:
    """``cfg.param_dtype`` / ``cfg.compute_dtype`` name -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


# --------------------------------------------------------------------------
# sharding across the ranks of a DeviceMesh (the launch package imports
# the models, so launch.mesh and sharding are imported when called)
# --------------------------------------------------------------------------

def ranked(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (``launch.mesh.check_mesh``
    raises for what is no mesh)."""
    from ..launch.mesh import check_mesh, is_ranked
    return is_ranked(check_mesh(mesh))


def _dp_axes(mesh) -> Tuple[str, ...]:
    from ..launch.mesh import mesh_shape
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _row_placements(mesh, n: int) -> Tuple:
    """Placements of a batch of ``n`` rows: split over the data axes where
    the DP degree divides ``n`` (the reference's constraint), replicated
    otherwise."""
    from ..launch.mesh import mesh_shape
    from ..sharding.partition import placements
    dp = _dp_axes(mesh)
    shape = mesh_shape(mesh)
    if not dp or n % math.prod(shape[a] for a in dp):
        return placements(mesh, ())
    return placements(mesh, (dp,))


def shard_act(x, mesh, *, seq_axis: Optional[int] = 1):
    """Pin a (B, S, ...) activation's batch dim to the DP mesh axes: a
    DTensor is redistributed to rows split over ("pod", "data") and
    replicated over the other axes; a plain tensor, or a batch the DP
    degree does not divide, is left as it is (the reference's
    constraint, which changes no value). ``seq_axis`` is accepted, as in
    the reference, and unused."""
    if mesh is None or not isinstance(x, DTensor):
        return x
    where = _row_placements(mesh, x.shape[0])
    if all(isinstance(p, Replicate) for p in where):
        return x
    return x.redistribute(mesh, where)


def gather_weights(lp, axes, mesh):
    """ZeRO-3 weight gather at the layer boundary: every DTensor leaf of
    ``lp`` (a tensor or nested dicts of them, ``axes`` the same tree of
    logical dim names) is redistributed to its TP-only placement: the
    dim ``sharding.partition.tp_dim`` names stays sharded over "model",
    every other dim (the FSDP "embed" dim among them) is gathered.
    Plain tensors are left as they are, as the reference leaves every
    leaf without a mesh."""
    if mesh is None:
        return lp
    if isinstance(lp, dict):
        return {k: gather_weights(v, axes[k], mesh) for k, v in lp.items()}
    if not isinstance(lp, DTensor):
        return lp
    from ..launch.mesh import mesh_shape
    from ..sharding.partition import placements, tp_dim
    shape = mesh_shape(mesh)
    ax = axes[1:] if axes and axes[0] == "layers" else axes
    if len(ax) != lp.ndim or "model" not in shape:
        return lp
    d = tp_dim(tuple(lp.shape), ax, shape["model"])
    return lp.redistribute(mesh, placements(mesh, tuple(
        "model" if i == d else None for i in range(lp.ndim))))


@contextlib.contextmanager
def tp_weights(module: nn.Module, mesh,
               skip: Tuple[str, ...] = ()) -> Iterator[None]:
    """While the enclosed code runs across the ranks of a DeviceMesh, each
    parameter of ``module`` (but those under the children named in
    ``skip``) is the part of it this rank's tensor-parallel layer works
    on, ``sharding.partition.tp_local`` by the dim names its module class
    gives in ``AXES``: split over "model" where the class splits at that
    degree (its ``splits(tp)``, if it has one), with ``Partial`` gradients
    over "model" for the weights it names in ``TP_PARTIAL``. A DTensor
    weight is gathered over the other axes; nothing is read whole. The
    module holds its own parameters again afterwards. Without a
    DeviceMesh nothing changes."""
    if not ranked(mesh):
        yield
        return
    from ..sharding.partition import tp_local
    tp, _ = _tp(mesh)
    swapped = []
    for name, w in module.named_parameters():
        if name.split(".")[0] in skip:
            continue
        mod, _, attr = name.rpartition(".")
        owner = module.get_submodule(mod)
        split = owner.splits(tp) if hasattr(owner, "splits") else True
        owner._parameters[attr] = tp_local(
            w, type(owner).AXES[attr], mesh, split=split,
            partial=split and attr in getattr(owner, "TP_PARTIAL", ()))
        swapped.append((owner, attr, w))
    try:
        yield
    finally:
        for owner, attr, w in swapped:
            owner._parameters[attr] = w


def tp_body(module: nn.Module, mesh, fn):
    """``h -> fn(module, h)`` with ``module``'s weights under
    :func:`tp_weights`, inside the function, so that a recomputation
    under ``torch.utils.checkpoint`` reads them the same way."""
    def body(h):
        with tp_weights(module, mesh):
            return fn(module, h)
    return body


# --------------------------------------------------------------------------
# the conjugate pair of a tensor-parallel block over "model": f at its
# input (identity, the gradient summed over the ranks), g at its output
# (the partial outputs summed, the gradient passed on); and the logits'
# gather over the vocab split
# --------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, idx, n):
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.lo, ctx.width = idx * x.shape[-1], x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.lo + ctx.width].contiguous(), None, \
            None, None


def _model_group(mesh):
    tp, _ = _tp(mesh)
    return mesh.get_group("model") if tp > 1 else None


def tp_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """f: the input of a column-parallel product (identity; its gradient
    is summed over "model")."""
    group = _model_group(mesh)
    return x if group is None else _Enter.apply(x, group)


def tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """g: the output of a row-parallel product, summed over "model" (its
    gradient passed on as it is)."""
    group = _model_group(mesh)
    return x if group is None else _Reduce.apply(x, group)


def tp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last dim of a column-parallel output gathered over "model" in
    rank order; the gradient of each rank's columns goes back to it."""
    tp, idx = _tp(mesh)
    return x if tp == 1 else _Gather.apply(x, mesh.get_group("model"),
                                           idx, tp)


def dp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the data axes of a DeviceMesh (g over each), its
    gradient passed on: the global numerator or count of a loss whose
    rows are split over those axes."""
    from ..launch.mesh import mesh_shape
    if not ranked(mesh):
        return x
    for a in _dp_axes(mesh):
        if mesh_shape(mesh)[a] > 1:
            x = _Reduce.apply(x, mesh.get_group(a))
    return x


def batch_rows(n: int, mesh) -> slice:
    """The rows of a batch of ``n`` that this rank runs: its block of the
    split over the data axes (the rows :func:`shard_act` places on it),
    all of them without a DeviceMesh or where the DP degree does not
    divide ``n``."""
    if not ranked(mesh):
        return slice(None)
    lo, m = 0, n
    for d, p in enumerate(_row_placements(mesh, n)):
        if isinstance(p, Shard):
            m //= mesh.size(d)
            lo = lo * mesh.size(d) + mesh.get_coordinate()[d]
    return slice(lo * m, (lo + 1) * m)


def rows_of(local: torch.Tensor, mesh, n: int) -> DTensor:
    """This rank's rows ``local`` (:func:`batch_rows`) of a batch of ``n``
    as a DTensor placed as the batch's rows are."""
    shape = (n,) + tuple(local.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh,
                              _row_placements(mesh, n), run_check=False,
                              shape=shape, stride=stride)


def rows_split(rows: DTensor) -> bool:
    """Whether every axis of more than one rank but "model" splits the
    batch ``rows`` (:func:`rows_of`): each rank's rows are then its block
    of the tokens when they are split over every axis."""
    mesh = rows.device_mesh
    return all(isinstance(p, Shard) or mesh.size(i) == 1
               for i, p in enumerate(rows.placements)
               if mesh.mesh_dim_names[i] != "model")


def gather_rows(local: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The whole (n, ...) batch on every rank from each rank's rows."""
    return rows_of(local, mesh, n).full_tensor()


def rows_like(local: torch.Tensor, ref: DTensor,
              n: Optional[int] = None) -> DTensor:
    """The rank's rows ``local`` of a global tensor of ``n`` rows (default
    ``ref``'s) placed as ``ref``'s rows are; the trailing dims may differ
    from ``ref``'s."""
    shape = (n or ref.shape[0],) + tuple(local.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), ref.device_mesh,
                              ref.placements, run_check=False,
                              shape=shape, stride=stride)


def empty_weight(shape: Tuple[int, ...], dtype: torch.dtype,
                 device) -> nn.Parameter:
    """A weight without values (serving: no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Normal weights at the reference's scale sqrt(2 / (in + out))."""
    fan_in, fan_out = w.shape[-2], w.shape[-1]
    with torch.no_grad():
        w.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, generator=generator)
    return w


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Statistics in float32, normalised value cast back to x's type, then
    times gamma in that type."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


class RMSNorm(nn.Module):
    AXES = {"gamma": ("embed",)}

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = empty_weight((dim,), dtype, device)
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.gamma, self.eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even head dims, in float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Angles,
    cos, sin and the rotation in float32 (split halves, not interleaved);
    the result in x's type."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x: (B, S, H, hd); positions3: (3, B, S),
    the temporal, height and width position streams. ``sections``
    partitions the hd/2 frequency slots among the three streams in order
    ((16, 24, 24) at hd 128): slot i turns by the stream it falls in.
    Angles, cos, sin and the rotation in float32, as :func:`apply_rope`;
    with three equal streams it is :func:`apply_rope`."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, device=x.device)
    stream = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (hd/2,)
    pos = positions3.to(torch.float32)[stream]                  # (hd/2, B, S)
    angles = pos.movedim(0, -1) * freqs                         # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# flash (blockwise) attention — forward-only prefill path
# --------------------------------------------------------------------------

def _tp(mesh) -> Tuple[int, int]:
    """(TP degree, this rank's index on the "model" axis) of a mesh; of a
    layout (``launch.mesh.Mesh``) its degree and index 0."""
    from ..launch.mesh import is_ranked, mesh_shape
    if mesh is None:
        return 1, 0
    tp = mesh_shape(mesh).get("model", 1)
    return tp, (mesh.get_local_rank("model") if is_ranked(mesh) and tp > 1
                else 0)


def heads_tile(q_heads: int, kv_heads: int, tp: int) -> bool:
    """Whether ``q_heads`` query heads split evenly over ``tp`` ranks with
    each rank's heads spanning whole KV groups, or lying within one
    (``H_loc % G == 0`` or ``G % H_loc == 0``, ``G = H / KV``): the
    reference's condition for its tensor-parallel flash branch, and the
    port's for splitting GQA attention by heads."""
    if q_heads % tp:
        return False
    H_loc = q_heads // tp
    G = q_heads // max(kv_heads, 1)
    return (H_loc % G == 0) or (G % H_loc == 0)


def kv_heads(q_heads: int, kv: int, tp: int, rank: int) -> Tuple[int, int]:
    """(first, count) of the KV heads that rank ``rank``'s ``q_heads /
    tp`` query heads read. GQA orders heads contiguously (query head
    ``h`` reads KV head ``h // G``, ``G = H / KV``), so they are the
    ``max(1, ceil(H_loc / G))`` heads from ``rank * H_loc // G``."""
    H_loc = q_heads // tp
    G = q_heads // kv
    return rank * H_loc // G, max(1, -(-H_loc // G))


def flash_tp_body(q_local: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rank: int, tp: int, *, causal: bool = True) -> torch.Tensor:
    """One rank's flash attention under tensor parallelism: q_local (B, S,
    H / tp, hd) holds query heads ``rank * H_loc`` on; k, v (B, S, KV, hd)
    hold every KV head. The kernel is launched on the rank's heads and
    the KV heads they read (:func:`kv_heads`)."""
    kv0, n_kv = kv_heads(q_local.shape[2] * tp, k.shape[2], tp, rank)
    return flash_attention(q_local, k[:, :, kv0:kv0 + n_kv],
                           v[:, :, kv0:kv0 + n_kv], causal=causal)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
               *, causal: bool = True) -> torch.Tensor:
    """Blockwise attention for prefill through the flash kernel (no S^2
    traffic to device memory). Forward only: the kernel has no backward.

    k/v (B, S, KV, hd): every KV head of the rank's batch rows. Without a
    "model" axis of more than one rank, q (B, S, H, hd) holds every query
    head and this is one launch. Across the ``tp`` ranks of that axis q
    holds this rank's ``H / tp`` heads, projected by its share of the
    query weights, and the rank launches :func:`flash_tp_body` on them;
    the result is its heads' output."""
    tp, idx = _tp(mesh)
    if tp == 1:
        return flash_attention(q, k, v, causal=causal)
    return flash_tp_body(q, k, v, idx, tp, causal=causal)


def flash_applicable(cfg: ModelConfig, q_heads: int, seq: int,
                     mesh=None) -> bool:
    """Whether the reference takes the flash branch: ``seq % 8 == 0``,
    and under tensor parallelism (``tp`` ranks on "model") the query
    heads split by :func:`heads_tile`."""
    tp, _ = _tp(mesh)
    return seq % 8 == 0 and heads_tile(q_heads, cfg.n_kv_heads, tp)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          kv_len: Optional[int] = None) -> torch.Tensor:
    """Grouped dot-product attention, the plain branch of the reference.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd). Logits and softmax in
    float32 (bf16 products are exact in float32), probabilities cast to
    q's type, the product with v accumulated in float32 and cast back.
    Prefill/train repeats the KV heads up to H; decode (``kv_len`` given)
    groups the query heads instead and never repeats the cache.
    ``kv_len``: valid prefix of k/v. (The reference's ``q_pos0`` offset
    has no caller and is left out.)
    """
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    f32 = torch.float32
    grouped = kv_len is not None and KV != H
    if grouped:
        qg = q.reshape(B, Sq, KV, H // KV, hd)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(f32),
                              k.to(f32)) / (hd ** 0.5)
    else:
        if KV != H:
            k = torch.repeat_interleave(k, H // KV, dim=2)
            v = torch.repeat_interleave(v, H // KV, dim=2)
        logits = torch.einsum("bqhd,bshd->bhqs", q.to(f32),
                              k.to(f32)) / (hd ** 0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        logits.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    if kv_len is not None:
        logits[..., kv_len:] = NEG_INF
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    if grouped:
        out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(f32), v.to(f32))
    else:
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(f32), v.to(f32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class Attention(nn.Module):
    """GQA attention weights: wq (D, H*hd), wk/wv (D, KV*hd), wo (H*hd, D).
    Under tensor parallelism over ``tp`` ranks whose heads tile
    (:func:`heads_tile`) ``wq`` is split by its columns and ``wo`` by its
    rows; ``wk`` / ``wv`` stay whole, each rank reading its KV heads."""

    AXES = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
            "wv": ("embed", "kvheads"), "wo": ("qheads", "embed")}
    TP_PARTIAL = ("wk", "wv")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        self.n_heads, self.n_kv_heads = H, KV
        dt = dtype_of(cfg.param_dtype)
        self.wq = empty_weight((D, H * hd), dt, device)
        self.wk = empty_weight((D, KV * hd), dt, device)
        self.wv = empty_weight((D, KV * hd), dt, device)
        self.wo = empty_weight((H * hd, D), dt, device)

    def splits(self, tp: int) -> bool:
        return heads_tile(self.n_heads, self.n_kv_heads, tp)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    mrope_positions: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_index: Optional[int] = None,
                    mesh=None, flash: bool = False):
    """Full attention. q and k turn by M-RoPE over ``mrope_positions``
    (3, B, S) where ``cfg.mrope_sections``, not at all for the audio
    family, by RoPE over ``positions`` (B, S) otherwise. With ``cache``
    (dict k/v (B, Smax, KV, hd)) performs one decode step: x is (B, S, D)
    with S new tokens, ``cache_index`` the write position. The cache is
    updated in place (the reference returns an updated copy) and
    returned. With ``flash`` the prefill takes the flash kernel where the
    reference would. Returns (out, cache).

    Under :func:`tp_weights` on a DeviceMesh whose "model" axis splits the
    heads, ``p`` holds this rank's columns of ``wq`` and rows of ``wo``:
    the rank runs :func:`attention_body` on its heads between
    :func:`tp_enter` and :func:`tp_reduce`, which sums the ranks'
    outputs."""
    H, S = cfg.n_heads, x.shape[1]
    split = p.wq.shape[-1] // cfg.resolved_head_dim != H
    tp, idx = _tp(mesh) if split else (1, 0)
    take_flash = (flash and cache is None and cfg.causal
                  and flash_applicable(cfg, H, S, mesh))
    out, cache = attention_body(
        cfg, p, tp_enter(x, mesh) if split else x, positions, rank=idx,
        tp=tp, mrope_positions=mrope_positions, cache=cache,
        cache_index=cache_index, flash=take_flash)
    return (tp_reduce(out, mesh) if split else out), cache


def attention_body(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                   positions: Optional[torch.Tensor], *, rank: int = 0,
                   tp: int = 1, mrope_positions: Optional[torch.Tensor] = None,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Optional[int] = None, flash: bool = False):
    """One rank's attention under tensor parallelism over ``tp`` ranks
    (the whole layer at ``tp`` 1): ``p.wq`` holds the columns of query
    heads ``rank * H / tp`` on and ``p.wo`` their rows; ``wk`` / ``wv``
    are whole, so every KV head is projected (and cached) and the rank's
    heads attend over the KV heads they read (:func:`kv_heads`), through
    the flash kernel (:func:`flash_tp_body`) where ``flash``. Returns
    (the rank's share of the output, which the ranks sum; cache)."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    H_loc = p.wq.shape[-1] // hd
    kv0, n_kv = kv_heads(H, KV, tp, rank)
    q = (x @ p.wq.to(x.dtype)).reshape(B, S, H_loc, hd)
    k = (x @ p.wk.to(x.dtype)).reshape(B, S, KV, hd)
    v = (x @ p.wv.to(x.dtype)).reshape(B, S, KV, hd)
    if cfg.mrope_sections:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    elif cfg.family != "audio":   # hubert's frontend embeds positions
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        i = int(cache_index)
        cache["k"][:, i:i + S] = k.to(cache["k"].dtype)
        cache["v"][:, i:i + S] = v.to(cache["v"].dtype)
        out = _sdpa(q, cache["k"][:, :, kv0:kv0 + n_kv],
                    cache["v"][:, :, kv0:kv0 + n_kv], causal=False,
                    kv_len=i + S)
    elif flash:
        out = flash_tp_body(q, k, v, rank, tp, causal=True)
    else:
        out = _sdpa(q, k[:, :, kv0:kv0 + n_kv], v[:, :, kv0:kv0 + n_kv],
                    causal=cfg.causal)
    return out.reshape(B, S, H_loc * hd) @ p.wo.to(x.dtype), cache


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         device=None):
    """(cache, axes) for one attention layer: zeros k/v (B, max_len, KV, hd)
    in the compute type."""
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    ax = ("batch", "seq_cache", "kvheads_sep", "head_dim")
    return cache, {"k": ax, "v": ax}


# --------------------------------------------------------------------------
# SwiGLU FFN
# --------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """w_gate/w_up (D, F), w_down (F, D); under tensor parallelism the
    first two split by columns, ``w_down`` by rows."""

    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None,
                 device=None):
        super().__init__()
        D, F = cfg.d_model, d_ff or cfg.d_ff
        self.d_ff = F
        dt = dtype_of(cfg.param_dtype)
        self.w_gate = empty_weight((D, F), dt, device)
        self.w_up = empty_weight((D, F), dt, device)
        self.w_down = empty_weight((F, D), dt, device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)


def swiglu_apply(p: SwiGLU, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The FFN on x (..., D); with ``p`` split over "model" (under
    :func:`tp_weights`) each rank computes its columns of the hidden
    layer and the ranks' outputs are summed."""
    dt = x.dtype
    split = p.w_gate.shape[-1] != p.d_ff
    if split:
        x = tp_enter(x, mesh)
    gate = nn.functional.silu(x @ p.w_gate.to(dt))
    up = x @ p.w_up.to(dt)
    out = (gate * up) @ p.w_down.to(dt)
    return tp_reduce(out, mesh) if split else out

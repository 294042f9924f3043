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
  launches the kernel on the rank's heads, :func:`flash_tp_body`); where
  the TP degree does not tile them, by blocks of ``H / gcd(H, tp)``
  heads that ``tp / gcd(H, tp)`` ranks share, as XLA splits the
  reference's (:func:`head_blocks`). The SwiGLU splits by its hidden
  columns.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["RMSNorm", "rmsnorm", "rope_freqs", "apply_rope", "apply_mrope",
           "ranked", "shard_act", "gather_weights", "tp_weights",
           "tp_body", "tp_enter", "tp_reduce", "vocab_blocks",
           "dp_reduce", "batch_rows", "rows_of", "rows_split", "rows_like",
           "local_as", "local_rows", "seq_split",
           "heads_tile", "kv_heads", "head_blocks", "block_kv",
           "gather_block",
           "flash_sdpa", "flash_tp_body",
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
def tp_weights(module: nn.Module, mesh, skip: Tuple[str, ...] = (), *,
               decode: bool = False) -> Iterator[None]:
    """While the enclosed code runs across the ranks of a DeviceMesh, each
    parameter of ``module`` (but those under the children named in
    ``skip``) is the part of it this rank's tensor-parallel layer works
    on, ``sharding.partition.tp_local`` by the dim names its module class
    gives in ``AXES``: split over "model" where the class splits at that
    degree (its ``splits(tp)``, if it has one; :class:`Attention`'s in the
    decode step where ``decode``), with ``Partial`` gradients over "model"
    for the weights it names in ``TP_PARTIAL``. A DTensor weight is
    gathered over the other axes; nothing is read whole. The module holds
    its own parameters again afterwards. Without a DeviceMesh nothing
    changes."""
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
        if isinstance(owner, Attention):
            split = owner.splits(tp, decode=decode)
        else:
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
# re-blocking over the vocab split
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


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist
        ctx.group, ctx.n = group, n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        parts = [c.contiguous() for c in grad.chunk(ctx.n, dim=-1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


def _block_group(mesh, m: int):
    """The process group of the ``m`` ranks on "model" (this rank among
    them, in their order there) that share this rank's block of query
    heads; made once per mesh by those ranks alone."""
    import torch.distributed as dist
    d = mesh.mesh_dim_names.index("model")
    coord = mesh.get_coordinate()
    line = mesh.mesh[tuple(coord[:d]) + (slice(None),) + tuple(coord[d + 1:])]
    b = coord[d] // m
    ranks = line[b * m:(b + 1) * m].tolist()
    if ranks != sorted(ranks):
        raise NotImplementedError(f"a block of query heads on ranks {ranks} "
                                  f"out of their order")
    groups = mesh.__dict__.setdefault("_head_block_groups", {})
    if m not in groups:
        groups[m] = dist.new_group(ranks, use_local_synchronization=True)
    return groups[m]


def gather_block(w: torch.Tensor, mesh, m: int) -> torch.Tensor:
    """This rank's columns ``w`` of a weight split over "model" gathered
    with those of the other ranks of its head block (:func:`head_blocks`,
    ``m`` ranks a block): the block's columns, in rank order. The
    gradient of each rank's columns is summed over the block's ranks."""
    return w if m == 1 else _GatherCols.apply(w, _block_group(mesh, m), m)


def vocab_blocks(x: torch.Tensor, vocab: int, mesh) -> torch.Tensor:
    """A column-parallel output over "model" (each rank's block of the
    padded vocabulary's columns, ``x``) in the reference's layout of the
    logits sliced to ``vocab``: where the TP degree divides ``vocab``,
    its even split, ``vocab / tp`` columns a rank in rank order (each
    rank sends the columns of its block that fall in another's by one
    all-to-all; without a padding nothing moves); otherwise the whole
    ``vocab`` on every rank (all-gathered, then sliced). No gradient
    passes (the serving output)."""
    import torch.distributed as dist
    tp, idx = _tp(mesh)
    group = mesh.get_group("model")
    p = x.shape[-1]
    if vocab % tp:
        parts = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)[..., :vocab]
    c = vocab // tp
    if p == c:
        return x

    def cut(s: int, r: int) -> int:
        # columns of rank s's padded block that rank r's even block holds
        return max(0, min(s * p + p, r * c + c) - max(s * p, r * c))

    send = [cut(idx, r) for r in range(tp)]
    recv = [cut(s, idx) for s in range(tp)]
    cols = x.movedim(-1, 0)[:sum(send)].contiguous()
    out = cols.new_empty((c,) + tuple(cols.shape[1:]))
    dist.all_to_all_single(out, cols, recv, send, group=group)
    return out.movedim(0, -1)


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


def local_as(local: torch.Tensor, mesh, where: Tuple,
             shape: Tuple[int, ...]) -> DTensor:
    """The rank's ``local`` part of a global tensor of ``shape`` placed as
    ``where`` says, as a DTensor (no check, nothing moves)."""
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh, where,
                              run_check=False, shape=tuple(shape),
                              stride=stride)


def rows_of(local: torch.Tensor, mesh, n: int) -> DTensor:
    """This rank's rows ``local`` (:func:`batch_rows`) of a batch of ``n``
    as a DTensor placed as the batch's rows are."""
    return local_as(local, mesh, _row_placements(mesh, n),
                    (n,) + tuple(local.shape[1:]))


def rows_split(rows: DTensor) -> bool:
    """Whether every axis of more than one rank but "model" splits the
    batch ``rows`` (:func:`rows_of`): each rank's rows are then its block
    of the tokens when they are split over every axis."""
    mesh = rows.device_mesh
    return all(isinstance(p, Shard) or mesh.size(i) == 1
               for i, p in enumerate(rows.placements)
               if mesh.mesh_dim_names[i] != "model")


def rows_like(local: torch.Tensor, ref: DTensor,
              n: Optional[int] = None) -> DTensor:
    """The rank's rows ``local`` of a global tensor of ``n`` rows (default
    ``ref``'s) placed as ``ref``'s rows are; the trailing dims may differ
    from ``ref``'s."""
    return local_as(local, ref.device_mesh, ref.placements,
                    (n or ref.shape[0],) + tuple(local.shape[1:]))


def local_rows(x: torch.Tensor, rows: slice, dim: int = 0) -> torch.Tensor:
    """This rank's rows (on ``dim``) of a batch or cache leaf. A DTensor
    placed by the partition rules (``sharding.partition.batch_shardings``,
    ``cache_shardings``: the batch dim split over the data axes as
    :func:`batch_rows` splits it) holds them as its local tensor, and
    any other dim it splits stays split; a plain tensor that every rank
    holds whole gives its ``rows``."""
    if not isinstance(x, DTensor):
        return x[(slice(None),) * dim + (rows,)]
    local = x.to_local()
    n = len(range(*rows.indices(x.shape[dim])))
    if local.shape[dim] != n:
        raise ValueError(f"a leaf placed as {x.placements} holds "
                         f"{local.shape[dim]} rows on dim {dim}; this rank "
                         f"runs {n}")
    return local


def seq_split(x: torch.Tensor, dim: int) -> Optional[Tuple[int, object]]:
    """(first position, process group) of a cache leaf ``x`` whose
    sequence dim ``dim`` a DTensor splits over one mesh axis (the
    partition rules' ``shard_cache_seq``: each rank holds its chunk of the
    positions, ``torch.chunk``'s); None for a leaf that holds them all."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    axes = [d for d, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(d) > 1]
    if not axes:
        return None
    if len(axes) > 1:
        raise NotImplementedError(f"a cache sequence split over {len(axes)} "
                                  f"mesh axes")
    d = axes[0]
    chunk = -(-x.shape[dim] // mesh.size(d))
    return mesh.get_coordinate()[d] * chunk, mesh.get_group(d)


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
    port's for each rank's heads being its own (:func:`head_blocks`) and
    for splitting them in the decode step."""
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


def head_blocks(q_heads: int, tp: int) -> Tuple[int, int]:
    """(blocks, ranks a block) of ``q_heads`` query heads over the ``tp``
    ranks of "model": ``g = gcd(H, tp)`` blocks of ``H / g`` consecutive
    heads, each computed whole by the ``tp / g`` consecutive ranks that
    hold its columns of ``wq`` (the split XLA gives the reference's
    attention, whose ``wq`` columns are placed over "model" whatever the
    heads). Where the heads tile (:func:`heads_tile`) each rank is a
    block of its own."""
    g = math.gcd(q_heads, tp)
    return g, tp // g


def block_kv(k: torch.Tensor, q_heads: int, blocks: int,
             b: int) -> torch.Tensor:
    """The KV heads (dim 2 of ``k``, all of them) that the query heads of
    block ``b`` of ``blocks`` read: their contiguous run
    (:func:`kv_heads`) where the block tiles KV groups or lies within one
    (``_sdpa`` repeats them to the block's heads), and otherwise the KV
    head of each query head (query head ``h`` reads ``h // G``), one per
    query head."""
    KV = k.shape[2]
    if heads_tile(q_heads, KV, blocks):
        kv0, n_kv = kv_heads(q_heads, KV, blocks, b)
        return k[:, :, kv0:kv0 + n_kv]
    h_blk = q_heads // blocks
    idx = torch.arange(b * h_blk, (b + 1) * h_blk,
                       device=k.device) // (q_heads // KV)
    return k.index_select(2, idx)


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

def _split_softmax(logits: torch.Tensor, group) -> torch.Tensor:
    """Softmax over a last dim whose entries are split over the ranks of
    ``group``: the maximum and the sum of the exponentials are reduced
    over the group (no gradient: decode only)."""
    import torch.distributed as dist
    m = logits.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(logits - m)
    total = e.sum(dim=-1, keepdim=True)
    dist.all_reduce(total, group=group)
    return e / total


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          kv_len: Optional[int] = None, group=None) -> torch.Tensor:
    """Grouped dot-product attention, the plain branch of the reference.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd). Logits and softmax in
    float32 (bf16 products are exact in float32), probabilities cast to
    q's type, the product with v accumulated in float32 and cast back.
    Prefill/train repeats the KV heads up to H; decode (``kv_len`` given)
    groups the query heads instead and never repeats the cache.
    ``kv_len``: valid prefix of k/v. (The reference's ``q_pos0`` offset
    has no caller and is left out.) ``group``: decode over a cache whose
    positions are split over the ranks of this process group (k/v hold
    the rank's chunk): the softmax and the product with v are summed
    over the group.
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
        logits[..., max(kv_len, 0):] = NEG_INF
    probs = (torch.softmax(logits, dim=-1) if group is None
             else _split_softmax(logits, group)).to(q.dtype)
    del logits
    if grouped:
        out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(f32), v.to(f32))
    else:
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(f32), v.to(f32))
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(out, group=group)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class Attention(nn.Module):
    """GQA attention weights: wq (D, H*hd), wk/wv (D, KV*hd), wo (H*hd, D).
    Under tensor parallelism over ``tp`` ranks ``wq`` is split by its
    columns and ``wo`` by its rows, ``H*hd / tp`` a rank, as the reference
    places them (:meth:`splits`); ``wk`` / ``wv`` stay whole, each rank
    reading the KV heads its query heads read."""

    AXES = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
            "wv": ("embed", "kvheads"), "wo": ("qheads", "embed")}
    TP_PARTIAL = ("wk", "wv")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        self.n_heads, self.n_kv_heads, self.head_dim = H, KV, hd
        dt = dtype_of(cfg.param_dtype)
        self.wq = empty_weight((D, H * hd), dt, device)
        self.wk = empty_weight((D, KV * hd), dt, device)
        self.wv = empty_weight((D, KV * hd), dt, device)
        self.wo = empty_weight((H * hd, D), dt, device)

    def splits(self, tp: int, decode: bool = False) -> bool:
        """Whether ``wq`` / ``wo`` split over ``tp`` ranks: where the heads
        tile (:func:`heads_tile`), by each rank's heads; otherwise, but in
        the decode step (which keeps the heads whole, as the reference's
        ``replicate_attn_heads`` does), in even chunks of ``H*hd`` that
        need not hold whole heads, each rank computing its block's heads
        (:func:`head_blocks`)."""
        if heads_tile(self.n_heads, self.n_kv_heads, tp):
            return True
        return not decode and (self.n_heads * self.head_dim) % tp == 0

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    mrope_positions: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_index: Optional[int] = None,
                    mesh=None, flash: bool = False,
                    cache_seq: Optional[Tuple[int, object]] = None):
    """Full attention. q and k turn by M-RoPE over ``mrope_positions``
    (3, B, S) where ``cfg.mrope_sections``, not at all for the audio
    family, by RoPE over ``positions`` (B, S) otherwise. With ``cache``
    (dict k/v (B, Smax, KV, hd)) performs one decode step: x is (B, S, D)
    with S new tokens, ``cache_index`` the write position. The cache is
    updated in place (the reference returns an updated copy) and
    returned. With ``flash`` the prefill takes the flash kernel where the
    reference would. ``cache_seq`` is :func:`seq_split` of a cache that
    holds this rank's chunk of the positions. Returns (out, cache).

    Under :func:`tp_weights` on a DeviceMesh whose "model" axis splits
    ``wq`` and ``wo``, ``p`` holds this rank's columns of ``wq`` and rows
    of ``wo``: the rank gathers its head block's columns of ``wq`` from
    the ranks that share the block (:func:`gather_block`; none where the
    heads tile) and runs :func:`attention_body` on the block between
    :func:`tp_enter` and :func:`tp_reduce`, which sums the ranks'
    outputs."""
    H, S = cfg.n_heads, x.shape[1]
    split = p.wq.shape[-1] != H * cfg.resolved_head_dim
    tp, idx = _tp(mesh) if split else (1, 0)
    take_flash = (flash and cache is None and cfg.causal
                  and flash_applicable(cfg, H, S, mesh))
    if split:
        x = tp_enter(x, mesh)
        m = head_blocks(H, tp)[1]
        if m > 1:
            p = SimpleNamespace(wq=gather_block(p.wq, mesh, m), wk=p.wk,
                                wv=p.wv, wo=p.wo)
    out, cache = attention_body(
        cfg, p, x, positions, rank=idx, tp=tp,
        mrope_positions=mrope_positions, cache=cache,
        cache_index=cache_index, flash=take_flash, cache_seq=cache_seq)
    return (tp_reduce(out, mesh) if split else out), cache


def attention_body(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                   positions: Optional[torch.Tensor], *, rank: int = 0,
                   tp: int = 1, mrope_positions: Optional[torch.Tensor] = None,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Optional[int] = None, flash: bool = False,
                   cache_seq: Optional[Tuple[int, object]] = None):
    """One rank's attention under tensor parallelism over ``tp`` ranks
    (the whole layer at ``tp`` 1). The rank's head block (of ``g``
    blocks, ``m = tp / g`` ranks a block: :func:`head_blocks`) is query
    heads ``(rank // m) * H / g`` on: ``p.wq`` holds their columns,
    ``p.wo`` the rank's ``H*hd / tp`` rows, its share of the block's
    output (all of it where ``m`` is 1). ``wk`` / ``wv`` are whole, so every KV
    head is projected and the block attends over the KV heads it reads
    (:func:`block_kv`), through the flash kernel (:func:`flash_tp_body`)
    where ``flash`` (the heads then tile). A decode cache holds every KV
    head, or only the rank's (a cache split by heads over "model"), and
    every position, or the chunk from ``cache_seq[0]`` on (the softmax
    then reduced over ``cache_seq[1]``). Returns (the rank's share of the
    output, which the ranks sum; cache)."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    H_loc = p.wq.shape[-1] // hd
    g = H // H_loc
    m = tp // g
    blk = rank // m
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
        kv0, n_kv = kv_heads(H, KV, tp, rank)
        i = int(cache_index)
        heads = slice(kv0, kv0 + n_kv)
        if cache["k"].shape[2] != KV:
            # the cache holds this rank's KV heads only
            k, v, heads = k[:, :, heads], v[:, :, heads], slice(None)
        lo, group = cache_seq if cache_seq is not None else (0, None)
        a, b = max(i, lo), min(i + S, lo + cache["k"].shape[1])
        if a < b:
            cache["k"][:, a - lo:b - lo] = k[:, a - i:b - i].to(
                cache["k"].dtype)
            cache["v"][:, a - lo:b - lo] = v[:, a - i:b - i].to(
                cache["v"].dtype)
        out = _sdpa(q, cache["k"][:, :, heads], cache["v"][:, :, heads],
                    causal=False, kv_len=i + S - lo, group=group)
    elif flash:
        out = flash_tp_body(q, k, v, rank, tp, causal=True)
    else:
        out = _sdpa(q, block_kv(k, H, g, blk), block_kv(v, H, g, blk),
                    causal=cfg.causal)
    out = out.reshape(B, S, H_loc * hd)
    if m > 1:
        c = p.wo.shape[0]
        out = out[..., (rank % m) * c:(rank % m + 1) * c]
    return out @ p.wo.to(x.dtype), cache


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

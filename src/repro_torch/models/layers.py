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
  (``launch.mesh.make_mesh``). Across the ranks of a ``DeviceMesh`` the
  residual stream is a DTensor whose batch rows are split over the data
  axes; :func:`shard_act` pins it there at every layer boundary and
  :func:`gathered_weights` gathers a layer's DTensor weights
  (:func:`gather_weights`) while the layer runs on the rank's rows.
  :func:`flash_sdpa` splits the query heads over the "model" axis, each
  rank launching the flash kernel on its heads (:func:`flash_tp_body`).
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
           "ranked", "no_ranks", "shard_act", "gather_weights",
           "gathered_weights", "rows_across_ranks", "residual",
           "local_rows", "rows_like", "flash_sdpa", "flash_tp_body",
           "flash_applicable", "Attention", "attention_apply",
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


def no_ranks(mesh) -> None:
    """Raise for a ``DeviceMesh``: training across ranks comes with
    ROADMAP A10b.7b."""
    if ranked(mesh):
        raise NotImplementedError(
            "training across the ranks of a DeviceMesh comes with ROADMAP "
            "A10b.7b; serve across them with forward / decode_step")


def _dp_axes(mesh) -> Tuple[str, ...]:
    from ..launch.mesh import mesh_shape
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def shard_act(x, mesh, *, seq_axis: Optional[int] = 1):
    """Pin a (B, S, ...) activation's batch dim to the DP mesh axes: a
    DTensor is redistributed to rows split over ("pod", "data") and
    replicated over the other axes; a plain tensor, or a batch the DP
    degree does not divide, is left as it is (the reference's
    constraint, which changes no value). ``seq_axis`` is accepted, as in
    the reference, and unused."""
    if mesh is None or not isinstance(x, DTensor):
        return x
    from ..launch.mesh import mesh_shape
    from ..sharding.partition import placements
    dp = _dp_axes(mesh)
    shape = mesh_shape(mesh)
    if not dp or x.shape[0] % math.prod(shape[a] for a in dp):
        return x
    return x.redistribute(mesh, placements(mesh, (dp,)))


# logical dims that stay TP-sharded when a layer's weights are gathered
# (first matching dim wins: expert weights keep EP on the experts dim)
_TP_NAMES = ("experts", "qheads", "mlp", "vocab", "ssm_inner")


def gather_weights(lp, axes, mesh):
    """ZeRO-3 weight gather at the layer boundary: every DTensor leaf of
    ``lp`` (a tensor or nested dicts of them, ``axes`` the same tree of
    logical dim names) is redistributed to its TP-only placement: the
    first dim named in ``_TP_NAMES`` that the "model" axis divides stays
    sharded over it, every other dim (the FSDP "embed" dim among them)
    is gathered. A stacked leaf's leading "layers" name is dropped.
    Plain tensors are left as they are, as the reference leaves every
    leaf without a mesh."""
    if mesh is None:
        return lp
    if isinstance(lp, dict):
        return {k: gather_weights(v, axes[k], mesh) for k, v in lp.items()}
    if not isinstance(lp, DTensor):
        return lp
    from ..launch.mesh import mesh_shape
    from ..sharding.partition import placements
    shape = mesh_shape(mesh)
    ax = axes[1:] if axes and axes[0] == "layers" else axes
    if len(ax) != lp.ndim or "model" not in shape:
        return lp
    entries, used = [], False
    for i, a in enumerate(ax):
        take = (not used and a in _TP_NAMES
                and lp.shape[i] % shape["model"] == 0)
        entries.append("model" if take else None)
        used = used or take
    return lp.redistribute(mesh, placements(mesh, tuple(entries)))


@contextlib.contextmanager
def gathered_weights(module: nn.Module, mesh,
                     skip: Tuple[str, ...] = ()) -> Iterator[None]:
    """While the enclosed code runs, each DTensor parameter of ``module``
    (but those under the children named in ``skip``) is gathered by
    :func:`gather_weights`, by the dim names its module class gives in
    ``AXES``, and then read whole: the module holds the full tensor, and
    its DTensor again afterwards. Plain parameters are left alone."""
    swapped = []
    for name, w in module.named_parameters():
        if not isinstance(w, DTensor) or name.split(".")[0] in skip:
            continue
        mod, _, attr = name.rpartition(".")
        owner = module.get_submodule(mod)
        full = gather_weights(w, type(owner).AXES[attr], mesh).full_tensor()
        owner._parameters[attr] = full
        swapped.append((owner, attr, w))
    try:
        yield
    finally:
        for owner, attr, w in swapped:
            owner._parameters[attr] = w


def rows_across_ranks(module: nn.Module, mesh, embed, layers, step,
                      head) -> torch.Tensor:
    """A forward across the ranks of ``mesh`` in which every layer is
    independent per batch row: ``embed()`` (B, S, D), whole on every
    rank, becomes the residual DTensor (:func:`residual`), each layer of
    ``layers`` runs ``step(layer, rows)`` on the rank's rows with its
    weights gathered (:func:`gathered_weights`), and ``head(rows)`` gives
    the rank's logits; the whole logits come back on every rank.
    ``module``'s other DTensor weights are gathered for the whole call."""
    with gathered_weights(module, mesh, skip=("layers",)):
        h = residual(embed(), mesh)
        for lp in layers:
            h = shard_act(h, mesh)
            with gathered_weights(lp, mesh):
                h = shard_act(rows_like(step(lp, h.to_local()), h), mesh)
        return rows_like(head(h.to_local()), h).full_tensor()


def residual(x: torch.Tensor, mesh) -> DTensor:
    """A (B, ...) tensor that every rank holds whole as the residual
    stream's DTensor: its rows split over the data axes where the DP
    degree divides B (:func:`shard_act`), replicated otherwise."""
    return shard_act(DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                        run_check=False), mesh)


def local_rows(x: DTensor) -> slice:
    """The global rows (dim 0) of ``x`` that this rank holds."""
    mesh = x.device_mesh
    lo, n = 0, x.shape[0]
    for d, (p, c) in enumerate(zip(x.placements, mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == 0:
            step = -(-n // mesh.size(d))
            lo, n = lo + c * step, max(0, min(step, n - c * step))
    return slice(lo, lo + n)


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


def flash_tp_body(q_local: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rank: int, tp: int, *, causal: bool = True) -> torch.Tensor:
    """One rank's flash attention under tensor parallelism: q_local (B, S,
    H / tp, hd) holds query heads ``rank * H_loc`` on; k, v (B, S, KV, hd)
    hold every KV head. GQA orders heads contiguously (query head ``h``
    reads KV head ``h // G``, ``G = H / KV``), so the rank's heads read the
    ``n_kv_loc = max(1, ceil(H_loc / G))`` KV heads from ``kv0 = rank *
    H_loc // G``, and the kernel is launched on those."""
    H_loc = q_local.shape[2]
    G = H_loc * tp // k.shape[2]
    n_kv_loc = max(1, -(-H_loc // G))
    kv0 = rank * H_loc // G
    return flash_attention(q_local, k[:, :, kv0:kv0 + n_kv_loc],
                           v[:, :, kv0:kv0 + n_kv_loc], causal=causal)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
               *, causal: bool = True) -> torch.Tensor:
    """Blockwise attention for prefill through the flash kernel (no S^2
    traffic to device memory). Forward only: the kernel has no backward.

    q (B, S, H, hd), k/v (B, S, KV, hd): the rank's batch rows. Without a
    "model" axis of more than one rank this is one launch. Across the
    ``tp`` ranks of that axis each rank launches :func:`flash_tp_body` on
    its ``H / tp`` query heads and the heads are gathered from the
    ranks (``all_gather`` over the axis' group) in order."""
    tp, idx = _tp(mesh)
    if tp == 1:
        return flash_attention(q, k, v, causal=causal)
    ranked(mesh)      # a layout of several ranks has no group: raises
    import torch.distributed as dist
    H_loc = q.shape[2] // tp
    out = flash_tp_body(q[:, :, idx * H_loc:(idx + 1) * H_loc], k, v, idx,
                        tp, causal=causal).contiguous()
    parts = [torch.empty_like(out) for _ in range(tp)]
    dist.all_gather(parts, out, group=mesh.get_group("model"))
    return torch.cat(parts, dim=2)


def flash_applicable(cfg: ModelConfig, q_heads: int, seq: int,
                     mesh=None) -> bool:
    """Whether the reference takes the flash branch: ``seq % 8 == 0``,
    and under tensor parallelism (``tp`` ranks on "model") the query
    heads split evenly and each rank's heads span whole KV groups, or
    lie within one (``H_loc % G == 0`` or ``G % H_loc == 0``)."""
    tp, _ = _tp(mesh)
    if q_heads % tp != 0 or seq % 8 != 0:
        return False
    H_loc = q_heads // tp
    G = q_heads // max(cfg.n_kv_heads, 1)
    return (H_loc % G == 0) or (G % H_loc == 0)


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
    """GQA attention weights: wq (D, H*hd), wk/wv (D, KV*hd), wo (H*hd, D)."""

    AXES = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
            "wv": ("embed", "kvheads"), "wo": ("qheads", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg.param_dtype)
        self.wq = empty_weight((D, H * hd), dt, device)
        self.wk = empty_weight((D, KV * hd), dt, device)
        self.wv = empty_weight((D, KV * hd), dt, device)
        self.wo = empty_weight((H * hd, D), dt, device)

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
    returned. Returns (out, cache)."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq.to(x.dtype)).reshape(B, S, H, hd)
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
        out = _sdpa(q, cache["k"], cache["v"], causal=False, kv_len=i + S)
    elif flash and cfg.causal and flash_applicable(cfg, H, S, mesh):
        out = flash_sdpa(q, k, v, mesh, causal=True)
    else:
        out = _sdpa(q, k, v, causal=cfg.causal)
    out = out.reshape(B, S, H * hd)
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
    """w_gate/w_up (D, F), w_down (F, D)."""

    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None,
                 device=None):
        super().__init__()
        D, F = cfg.d_model, d_ff or cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        self.w_gate = empty_weight((D, F), dt, device)
        self.w_up = empty_weight((D, F), dt, device)
        self.w_down = empty_weight((F, D), dt, device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = nn.functional.silu(x @ p.w_gate.to(dt))
    up = x @ p.w_up.to(dt)
    return (gate * up) @ p.w_down.to(dt)

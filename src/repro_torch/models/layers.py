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
* Sharding (``shard_act``, ``gather_weights``, the mesh branch of
  ``flash_sdpa``) is not part of the port yet: a ``mesh`` other than
  ``None`` or one card (``launch.mesh.single_device_mesh``) raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["RMSNorm", "rmsnorm", "rope_freqs", "apply_rope", "apply_mrope",
           "flash_sdpa",
           "flash_applicable", "Attention", "attention_apply",
           "attention_cache_init", "SwiGLU", "swiglu_apply", "dtype_of",
           "empty_weight", "dense_init_"]

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    """``cfg.param_dtype`` / ``cfg.compute_dtype`` name -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _no_mesh(mesh) -> None:
    """Raise for a mesh of more than one card; on one card the mesh
    changes nothing here. (Imported when called: the launch package
    imports the models.)"""
    from ..launch.mesh import one_card
    one_card(mesh)


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

def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
               *, causal: bool = True) -> torch.Tensor:
    """Blockwise attention for prefill through the flash kernel (no S^2
    traffic to device memory). Forward only: the kernel has no backward."""
    _no_mesh(mesh)
    return flash_attention(q, k, v, causal=causal)


def flash_applicable(cfg: ModelConfig, q_heads: int, seq: int,
                     mesh=None) -> bool:
    """Whether the reference would take the flash branch. Without tensor
    parallelism its head-tiling test always holds (every query head of a
    KV group is local), which leaves ``seq % 8 == 0``."""
    _no_mesh(mesh)
    return seq % 8 == 0


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

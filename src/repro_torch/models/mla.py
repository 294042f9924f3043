"""Multi-head Latent Attention (DeepSeek-V2): keys and values compressed
into a rank-``kv_lora_rank`` latent.

The JAX package's ``models/mla.py``. The decode cache stores only the
latent ``c_kv`` and one shared RoPE key per token — the serving memory MLA
exists for — and per-head keys and values are expanded from the latent
where attention needs them:

  q      = x W_q                         -> (H, qk_nope + qk_rope)
  c_kv   = x W_dkv                       -> (r,)
  k_rope = RoPE(x W_kr)                  -> (qk_rope,)  shared across heads
  k_nope = c_kv W_uk                     -> (H, qk_nope)
  v      = c_kv W_uv                     -> (H, v_head_dim)
  attn((q_nope, RoPE(q_rope)), (k_nope, k_rope), v) W_o

Prefill expands the latent (:func:`_mla_attend`); decode attends in the
latent space with ``W_uk`` and ``W_uv`` absorbed into the query and the
output (:func:`_mla_attend_absorbed`). MLA never takes the flash kernel,
as in the reference. The decode cache is written in place (the reference
returns an updated copy).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["MLA", "mla_apply", "mla_cache_init"]

F32 = torch.float32


class MLA(nn.Module):
    """wq (D, H*(qk_nope+qk_rope)), w_dkv (D, r), w_kr (D, qk_rope),
    w_uk (r, H*qk_nope), w_uv (r, H*v_head_dim), wo (H*v_head_dim, D)."""

    AXES = {"wq": ("embed", "qheads"), "w_dkv": ("embed", "kv_lora"),
            "w_kr": ("embed", "kvheads"), "w_uk": ("kv_lora", "qheads"),
            "w_uv": ("kv_lora", "qheads"), "wo": ("qheads", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        qk_n, qk_r, v_h = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = L.dtype_of(cfg.param_dtype)
        self.wq = L.empty_weight((D, H * (qk_n + qk_r)), dt, device)
        self.w_dkv = L.empty_weight((D, r), dt, device)
        self.w_kr = L.empty_weight((D, qk_r), dt, device)
        self.w_uk = L.empty_weight((r, H * qk_n), dt, device)
        self.w_uv = L.empty_weight((r, H * v_h), dt, device)
        self.wo = L.empty_weight((H * v_h, D), dt, device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.w_dkv, self.w_kr, self.w_uk, self.w_uv,
                  self.wo):
            L.dense_init_(w, generator)


def _mask_(logits: torch.Tensor, causal: bool,
           kv_len: Optional[int]) -> torch.Tensor:
    """NEG_INF where a query may not see a key: (B, H, Sq, Sk) logits."""
    Sq, Sk = logits.shape[-2:]
    kpos = torch.arange(Sk, device=logits.device)
    if causal:
        qpos = torch.arange(Sq, device=logits.device)
        logits.masked_fill_(kpos[None, :] > qpos[:, None], L.NEG_INF)
    if kv_len is not None:
        logits.masked_fill_(kpos >= kv_len, L.NEG_INF)
    return logits


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, *, causal: bool):
    """q_nope (B,Sq,H,qk_n), q_rope (B,Sq,H,qk_r), k_nope (B,Sk,H,qk_n),
    k_rope (B,Sk,qk_r) shared, v (B,Sk,H,v_h). Logits, softmax and the
    product with v in float32; the result in q's type."""
    scale = 1.0 / ((q_nope.shape[-1] + q_rope.shape[-1]) ** 0.5)
    logits = (torch.einsum("bqhd,bshd->bhqs", q_nope.to(F32), k_nope.to(F32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(F32),
                             k_rope.to(F32))) * scale
    probs = torch.softmax(_mask_(logits, causal, None), dim=-1)
    del logits
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(F32))
    return out.to(q_nope.dtype)


def _mla_attend_absorbed(cfg: ModelConfig, p: MLA, q_nope, q_rope, c_all,
                         kr_all, *, kv_len: int):
    """Weight-absorbed decode against the latent cache: never expands
    per-token keys or values.

        q_lat  = q_nope W_uk^T            (B, S, H, r)
        logits = q_lat . c_kv + q_rope . k_rope   (float32)
        ctx    = probs . c_kv             (B, S, H, r)
        out    = ctx W_uv                 (B, S, H, v_h)

    Products of compute-type operands accumulate in float32 (the
    reference's ``preferred_element_type``); the probabilities are cast
    to the compute type before the context product, as in the reference."""
    B, S, H, qk_n = q_nope.shape
    r = cfg.kv_lora_rank
    dt = q_nope.dtype
    w_uk = p.w_uk.to(dt).reshape(r, H, qk_n)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    scale = 1.0 / ((qk_n + q_rope.shape[-1]) ** 0.5)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(F32), c_all.to(F32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(F32),
                             kr_all.to(F32))) * scale
    probs = torch.softmax(_mask_(logits, False, kv_len), dim=-1).to(dt)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, c_all)
    w_uv = p.w_uv.to(dt).reshape(r, H, cfg.v_head_dim)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    return out.reshape(B, S, H * cfg.v_head_dim)


def mla_apply(cfg: ModelConfig, p: MLA, x: torch.Tensor,
              positions: torch.Tensor, *,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[int] = None):
    """x (B, S, D) -> (out (B, S, D), cache). With ``cache`` = {"c_kv":
    (B, Smax, r), "k_rope": (B, Smax, qk_rope)}, one decode step against
    the latent cache: the S new tokens are written at ``cache_index`` in
    place and attention sees the first ``cache_index + S`` entries."""
    B, S, D = x.shape
    H = cfg.n_heads
    qk_n, qk_r, v_h = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype

    q = (x @ p.wq.to(dt)).reshape(B, S, H, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = x @ p.w_dkv.to(dt)                                    # (B, S, r)
    k_rope = L.apply_rope((x @ p.w_kr.to(dt))[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        i = int(cache_index)
        cache["c_kv"][:, i:i + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, i:i + S] = k_rope.to(cache["k_rope"].dtype)
        out = _mla_attend_absorbed(cfg, p, q_nope, q_rope,
                                   cache["c_kv"].to(dt),
                                   cache["k_rope"].to(dt), kv_len=i + S)
        return out @ p.wo.to(dt), cache

    k_nope = (c_kv @ p.w_uk.to(dt)).reshape(B, S, H, qk_n)
    v = (c_kv @ p.w_uv.to(dt)).reshape(B, S, H, v_h)
    out = _mla_attend(q_nope, q_rope, k_nope, k_rope, v, causal=cfg.causal)
    return out.reshape(B, S, H * v_h) @ p.wo.to(dt), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes) for one MLA layer: zeros c_kv (B, max_len, r) and
    k_rope (B, max_len, qk_rope) in the compute type."""
    dt = L.dtype_of(cfg.compute_dtype)
    cache = {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                 dtype=dt, device=device),
             "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                   dtype=dt, device=device)}
    axes = {"c_kv": ("batch", "seq_cache", "kv_lora"),
            "k_rope": ("batch", "seq_cache", "head_dim")}
    return cache, axes

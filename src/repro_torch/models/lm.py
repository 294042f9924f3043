"""The dense transformer LM: prefill forward (plain or flash attention)
and KV-cache decode.

The JAX package's ``models/lm.py`` for the ``dense`` family, as an
``nn.Module``: embedding table, a ``ModuleList`` of blocks (attention +
SwiGLU, pre-norm), final norm, and an output head that is the embedding
table itself when ``cfg.tie_embeddings``. The reference stacks its
layers and scans over them; here the layers are a Python loop.

  LM(cfg).init_(generator)              random weights at the reference's scales
  forward(cfg, lm, batch, flash=...)    -> logits (B, S, vocab)
  init_cache(cfg, B, max_len)           -> (cache, axes)
  decode_step(cfg, lm, cache, tok, pos) -> (logits (B, 1, vocab), cache)

Tables are ``cfg.padded_vocab`` wide and logits are sliced back to
``cfg.vocab_size``. The training entry points (``loss_fn``,
``cross_entropy``) and the moe / mla / vlm / audio branches come with
later slices (ROADMAP A10b).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["LM", "Block", "check_ported", "forward", "init_cache",
           "decode_step"]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the port's dense slice."""
    if cfg.family != "dense" or cfg.use_mla or cfg.n_experts \
            or cfg.mrope_sections or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (mla={cfg.use_mla}, "
            f"experts={cfg.n_experts}) is not ported yet; the port builds "
            f"the dense family only (ROADMAP A10b lists what follows)")


class Block(nn.Module):
    """One pre-norm layer: h + attn(norm(h)), then h + ffn(norm(h))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.attn = L.Attention(cfg, device=device)
        self.ffn = L.SwiGLU(cfg, device=device)
        self.norm_attn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.norm_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)


class LM(nn.Module):
    """Parameters of a dense LM. Weights are created on ``device`` without
    values; :meth:`init_` draws them, ``models.carry`` loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.embed = L.empty_weight((cfg.padded_vocab, cfg.d_model), dt,
                                    device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.head = (None if cfg.tie_embeddings else
                     L.empty_weight((cfg.d_model, cfg.padded_vocab), dt,
                                    device))

    def init_(self, generator: torch.Generator) -> "LM":
        """Random weights at the reference's scales: embedding N(0, 0.02),
        dense weights N(0, 2 / (in + out)), norms one. The draws differ
        from ``jax.random``'s; the parity tests carry weights over."""
        with torch.no_grad():
            self.embed.normal_(0.0, 0.02, generator=generator)
            for blk in self.layers:
                blk.attn.init_(generator)
                blk.ffn.init_(generator)
            if self.head is not None:
                L.dense_init_(self.head, generator)
        return self


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _layer_apply(cfg: ModelConfig, lp: Block, h: torch.Tensor,
                 positions: torch.Tensor, mesh=None,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_index: Optional[int] = None, flash: bool = False):
    h_norm = lp.norm_attn(h)
    attn_out, new_cache = L.attention_apply(
        cfg, lp.attn, h_norm, positions, cache=cache,
        cache_index=cache_index, mesh=mesh, flash=flash)
    h = h + attn_out
    h = h + L.swiglu_apply(lp.ffn, lp.norm_ffn(h))
    return h, new_cache


def _embed_batch(cfg: ModelConfig, lm: LM, batch: Dict):
    """-> (h (B, S, D) in the compute type, positions (B, S))."""
    tokens = batch["tokens"]
    dt = L.dtype_of(cfg.compute_dtype)
    h = lm.embed[tokens].to(dt)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    return h, positions


def _head(cfg: ModelConfig, lm: LM, h: torch.Tensor) -> torch.Tensor:
    logits = (h @ lm.embed.T.to(h.dtype) if cfg.tie_embeddings
              else h @ lm.head.to(h.dtype))
    # tables are padded to cfg.padded_vocab
    return logits[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
            remat: str = "none", flash: bool = False) -> torch.Tensor:
    """Prefill forward: logits (B, S, vocab) in the compute type. With
    ``flash`` each layer's attention goes through the flash kernel where
    the reference's would (causal config, S % 8 == 0). ``remat`` is a
    training knob and must be ``"none"``."""
    if remat != "none":
        raise NotImplementedError(f"remat={remat!r}: rematerialisation is a "
                                  f"training option and the port serves only")
    h, positions = _embed_batch(cfg, lm, batch)
    for lp in lm.layers:
        h, _ = _layer_apply(cfg, lp, h, positions, mesh, flash=flash)
    h = lm.norm_f(h)
    return _head(cfg, lm, h)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes): k/v (n_layers, B, max_len, KV, hd) zeros in the
    compute type."""
    # one layer's cache on the meta device gives shapes and types only
    one, one_axes = L.attention_cache_init(cfg, batch, max_len, device="meta")
    cache = {name: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                               device=device) for name, t in one.items()}
    axes = {name: ("layers",) + ax for name, ax in one_axes.items()}
    return cache, axes


@torch.no_grad()
def decode_step(cfg: ModelConfig, lm: LM, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos, mesh=None):
    """One decode step. tokens: (B, 1) int; pos: int — the current cache
    length. Writes the new keys and values into ``cache`` in place and
    returns (logits (B, 1, vocab), cache)."""
    dt = L.dtype_of(cfg.compute_dtype)
    pos = int(pos)
    h = lm.embed[tokens].to(dt)
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    for i, lp in enumerate(lm.layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = _layer_apply(cfg, lp, h, positions, mesh, cache=layer_cache,
                            cache_index=pos)
    h = lm.norm_f(h)
    return _head(cfg, lm, h), cache

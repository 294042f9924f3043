"""The transformer LM of the dense, moe, audio and vlm families: training
loss, prefill forward (plain or flash attention) and KV-cache decode.

The JAX package's ``models/lm.py`` as an ``nn.Module``: embedding table
(none where ``not cfg.embed_inputs``: the audio family), a ``ModuleList``
of pre-norm blocks, final norm, and an output head that is the embedding
table itself when ``cfg.tie_embeddings`` and there is one. A block's
attention is GQA (``layers.Attention``)
or, with ``cfg.use_mla``, latent attention (``mla.MLA``); its FFN is a
SwiGLU, or with ``cfg.n_experts`` a mixture of experts (``moe.MoE``) plus
a shared SwiGLU of ``moe_d_ff * n_shared_experts``. The reference stacks
its layers and scans over them; here the layers are a Python loop.

  LM(cfg).init_(generator)              random weights at the reference's scales
  abstract_init(cfg)                    the LM on the ``meta`` device (shapes only)
  loss_fn(cfg, lm, batch, remat=...)    masked cross entropy, differentiable
  forward(cfg, lm, batch, flash=...)    -> logits (B, S, vocab), no gradient
  init_cache(cfg, B, max_len)           -> (cache, axes)
  decode_step(cfg, lm, cache, tok, pos) -> (logits (B, 1, vocab), cache)

Training and serving share one layer loop (:func:`forward_train`, which
records gradients); ``forward`` runs it under ``torch.no_grad``. Tables
are ``cfg.padded_vocab`` wide and logits are sliced back to
``cfg.vocab_size``. ``remat`` ("none", "full", "dots") chooses what the
backward pass recomputes and changes no value. The ssm and hybrid
families have models of their own (``ssm_lm.py``, ``hybrid.py``).

Batches, as in the reference:

  dense, moe : tokens (B, S) int, labels (B, S)
  audio      : frames (B, S, D) float (the frontend's output), labels (B, S);
               not causal, no rotary embedding, no decode step
  vlm        : tokens (B, S - P), patches (B, P, D) float, positions
               (3, B, S) int (M-RoPE's streams), labels (B, S) with -100
               over the P patches

A vlm decode step embeds text only and turns all three M-RoPE streams by
the cache index, as the reference's does.

``mesh`` is ``None`` or a mesh of one card (``launch.mesh``); on one card
the moe family's layers then take the expert-parallel path with its
capacity drops, as the reference's do on its one-device mesh, and
nothing else changes.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from . import layers as L
from . import mla as MLA
from . import moe as MOE

__all__ = ["LM", "Block", "check_ported", "abstract_init", "forward",
           "forward_train", "cross_entropy", "loss_fn", "init_cache",
           "decode_step", "REMAT", "check_remat", "remat_apply"]

REMAT = ("none", "full", "dots")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the families this LM builds."""
    if cfg.family not in ("dense", "moe", "audio", "vlm") \
            or (cfg.family == "dense" and cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not an LM of the port; "
            f"the LM builds the dense, moe, audio and vlm families (GQA or "
            f"MLA attention), and the ssm and hybrid families have models "
            f"of their own (models/ssm_lm.py, models/hybrid.py)")


class Block(nn.Module):
    """One pre-norm layer: h + attn(norm(h)), then h + ffn(norm(h)).
    ``attn`` is MLA or GQA; the FFN is ``moe`` (+ ``shared`` where the
    config has shared experts) or ``ffn``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.attn = (MLA.MLA(cfg, device=device) if cfg.use_mla
                     else L.Attention(cfg, device=device))
        if cfg.n_experts:
            self.moe = MOE.MoE(cfg, device=device)
            if cfg.n_shared_experts:
                self.shared = L.SwiGLU(
                    cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                    device=device)
        else:
            self.ffn = L.SwiGLU(cfg, device=device)
        self.norm_attn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.norm_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)

    def init_(self, generator: torch.Generator) -> None:
        for name in ("attn", "moe", "shared", "ffn"):
            if hasattr(self, name):
                getattr(self, name).init_(generator)


class LM(nn.Module):
    """Parameters of a dense, moe, audio or vlm LM. Weights are created on
    ``device`` without values; :meth:`init_` draws them, ``models.carry``
    loads them. ``embed`` is None where ``not cfg.embed_inputs``, ``head``
    where the head is the embedding table."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.embed = (L.empty_weight((cfg.padded_vocab, cfg.d_model), dt,
                                     device) if cfg.embed_inputs else None)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.head = (None if _tied(cfg) else
                     L.empty_weight((cfg.d_model, cfg.padded_vocab), dt,
                                    device))

    def init_(self, generator: torch.Generator) -> "LM":
        """Random weights at the reference's scales: embedding N(0, 0.02),
        dense weights N(0, 2 / (in + out)), norms one. The draws differ
        from ``jax.random``'s; the parity tests carry weights over."""
        with torch.no_grad():
            if self.embed is not None:
                self.embed.normal_(0.0, 0.02, generator=generator)
            for blk in self.layers:
                blk.init_(generator)
            if self.head is not None:
                L.dense_init_(self.head, generator)
        return self


def abstract_init(cfg: ModelConfig) -> LM:
    """The LM on the ``meta`` device: every parameter's shape and type,
    no storage (the reference's ``abstract_init``)."""
    return LM(cfg, device="meta")


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _ffn_block(cfg: ModelConfig, lp: Block, h_norm: torch.Tensor,
               mesh=None) -> torch.Tensor:
    if not cfg.n_experts:
        return L.swiglu_apply(lp.ffn, h_norm)
    B, S, D = h_norm.shape
    tokens = h_norm.reshape(B * S, D)
    if mesh is None:
        y = MOE.moe_apply_dense(cfg, lp.moe, tokens)
    else:
        y = MOE.moe_apply_ep(cfg, lp.moe, tokens, mesh)
    if cfg.n_shared_experts:
        y = y + L.swiglu_apply(lp.shared, tokens)
    return y.reshape(B, S, D)


def _layer_apply(cfg: ModelConfig, lp: Block, h: torch.Tensor,
                 positions: Optional[torch.Tensor], mesh=None,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_index: Optional[int] = None, flash: bool = False,
                 mrope: Optional[torch.Tensor] = None):
    """One block on h (B, S, D). ``positions`` (B, S) drive RoPE,
    ``mrope`` (3, B, S) M-RoPE (vlm; ``positions`` is then None)."""
    h_norm = lp.norm_attn(h)
    if cfg.use_mla:
        # MLA has no flash branch, in the reference as here
        attn_out, new_cache = MLA.mla_apply(
            cfg, lp.attn, h_norm, positions, cache=cache,
            cache_index=cache_index)
    else:
        attn_out, new_cache = L.attention_apply(
            cfg, lp.attn, h_norm, positions, mrope_positions=mrope,
            cache=cache, cache_index=cache_index, mesh=mesh, flash=flash)
    h = h + attn_out
    h = h + _ffn_block(cfg, lp, lp.norm_ffn(h), mesh)
    return h, new_cache


def _embed_batch(cfg: ModelConfig, lm: LM, batch: Dict):
    """-> (h (B, S, D) in the compute type, positions (B, S) or None,
    M-RoPE positions (3, B, S) or None). audio: the frames; vlm: the
    patches followed by the embedded text, with the batch's M-RoPE
    streams; otherwise the embedded tokens."""
    dt = L.dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        text = lm.embed[batch["tokens"]].to(dt)
        h = torch.cat([batch["patches"].to(dt), text], dim=1)
        return h, None, batch["positions"]
    h = (batch["frames"].to(dt) if cfg.family == "audio"
         else lm.embed[batch["tokens"]].to(dt))
    B, S = h.shape[:2]
    return h, torch.arange(S, device=h.device)[None, :].expand(B, S), None


def _tied(cfg: ModelConfig) -> bool:
    """Whether the head is the embedding table (the reference's rule: a
    model without an embedding table has a head of its own)."""
    return cfg.tie_embeddings and cfg.embed_inputs


def _head(cfg: ModelConfig, lm: LM, h: torch.Tensor) -> torch.Tensor:
    logits = (h @ lm.embed.T.to(h.dtype) if _tied(cfg)
              else h @ lm.head.to(h.dtype))
    # tables are padded to cfg.padded_vocab
    return logits[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def _save_projections(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the projection products (``aten.mm``: ``x @ w`` with no batch
    dimension) and recompute everything else, attention's batched
    products included. The counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: str, grad: bool = True) -> None:
    """``remat`` must be one of REMAT, and "none" where no gradient is
    taken (a forward for serving)."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: choose from {REMAT}")
    if not grad and remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: rematerialisation only applies where "
            f"gradients are taken; train through loss_fn")


def remat_apply(body, h: torch.Tensor, remat: str) -> torch.Tensor:
    """``body(h)``, one layer, keeping for the backward pass what
    ``remat`` says: "none" every activation, "full" the layer's input
    only, "dots" also the projections' outputs (``torch.utils.checkpoint``,
    non-reentrant)."""
    if remat == "none":
        return body(h)
    if remat == "full":
        return ckpt.checkpoint(body, h, use_reentrant=False)
    return ckpt.checkpoint(body, h, use_reentrant=False,
                           context_fn=functools.partial(
                               ckpt.create_selective_checkpoint_contexts,
                               _save_projections))


def forward_train(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
                  remat: str = "none", flash: bool = False) -> torch.Tensor:
    """Logits (B, S, vocab) in the compute type, recording gradients for
    whichever weights require them, each layer under
    :func:`remat_apply`."""
    check_remat(remat)
    L._no_mesh(mesh)
    h, positions, mrope = _embed_batch(cfg, lm, batch)
    for lp in lm.layers:
        h = remat_apply(lambda h, lp=lp: _layer_apply(
            cfg, lp, h, positions, mesh, flash=flash, mrope=mrope)[0], h,
            remat)
    h = lm.norm_f(h)
    return _head(cfg, lm, h)


@torch.no_grad()
def forward(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
            remat: str = "none", flash: bool = False) -> torch.Tensor:
    """Prefill forward: logits (B, S, vocab) in the compute type, without
    gradients. With ``flash`` each layer's attention goes through the
    flash kernel where the reference's would (causal config,
    S % 8 == 0). ``remat`` only matters where gradients are taken, so it
    must be ``"none"`` here; training goes through :func:`loss_fn`."""
    check_remat(remat, grad=False)
    return forward_train(cfg, lm, batch, mesh, flash=flash)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100) -> torch.Tensor:
    """Masked cross entropy in float32; labels == ``ignore`` are excluded.
    The gold logit is picked by indexing, whose backward has a
    deterministic CUDA implementation."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    gold = flat[rows, labels.reshape(-1).clamp_min(0).long()]
    nll = lse - gold.reshape(labels.shape)
    mask = (labels != ignore).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Mean cross entropy of ``batch``'s logits against its labels (those
    of -100 left out) with plain attention, as the reference's (the flash
    kernel has no backward)."""
    logits = forward_train(cfg, lm, batch, mesh, remat=remat)
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes), zeros in the compute type: k/v (n_layers, B, max_len,
    KV, hd) for GQA; for MLA the latent c_kv (n_layers, B, max_len, r) and
    k_rope (n_layers, B, max_len, qk_rope)."""
    # one layer's cache on the meta device gives shapes and types only
    one_init = MLA.mla_cache_init if cfg.use_mla else L.attention_cache_init
    one, one_axes = one_init(cfg, batch, max_len, device="meta")
    cache = {name: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                               device=device) for name, t in one.items()}
    axes = {name: ("layers",) + ax for name, ax in one_axes.items()}
    return cache, axes


@torch.no_grad()
def decode_step(cfg: ModelConfig, lm: LM, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos, mesh=None):
    """One decode step. tokens: (B, 1) int; pos: int — the current cache
    length. Writes the new keys and values (for MLA the latent and the
    RoPE key) into ``cache`` in place and returns (logits (B, 1, vocab),
    cache). The audio family is an encoder and raises ValueError; a vlm
    step embeds text and turns all three M-RoPE streams by ``pos``."""
    if cfg.family == "audio":
        raise ValueError("encoder-only architecture has no decode step")
    L._no_mesh(mesh)
    dt = L.dtype_of(cfg.compute_dtype)
    pos = int(pos)
    h = lm.embed[tokens].to(dt)
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    mrope = (positions[None].expand(3, B, 1) if cfg.mrope_sections
             else None)
    for i, lp in enumerate(lm.layers):
        layer_cache = {name: c[i] for name, c in cache.items()}
        h, _ = _layer_apply(cfg, lp, h, positions, mesh, cache=layer_cache,
                            cache_index=pos, mrope=mrope)
    h = lm.norm_f(h)
    return _head(cfg, lm, h), cache

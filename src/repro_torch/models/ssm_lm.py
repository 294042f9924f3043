"""Pure-SSM language model (mamba2-130m): an attention-free Mamba2 stack.

The JAX package's ``models/ssm_lm.py`` as an ``nn.Module``: embedding
table, a ``ModuleList`` of pre-norm blocks ``h + mamba(norm(h))``, final
norm, and an output head that is the embedding table itself when
``cfg.tie_embeddings``. The reference scans over stacked layers; here the
layers are a Python loop.

  SSMLM(cfg).init_(generator)           random weights at the reference's scales
  abstract_init(cfg)                    the model on the ``meta`` device
  loss_fn(cfg, lm, batch, remat=...)    masked cross entropy, differentiable
  forward(cfg, lm, batch)               -> logits (B, S, vocab), no gradient
  init_cache(cfg, B, max_len)           -> (cache, axes)
  decode_step(cfg, lm, cache, tok, pos) -> (logits (B, 1, vocab), cache)

The decode cache is each layer's SSM state and conv tail, stacked on a
leading ``n_layers`` dim as the reference's; its size does not depend on
``max_len``. ``decode_step`` writes it in place (the reference returns an
updated copy) and returns it. No Pallas kernel lies on this path in the
reference, and no CUDA kernel of the port does.

Across the ranks of a DeviceMesh each rank runs its block of the batch
rows, the embedding and head split by vocabulary over "model" and each
Mamba2 layer's ``out_proj`` by rows (``lm.py``'s note, ``mamba2.py``'s),
and :func:`loss_fn` is the global masked mean.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from . import lm as LMmod
from . import mamba2 as M

__all__ = ["SSMLM", "SSMBlock", "abstract_init", "forward", "forward_train",
           "loss_fn", "init_cache", "decode_step"]


class SSMBlock(nn.Module):
    """One pre-norm Mamba2 layer: ``mamba`` and its ``norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mamba = M.Mamba2(cfg, device=device)
        self.norm = L.RMSNorm(cfg.d_model, cfg.norm_eps,
                              L.dtype_of(cfg.param_dtype), device)

    def init_(self, generator: torch.Generator) -> None:
        self.mamba.init_(generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """The reference's embedding scale, N(0, 0.02^2)."""
    with torch.no_grad():
        w.normal_(0.0, 0.02, generator=generator)


class SSMLM(nn.Module):
    """Parameters of the ssm family's LM. Weights are created on
    ``device`` without values; :meth:`init_` draws them, ``models.carry``
    loads them."""

    AXES = L.TABLE_AXES

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: SSMLM builds the ssm family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.embed = L.empty_weight((cfg.padded_vocab, cfg.d_model), dt,
                                    device)
        self.layers = nn.ModuleList(SSMBlock(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.head = (None if cfg.tie_embeddings else
                     L.empty_weight((cfg.d_model, cfg.padded_vocab), dt,
                                    device))

    def init_(self, generator: torch.Generator) -> "SSMLM":
        embed_init_(self.embed, generator)
        for blk in self.layers:
            blk.init_(generator)
        if self.head is not None:
            L.dense_init_(self.head, generator)
        return self


def abstract_init(cfg: ModelConfig) -> SSMLM:
    """The model on the ``meta`` device: shapes and types, no storage."""
    return SSMLM(cfg, device="meta")


def mamba_layer(cfg: ModelConfig, lp: SSMBlock, h: torch.Tensor,
                mesh=None) -> torch.Tensor:
    return h + M.mamba2_apply(cfg, lp.mamba, lp.norm(h), mesh)


def forward_train(cfg: ModelConfig, lm: SSMLM, batch: Dict, mesh=None,
                  remat: str = "none") -> torch.Tensor:
    """Logits (B, S, vocab) in the compute type, recording gradients for
    whichever weights require them, each layer under
    ``lm.remat_apply``; across the ranks of a DeviceMesh the whole logits
    on every rank."""
    LMmod.check_remat(remat)
    if L.ranked(mesh):
        logits, _ = forward_rows(cfg, lm, batch, mesh, remat)
        return L.gather_rows(logits, mesh, batch["tokens"].shape[0])
    h = lm.embed[batch["tokens"]].to(L.dtype_of(cfg.compute_dtype))
    for lp in lm.layers:
        h = LMmod.remat_apply(lambda h, lp=lp: mamba_layer(cfg, lp, h), h,
                              remat)
    return LMmod._head(cfg, lm, lm.norm_f(h))


def forward_rows(cfg: ModelConfig, lm: SSMLM, batch: Dict, mesh,
                 remat: str = "none"):
    """Across the ranks of a DeviceMesh: (this rank's rows' logits, those
    rows of the batch)."""
    tokens = batch["tokens"]
    rows = L.batch_rows(tokens.shape[0], mesh)
    with L.tp_weights(lm, mesh, skip=("layers",)):
        h = LMmod.embed_tokens(cfg, lm.embed, tokens[rows], mesh)
        for lp in lm.layers:
            h = LMmod.remat_apply(L.tp_body(
                lp, mesh, lambda lp, h: mamba_layer(cfg, lp, h, mesh)), h,
                remat)
        return LMmod._head(cfg, lm, lm.norm_f(h), mesh), rows


@torch.no_grad()
def forward(cfg: ModelConfig, lm: SSMLM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Prefill forward: logits (B, S, vocab) in the compute type, without
    gradients (``remat`` must be "none"; train through :func:`loss_fn`)."""
    LMmod.check_remat(remat, grad=False)
    return forward_train(cfg, lm, batch, mesh)


def loss_fn(cfg: ModelConfig, lm: SSMLM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (tokens, labels); across
    the ranks of a DeviceMesh the global mean over every rank's rows."""
    if L.ranked(mesh):
        logits, rows = forward_rows(cfg, lm, batch, mesh, remat)
        return LMmod.ranked_loss(logits, rows, batch, mesh)
    return LMmod.cross_entropy(forward_train(cfg, lm, batch, mesh, remat),
                               batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes): every layer's SSM state (n_layers, B, H, hd, N) in
    float32 and conv tail (n_layers, B, W - 1, C) in the compute type,
    zeros. ``max_len`` does not change it."""
    one, one_axes = M.mamba2_cache_init(cfg, batch, device="meta")
    cache = {name: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                               device=device) for name, t in one.items()}
    axes = {name: ("layers",) + ax for name, ax in one_axes.items()}
    return cache, axes


def decode_layers(cfg: ModelConfig, layers, cache: Dict[str, torch.Tensor],
                  h: torch.Tensor, first: int = 0, mesh=None) -> torch.Tensor:
    """One token through ``layers``, whose caches are rows ``first``,
    ``first + 1``, ... of ``cache``; each new state and conv tail is
    written into its row."""
    for i, lp in enumerate(layers, start=first):
        with L.tp_weights(lp, mesh):
            out, new = M.mamba2_decode_step(
                cfg, lp.mamba, lp.norm(h), {k: c[i] for k, c in cache.items()},
                mesh)
        for k, c in cache.items():
            c[i].copy_(new[k])
        h = h + out
    return h


@torch.no_grad()
def decode_step(cfg: ModelConfig, lm: SSMLM, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos, mesh=None):
    """One decode step. tokens: (B, 1) int; ``pos`` (the current length)
    is accepted for the interface: the state has no positions. Writes
    the new states into ``cache`` in place and returns (logits (B, 1,
    vocab), cache). Across the ranks of a DeviceMesh each rank steps its
    batch rows (``layers.batch_rows``), writes their states, and returns
    the whole logits."""
    B = tokens.shape[0]
    rows = L.batch_rows(B, mesh)
    with L.tp_weights(lm, mesh, skip=("layers",)):
        h = LMmod.embed_tokens(cfg, lm.embed, tokens[rows], mesh)
        h = decode_layers(cfg, lm.layers,
                          {k: c[:, rows] for k, c in cache.items()}, h,
                          mesh=mesh)
        logits = LMmod._head(cfg, lm, lm.norm_f(h), mesh)
    if L.ranked(mesh):
        logits = L.gather_rows(logits, mesh, B)
    return logits, cache

"""Zamba2-style hybrid: a Mamba2 backbone plus one *shared* attention
block.

The JAX package's ``models/hybrid.py`` as an ``nn.Module``. The backbone
is ``n_layers`` Mamba2 blocks (``ssm_lm.SSMBlock``); a single shared
attention + SwiGLU block (one set of weights, Zamba's weight sharing) is
applied before every ``attn_every``-layer segment of the backbone. For
zamba2-1.2b (38 layers, every 6) that is 7 applications of the shared
block, each with its own KV-cache slot in decode. The head is untied.

The shared block's attention is the plain branch (``layers._sdpa``),
never the flash kernel, in prefill as in training: the reference calls
``attention_apply`` without ``flash``. So no CUDA kernel of the port
lies on this path.

The decode cache is ``{"attn": {"k", "v"} (n_segments, B, max_len, KV,
hd), "ssm": {"state", "conv"} (n_layers, ...)}``; ``decode_step`` writes
it in place and returns it. Across ranks a cache placed by the partition
rules may hold only the rank's KV heads and SSM heads, and only its
chunk of the positions (``layers.local_rows``, ``layers.seq_split``).

Across the ranks of a DeviceMesh each rank runs its block of the batch
rows; the shared block's attention and SwiGLU, the Mamba2 layers'
``out_proj``, the embedding and the head are tensor parallel over
"model" (``lm.py``'s note), and :func:`loss_fn` is the global mean.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from . import lm as LMmod
from . import ssm_lm as SSM

__all__ = ["HybridLM", "SharedBlock", "segments", "abstract_init", "forward",
           "forward_train", "loss_fn", "init_cache", "decode_step"]


def segments(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[(start, length)] segments of the mamba stack, one application of
    the shared block before each."""
    k = cfg.attn_every
    return [(s, min(k, cfg.n_layers - s)) for s in range(0, cfg.n_layers, k)]


class SharedBlock(nn.Module):
    """The shared block: GQA ``attn``, SwiGLU ``ffn`` and their norms."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.attn = L.Attention(cfg, device=device)
        self.ffn = L.SwiGLU(cfg, device=device)
        self.norm_attn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.norm_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)

    def init_(self, generator: torch.Generator) -> None:
        self.attn.init_(generator)
        self.ffn.init_(generator)


class HybridLM(nn.Module):
    """Parameters of the hybrid family's LM: ``embed``, the Mamba2
    ``layers``, the ``shared`` block, ``norm_f`` and ``head``."""

    AXES = L.TABLE_AXES

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: HybridLM builds the hybrid "
                             f"family, not {cfg.family!r}")
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.embed = L.empty_weight((cfg.padded_vocab, cfg.d_model), dt,
                                    device)
        self.layers = nn.ModuleList(SSM.SSMBlock(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device=device)
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.head = L.empty_weight((cfg.d_model, cfg.padded_vocab), dt,
                                   device)

    def init_(self, generator: torch.Generator) -> "HybridLM":
        SSM.embed_init_(self.embed, generator)
        for blk in self.layers:
            blk.init_(generator)
        self.shared.init_(generator)
        L.dense_init_(self.head, generator)
        return self


def abstract_init(cfg: ModelConfig) -> HybridLM:
    """The model on the ``meta`` device: shapes and types, no storage."""
    return HybridLM(cfg, device="meta")


def _shared_block_apply(cfg: ModelConfig, sp: SharedBlock, h: torch.Tensor,
                        positions: torch.Tensor, cache=None,
                        cache_index=None, mesh=None, cache_seq=None):
    attn_out, new_cache = L.attention_apply(
        cfg, sp.attn, sp.norm_attn(h), positions, cache=cache,
        cache_index=cache_index, mesh=mesh, cache_seq=cache_seq)
    h = h + attn_out
    h = h + L.swiglu_apply(sp.ffn, sp.norm_ffn(h), mesh)
    return h, new_cache


def forward_train(cfg: ModelConfig, lm: HybridLM, batch: Dict, mesh=None,
                  remat: str = "none") -> torch.Tensor:
    """Logits (B, S, vocab) in the compute type on one card, recording
    gradients for whichever weights require them. ``remat`` applies to
    the Mamba2 layers only, as in the reference (the shared block is not
    rematerialised there). Across the ranks of a DeviceMesh,
    :func:`forward_rows` gives each rank its block."""
    LMmod.check_remat(remat)
    LMmod._one_card(mesh, "forward_train")
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = lm.embed[tokens].to(L.dtype_of(cfg.compute_dtype))
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    for start, length in segments(cfg):
        h, _ = _shared_block_apply(cfg, lm.shared, h, positions)
        for lp in lm.layers[start:start + length]:
            h = LMmod.remat_apply(
                lambda h, lp=lp: SSM.mamba_layer(cfg, lp, h), h, remat)
    return LMmod._head(cfg, lm, lm.norm_f(h))


def forward_rows(cfg: ModelConfig, lm: HybridLM, batch: Dict, mesh,
                 remat: str = "none"):
    """Across the ranks of a DeviceMesh: (this rank's rows' logits, those
    rows of the batch), as ``lm.forward_rows`` gives them."""
    tokens = batch["tokens"]
    rows = L.batch_rows(tokens.shape[0], mesh)
    with L.tp_weights(lm, mesh, skip=("layers",)):
        h = LMmod.embed_tokens(cfg, lm.embed, L.local_rows(tokens, rows),
                               mesh)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
        for start, length in segments(cfg):
            h, _ = _shared_block_apply(cfg, lm.shared, h, positions,
                                       mesh=mesh)
            for lp in lm.layers[start:start + length]:
                h = LMmod.remat_apply(L.tp_body(
                    lp, mesh, lambda lp, h: SSM.mamba_layer(cfg, lp, h,
                                                            mesh)), h, remat)
        return LMmod._head(cfg, lm, lm.norm_f(h), mesh), rows


@torch.no_grad()
def forward(cfg: ModelConfig, lm: HybridLM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Prefill forward: logits (B, S, vocab) in the compute type, without
    gradients (``remat`` must be "none"; train through :func:`loss_fn`);
    across the ranks of a DeviceMesh a DTensor placed by
    ``lm.place_logits``."""
    LMmod.check_remat(remat, grad=False)
    if L.ranked(mesh):
        logits, _ = forward_rows(cfg, lm, batch, mesh)
        return LMmod.place_logits(cfg, logits, mesh,
                                  batch["tokens"].shape[0])
    return forward_train(cfg, lm, batch, mesh)


def loss_fn(cfg: ModelConfig, lm: HybridLM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (tokens, labels); across
    the ranks of a DeviceMesh the global mean over every rank's rows."""
    if L.ranked(mesh):
        logits, rows = forward_rows(cfg, lm, batch, mesh, remat)
        return LMmod.ranked_loss(cfg, logits, rows, batch, mesh)
    return LMmod.cross_entropy(forward_train(cfg, lm, batch, mesh, remat),
                               batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes): the shared block's k/v for each segment (n_seg, B,
    max_len, KV, hd) in the compute type, and the Mamba2 layers' caches
    as ``ssm_lm.init_cache`` gives them; zeros."""
    n_seg = len(segments(cfg))
    one, one_axes = L.attention_cache_init(cfg, batch, max_len,
                                           device="meta")
    attn = {name: torch.zeros((n_seg,) + t.shape, dtype=t.dtype,
                              device=device) for name, t in one.items()}
    ssm, ssm_axes = SSM.init_cache(cfg, batch, max_len, device=device)
    axes = {"attn": {name: ("shared_sites",) + ax
                     for name, ax in one_axes.items()},
            "ssm": ssm_axes}
    return {"attn": attn, "ssm": ssm}, axes


@torch.no_grad()
def decode_step(cfg: ModelConfig, lm: HybridLM, cache: Dict, tokens:
                torch.Tensor, pos, mesh=None):
    """One decode step. tokens: (B, 1) int; pos: int — the current cache
    length. Each application of the shared block writes its keys and
    values into its own slot of ``cache["attn"]``, each Mamba2 layer its
    state into ``cache["ssm"]``, in place; returns (logits (B, 1,
    vocab), cache). Across the ranks of a DeviceMesh each rank steps its
    batch rows, writes their caches, and returns the logits placed by
    ``lm.place_logits``."""
    pos = int(pos)
    B = tokens.shape[0]
    rows = L.batch_rows(B, mesh)
    with L.tp_weights(lm, mesh, skip=("layers",), decode=True):
        h = LMmod.embed_tokens(cfg, lm.embed, L.local_rows(tokens, rows),
                               mesh)
        ssm = {k: L.local_rows(c, rows, 1) for k, c in cache["ssm"].items()}
        seq = L.seq_split(cache["attn"]["k"], 2)
        positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                               device=h.device)
        for si, (start, length) in enumerate(segments(cfg)):
            site = {name: L.local_rows(c, rows, 1)[si]
                    for name, c in cache["attn"].items()}
            h, _ = _shared_block_apply(cfg, lm.shared, h, positions,
                                       cache=site, cache_index=pos,
                                       mesh=mesh, cache_seq=seq)
            h = SSM.decode_layers(cfg, lm.layers[start:start + length],
                                  ssm, h, first=start, mesh=mesh)
        logits = LMmod._head(cfg, lm, lm.norm_f(h), mesh)
    if L.ranked(mesh):
        logits = LMmod.place_logits(cfg, logits, mesh, B)
    return logits, cache

"""Architecture registry of the port: arch id -> (ModelConfig, ModelApi).

The same entry points as the JAX package's ``models/registry.py``, for
all ten of its architectures: the four of the dense family,
deepseek-v2-lite-16b (MoE with latent attention) and kimi-k2-1t-a32b
(MoE with GQA) of the moe family, mamba2-130m of the ssm family,
zamba2-1.2b of the hybrid family, hubert-xlarge of the audio family (a
bidirectional encoder over frame embeddings) and qwen2-vl-2b of the vlm
family (M-RoPE over patch embeddings followed by text).

    api = build_model("llama3-8b")
    lm = api.init(generator)                     # weights on get_device()
    logits = api.forward(lm, batch, flash=True)  # prefill (ssm, hybrid: no flash)
    loss = api.loss_fn(lm, batch, remat="dots")  # training loss
    cache, _ = api.init_cache(B, max_len)        # None for an encoder (audio)
    logits, cache = api.decode_step(lm, cache, tokens, pos)

The parameters are a module of the family's class (:func:`model_class`:
``lm.LM``, ``ssm_lm.SSMLM`` or ``hybrid.HybridLM``; weights ``(in, out)``
as in the reference); ``models.carry`` loads the reference's parameter
tree into one.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import get_device
from . import hybrid
from . import lm as LMmod
from . import ssm_lm

__all__ = ["ModelApi", "build_model", "get_config", "list_archs", "ARCHS",
           "NOT_PORTED", "model_class", "family_module"]

# arch id -> config module (each exposes CONFIG: ModelConfig)
ARCHS = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

# archs of the reference that the port does not build yet -> what ports
# them (none: the port builds every arch of the reference)
NOT_PORTED: dict = {}


@dataclasses.dataclass
class ModelApi:
    """Training and serving interface of one architecture. Every call
    runs on :func:`repro_torch.get_device` unless the caller selects the
    CPU."""

    cfg: ModelConfig
    init: Callable          # generator -> model
    abstract_init: Callable  # () -> model on the meta device
    forward: Callable       # (lm, batch, mesh=None, remat="none", flash=False) -> logits
    #                         (the ssm and hybrid families take no flash)
    loss_fn: Callable       # (lm, batch, mesh=None, remat="none") -> loss
    init_cache: Optional[Callable]   # (batch, max_len) -> (cache, axes);
    #                                  None for an encoder
    decode_step: Optional[Callable]  # (lm, cache, tokens, pos, mesh=None)
    #                                  -> (logits, cache); None for an encoder


def family_module(cfg: ModelConfig):
    """The module of ``cfg``'s family: ``ssm_lm``, ``hybrid`` or ``lm``
    (which raises for a family the port does not build yet)."""
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family == "hybrid":
        return hybrid
    LMmod.check_ported(cfg)
    return LMmod


def model_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s parameters."""
    mod = family_module(cfg)
    return {ssm_lm: ssm_lm.SSMLM, hybrid: hybrid.HybridLM}.get(mod, LMmod.LM)


def _init(cfg: ModelConfig):
    cls = model_class(cfg)

    def init(generator: torch.Generator):
        dev = get_device()
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, weights on "
                             f"{dev}: make the generator on the device")
        return cls(cfg, device=dev).init_(generator)

    return init


def _lm_api(cfg: ModelConfig) -> ModelApi:
    LMmod.check_ported(cfg)
    return ModelApi(
        cfg=cfg,
        init=_init(cfg),
        abstract_init=lambda: LMmod.abstract_init(cfg),
        forward=lambda p, b, mesh=None, remat="none", flash=False:
        LMmod.forward(cfg, p, b, mesh, remat=remat, flash=flash),
        loss_fn=lambda p, b, mesh=None, remat="none": LMmod.loss_fn(
            cfg, p, b, mesh, remat=remat),
        init_cache=(None if not cfg.is_decoder else
                    lambda batch, max_len: LMmod.init_cache(
                        cfg, batch, max_len, device=get_device())),
        decode_step=(None if not cfg.is_decoder else
                     lambda p, c, t, pos, mesh=None: LMmod.decode_step(
                         cfg, p, c, t, pos, mesh)),
    )


def _recurrent_api(cfg: ModelConfig, mod) -> ModelApi:
    """The ssm (``ssm_lm``) and hybrid (``hybrid``) families: the
    reference's ``_ssm_api`` and ``_hybrid_api``, whose forward has no
    flash branch."""
    return ModelApi(
        cfg=cfg,
        init=_init(cfg),
        abstract_init=lambda: mod.abstract_init(cfg),
        forward=lambda p, b, mesh=None, remat="none": mod.forward(
            cfg, p, b, mesh, remat=remat),
        loss_fn=lambda p, b, mesh=None, remat="none": mod.loss_fn(
            cfg, p, b, mesh, remat=remat),
        init_cache=lambda batch, max_len: mod.init_cache(
            cfg, batch, max_len, device=get_device()),
        decode_step=lambda p, c, t, pos, mesh=None: mod.decode_step(
            cfg, p, c, t, pos, mesh),
    )


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(f"{arch} is not ported yet: "
                                  f"{NOT_PORTED[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def build_model(cfg_or_arch) -> ModelApi:
    cfg = (get_config(cfg_or_arch) if isinstance(cfg_or_arch, str)
           else cfg_or_arch)
    mod = family_module(cfg)
    return _lm_api(cfg) if mod is LMmod else _recurrent_api(cfg, mod)


def list_archs():
    return sorted(ARCHS)

"""Architecture registry of the port: arch id -> (ModelConfig, ModelApi).

The same entry points as the JAX package's ``models/registry.py``, for
the architectures the port builds so far: the four of the dense family,
and deepseek-v2-lite-16b (MoE with latent attention) and kimi-k2-1t-a32b
(MoE with GQA) of the moe family. The other archs of the reference raise
``NotImplementedError`` naming the ROADMAP item that ports them.

    api = build_model("llama3-8b")
    lm = api.init(generator)                     # weights on get_device()
    logits = api.forward(lm, batch, flash=True)  # prefill
    loss = api.loss_fn(lm, batch, remat="dots")  # training loss
    cache, _ = api.init_cache(B, max_len)
    logits, cache = api.decode_step(lm, cache, tokens, pos)

The parameters are an :class:`~repro_torch.models.lm.LM` module (weights
``(in, out)`` as in the reference); ``models.carry`` loads the
reference's parameter tree into one.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import get_device
from . import lm as LMmod

__all__ = ["ModelApi", "build_model", "get_config", "list_archs", "ARCHS",
           "NOT_PORTED"]

# arch id -> config module (each exposes CONFIG: ModelConfig)
ARCHS = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
}

# archs of the reference that the port does not build yet -> what ports them
NOT_PORTED = {
    "hubert-xlarge": "ROADMAP A10b.6d (audio family)",
    "qwen2-vl-2b": "ROADMAP A10b.6d (vlm family, M-RoPE)",
    "zamba2-1.2b": "ROADMAP A10b.6c (hybrid family)",
    "mamba2-130m": "ROADMAP A10b.6b (ssm family)",
}


@dataclasses.dataclass
class ModelApi:
    """Training and serving interface of one architecture. Every call
    runs on :func:`repro_torch.get_device` unless the caller selects the
    CPU."""

    cfg: ModelConfig
    init: Callable          # generator -> LM
    abstract_init: Callable  # () -> LM on the meta device
    forward: Callable       # (lm, batch, mesh=None, remat="none", flash=False) -> logits
    loss_fn: Callable       # (lm, batch, mesh=None, remat="none") -> loss
    init_cache: Callable    # (batch, max_len) -> (cache, axes)
    decode_step: Callable   # (lm, cache, tokens, pos, mesh=None) -> (logits, cache)


def _lm_api(cfg: ModelConfig) -> ModelApi:
    LMmod.check_ported(cfg)

    def init(generator: torch.Generator) -> LMmod.LM:
        dev = get_device()
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, weights on "
                             f"{dev}: make the generator on the device")
        return LMmod.LM(cfg, device=dev).init_(generator)

    return ModelApi(
        cfg=cfg,
        init=init,
        abstract_init=lambda: LMmod.abstract_init(cfg),
        forward=lambda p, b, mesh=None, remat="none", flash=False:
        LMmod.forward(cfg, p, b, mesh, remat=remat, flash=flash),
        loss_fn=lambda p, b, mesh=None, remat="none": LMmod.loss_fn(
            cfg, p, b, mesh, remat=remat),
        init_cache=lambda batch, max_len: LMmod.init_cache(
            cfg, batch, max_len, device=get_device()),
        decode_step=lambda p, c, t, pos, mesh=None: LMmod.decode_step(
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
    return _lm_api(cfg)


def list_archs():
    return sorted(ARCHS)

"""Weights carried across: the JAX package's parameter tree -> the port.

The reference keeps its parameters as a pytree of arrays with the layers
stacked along a leading ``n_layers`` dim:

  embed (padded_vocab, D)          norm_f (D,)      head (D, padded_vocab)
  layers/attn/{wq,wk,wv,wo}        (L, in, out)     [head absent when tied]
  layers/ffn/{w_gate,w_up,w_down}  (L, in, out)
  layers/norm_attn, layers/norm_ffn (L, D)

:func:`params_from_reference` takes that tree as nested dicts of numpy
arrays (the caller converts; nothing here imports the reference) and
loads it into an :class:`~repro_torch.models.lm.LM`. Both packages use
the ``(in, out)`` layout of ``x @ w``, so nothing is transposed.
:func:`cache_from_reference` does the same for a decode cache
``{"k", "v"}`` of shape (L, B, max_len, KV, hd).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import get_device
from . import layers as L
from .lm import LM

__all__ = ["params_from_reference", "cache_from_reference"]


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``ml_dtypes`` gives them
    from a jax array) as a tensor of ``dtype`` on ``device``."""
    a = np.array(a)     # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _set(param: torch.Tensor, value, where: str) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{where}: reference shape {tuple(value.shape)}, "
                         f"port expects {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(_to_tensor(value, param.dtype, param.device))


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device=None) -> LM:
    """An LM on ``device`` (default :func:`repro_torch.get_device`) holding
    the reference's parameters ``tree``. Raises on a missing or extra
    leaf and on any shape that differs."""
    lm = LM(cfg, device=device if device is not None else get_device())
    layers = tree["layers"]
    expect = {"embed", "layers", "norm_f"} | (
        set() if cfg.tie_embeddings else {"head"})
    if set(tree) != expect:
        raise ValueError(f"reference tree has {sorted(tree)}, expected "
                         f"{sorted(expect)}")
    _set(lm.embed, tree["embed"], "embed")
    _set(lm.norm_f.gamma, tree["norm_f"], "norm_f")
    if lm.head is not None:
        _set(lm.head, tree["head"], "head")
    for i, blk in enumerate(lm.layers):
        for name in ("wq", "wk", "wv", "wo"):
            _set(getattr(blk.attn, name), layers["attn"][name][i],
                 f"layers/attn/{name}[{i}]")
        for name in ("w_gate", "w_up", "w_down"):
            _set(getattr(blk.ffn, name), layers["ffn"][name][i],
                 f"layers/ffn/{name}[{i}]")
        _set(blk.norm_attn.gamma, layers["norm_attn"][i],
             f"layers/norm_attn[{i}]")
        _set(blk.norm_ffn.gamma, layers["norm_ffn"][i],
             f"layers/norm_ffn[{i}]")
    return lm


def cache_from_reference(cfg: ModelConfig, cache: Mapping,
                         device=None) -> Dict[str, torch.Tensor]:
    """The reference's decode cache {"k", "v"} (L, B, max_len, KV, hd) as
    tensors of the compute type on ``device``."""
    dev = device if device is not None else get_device()
    dt = L.dtype_of(cfg.compute_dtype)
    out = {}
    for name in ("k", "v"):
        a = np.asarray(cache[name])
        if a.ndim != 5 or a.shape[0] != cfg.n_layers \
                or a.shape[3:] != (cfg.n_kv_heads, cfg.resolved_head_dim):
            raise ValueError(f"cache {name}: shape {a.shape} is not (L={cfg.n_layers}, "
                             f"B, max_len, KV={cfg.n_kv_heads}, "
                             f"hd={cfg.resolved_head_dim})")
        out[name] = _to_tensor(a, dt, dev)
    return out

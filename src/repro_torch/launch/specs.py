"""Input builders of the port: concrete batches for training and prefill.

The JAX package's ``launch/specs.py::make_batch`` for every family, drawn
from an explicit ``torch.Generator`` on the generator's device. The
audio and vlm families' frontends are stubs, as in the reference:
``frames`` and ``patches`` arrive as precomputed embeddings.
:func:`batch_specs` and :func:`decode_specs` give the dry run's
stand-ins: tensors on the ``meta`` device (shapes and types, no storage),
the counterparts of the reference's ``jax.ShapeDtypeStruct`` leaves.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["make_batch", "batch_specs", "decode_specs", "vlm_split"]


def vlm_split(cfg: ModelConfig, seq: int) -> Tuple[int, int]:
    """(n_patches, n_text) for a vlm sequence of total length ``seq``."""
    p = min(cfg.n_patches, seq // 2)
    return p, seq - p


def _vlm_positions(cfg: ModelConfig, batch: int, seq: int) -> np.ndarray:
    """M-RoPE position streams (3, batch, seq) int32: the patches get grid
    positions (0, i // side, i % side) with ``side = isqrt(P)``, and the
    text continues from ``side`` on all three streams."""
    p, t = vlm_split(cfg, seq)
    side = max(1, math.isqrt(p))
    pos = np.zeros((3, seq), np.int32)
    idx = np.arange(p)
    pos[1, :p] = idx // side
    pos[2, :p] = idx % side
    pos[:, p:] = (side + np.arange(t))[None, :]
    return np.broadcast_to(pos[:, None, :], (3, batch, seq))


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A batch of ``seq`` positions on the generator's device:

    * token families: ``tokens``, ``labels`` (batch, seq) int32, uniform
      over the vocab;
    * audio: ``frames`` (batch, seq, d_model) float32 N(0, 1) and labels;
    * vlm: ``tokens`` (batch, seq - P), ``patches`` (batch, P, d_model)
      float32 N(0, 1), ``positions`` (3, batch, seq) int32 and labels
      (batch, seq) that are -100 over the P patches (:func:`vlm_split`).

    The draws differ from ``jax.random``'s; the parity tests hand one
    numpy batch to both packages."""
    dev = generator.device
    kw = dict(generator=generator, device=dev, dtype=torch.int32)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    if cfg.family == "audio":
        return {"frames": normal((batch, seq, cfg.d_model)),
                "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                        **kw)}
    if cfg.family == "vlm":
        p, t = vlm_split(cfg, seq)
        tokens = torch.randint(0, cfg.vocab_size, (batch, t), **kw)
        labels = torch.randint(0, cfg.vocab_size, (batch, t), **kw)
        return {"tokens": tokens,
                "patches": normal((batch, p, cfg.d_model)),
                "positions": torch.from_numpy(np.ascontiguousarray(
                    _vlm_positions(cfg, batch, seq))).to(dev),
                "labels": torch.cat([torch.full((batch, p), -100,
                                                dtype=torch.int32,
                                                device=dev), labels], dim=1)}
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), **kw)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), **kw)
    return {"tokens": tokens, "labels": labels}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The train or prefill batch of ``shape`` (global batch B, sequence
    S) on the ``meta`` device, leaf for leaf as the reference's: tokens
    and labels (B, S) int32; audio frames (B, S, d_model) float32; vlm
    tokens (B, S - P), patches (B, P, d_model) float32, positions
    (3, B, S) int32 and labels (B, S)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "audio":
        return {"frames": spec((B, S, cfg.d_model), torch.float32),
                "labels": spec((B, S))}
    if cfg.family == "vlm":
        p, t = vlm_split(cfg, S)
        return {"tokens": spec((B, t)),
                "patches": spec((B, p, cfg.d_model), torch.float32),
                "positions": spec((3, B, S)),
                "labels": spec((B, S))}
    return {"tokens": spec((B, S)), "labels": spec((B, S))}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, init_cache
                 ) -> Tuple[Dict[str, torch.Tensor], Dict, torch.Tensor]:
    """(token specs, cache specs, pos spec) of one decode step of
    ``shape``: tokens (B, 1) int32, the cache ``init_cache(B, S,
    device="meta")`` gives (a family's ``init_cache(cfg, ...)`` with the
    config bound), and a 0-d int32 position, all on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    cache, _ = init_cache(B, S, device="meta")
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return {"tokens": tokens}, cache, pos

"""Input builders of the port: concrete batches for training and prefill.

The JAX package's ``launch/specs.py::make_batch`` for every family, drawn
from an explicit ``torch.Generator`` on the generator's device. The
audio and vlm families' frontends are stubs, as in the reference:
``frames`` and ``patches`` arrive as precomputed embeddings. The dry-run
stand-ins (``batch_specs``, ``decode_specs``) come with ROADMAP A11.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["make_batch", "vlm_split"]


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

"""Input builders of the port: concrete batches for prefill.

The JAX package's ``launch/specs.py::make_batch`` for the token families
(dense, moe, ssm and hybrid), drawn from an explicit ``torch.Generator`` on the
generator's device. The audio and vlm branches and the dry-run stand-ins
come with their families (ROADMAP A10b.6d, A11).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig

__all__ = ["make_batch"]


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int32, uniform over the vocab."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"make_batch for family {cfg.family!r} is "
                                  f"not ported yet (ROADMAP A10b.6)")
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), **kw)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), **kw)
    return {"tokens": tokens, "labels": labels}

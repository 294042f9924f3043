"""Deterministic, resumable synthetic data pipeline (numpy only).

A copy of the JAX package's ``data/pipeline.py``: ``batch_at(t)`` gives
the same bytes in both packages, which is what makes the replay after a
recovery exact in either one.

The pipeline is a pure function of (seed, step): batch t is generated
counter-based, so persisting just the *cursor* (one integer — the
paper's "flush the cache line containing i") makes data delivery exactly
resumable after a crash: a restarted run replays the identical token
stream with no out-of-band state. This is the data-side half of the
bitwise-reproducible-recovery guarantee the integration tests assert.

Content: Zipf-distributed token ids with injected copy/repeat structure
so small models actually have something learnable (loss visibly drops
in examples/train_e2e.py), labels = next-token shift.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig

__all__ = ["PipelineState", "SyntheticPipeline"]


@dataclasses.dataclass
class PipelineState:
    """The entire pipeline state — 3 integers. Tiny by construction."""

    seed: int
    step: int
    epoch: int = 0

    def as_array(self) -> np.ndarray:
        return np.array([self.seed, self.step, self.epoch], np.int64)

    @classmethod
    def from_array(cls, arr) -> "PipelineState":
        return cls(seed=int(arr[0]), step=int(arr[1]), epoch=int(arr[2]))


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.state = PipelineState(seed=seed, step=0)
        self.host_id = host_id
        self.n_hosts = n_hosts
        # Zipf-ish unigram distribution over the vocab
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    # -- counter-based batch generation ---------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        # independent stream per (seed, step, host): SeedSequence spawning
        ss = np.random.SeedSequence(
            entropy=self.state.seed,
            spawn_key=(step, self.host_id))
        return np.random.default_rng(ss)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step — the resumability property."""
        rng = self._rng_for(step)
        B = self.batch // self.n_hosts
        S = self.seq
        tokens = rng.choice(self.cfg.vocab_size, size=(B, S + 1),
                            p=self._probs).astype(np.int32)
        # inject copy structure: second half repeats the first half for a
        # random subset of rows (learnable signal)
        copy_rows = rng.random(B) < 0.5
        half = (S + 1) // 2
        tokens[copy_rows, half:2 * half] = tokens[copy_rows, :half]
        return {"tokens": tokens[:, :-1],
                "labels": tokens[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpoint integration --------------------------------------------------
    def cursor(self) -> np.ndarray:
        return self.state.as_array()

    def restore(self, arr) -> None:
        self.state = PipelineState.from_array(arr)

"""The general generator: inputs of every cell, from a traffic file's
parameters and ``--seed``.

A traffic file (``portbench/traffic/<name>.json``) names its ``driver``
(``train``) and the parameters read here and by the driver; a key that
nothing reads is refused (:func:`check_keys`), so that a knob never
changes a cell silently. The same seed gives the same inputs; different
seeds give the same sizes, so that the seed changes which tokens are
sent and not how much work a run holds.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def check_keys(d: Dict, allowed: Iterable[str], where: str) -> None:
    """Refuse the keys of ``d`` outside ``allowed``: parameters that
    nothing reads."""
    extra = sorted(set(d) - set(allowed))
    if extra:
        raise ValueError(f"{where}: {extra} read by nothing; the keys "
                         f"read are {sorted(allowed)}")


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        entropy=int(seed), spawn_key=tuple(int(k) for k in key)))


class TrainFeed:
    """Training batches: ``batch_at(step)`` -> {"tokens", "labels"} int32
    (batch, seq), a pure function of (seed, step). Token ids follow a Zipf
    law over the vocabulary (``tokens.exponent``), and a share of the rows
    (``tokens.copy_share``) repeats its first half in its second, as the
    program's own synthetic pipeline makes them, so the model has
    something to learn. Every row of every step differs."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        t = traffic["tokens"]
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.seed = int(seed)
        self.copy_share = t["copy_share"]
        w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** t["exponent"]
        self._cdf = np.cumsum(w / w.sum())

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, 1, step)
        B, S = self.batch, self.seq
        u = rng.random((B, S + 1))
        tokens = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                            len(self._cdf) - 1).astype(np.int32)
        half = (S + 1) // 2
        rows = rng.random(B) < self.copy_share
        tokens[rows, half:2 * half] = tokens[rows, :half]
        return {"tokens": np.ascontiguousarray(tokens[:, :-1]),
                "labels": np.ascontiguousarray(tokens[:, 1:])}

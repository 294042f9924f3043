"""ADCC for training state: the checksum ledger.

A copy of the JAX package's ``core/acc_state.py``: the same record, the
same JSON lines, the same constants, and lists that follow the
reference's leaves (one entry per *stacked* leaf, in ``jax.tree.leaves``
order; a stacked leaf's entry is the sum of the port's per-layer sums),
so a ledger written by either package validates in the other.

The paper flushes one cache line per iteration (the loop counter) and
reasons about everything else with algorithm invariants. The training
analogue persists a few-KB *ledger record* synchronously each step —

    {step, rng seed, data cursor, per-leaf f32 checksums of
     (params, opt state, applied updates), loss}

— while the heavy state goes to slots asynchronously with no fences
(core/slots.py). Two invariant levels at recovery, both paper-style:

1. **Ledger integrity** — the linearity chain
       cks_params[t] ≈ cks_params[t-1] + cks_updates[t]
   (optimizer updates are additive, so the per-tensor sums obey the same
   recurrence; paper Eq. 1/2 analogue: an internal relation that torn
   records cannot satisfy). Torn/partial tail records are discarded.

2. **Slot consistency** — a slot written at step t is accepted iff every
   leaf's recomputed f32 sum matches the ledger's record for step t
   (ABFT checksum verification, Eq. 6 analogue, at tensor granularity).

Records are single JSON lines; a torn append produces an unparsable or
chain-breaking tail line, which recovery skips — by construction the
ledger needs no fsync ordering with the slots.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import tracing
from ..models.carry import opt_tree, reference_tree, tree_items

__all__ = ["LedgerRecord", "ChecksumLedger", "flatten_checksums",
           "leaf_checksum", "verify_state_against_record"]


def flatten_checksums(tree) -> List[float]:
    """Deterministic (sorted-path) flattening of a checksum tree (nested
    dicts and NamedTuples of 0-d tensors), in the order of
    ``jax.tree.leaves``; one transfer from the device for all of them."""
    return torch.stack([x.to(torch.float32)
                        for _, x in tree_items(tree)]).tolist()


@dataclasses.dataclass
class LedgerRecord:
    step: int
    rng_seed: int
    cursor: List[int]
    cks_params: List[float]
    cks_opt: List[float]
    cks_updates: List[float]
    loss: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "LedgerRecord":
        return cls(**json.loads(line))


class ChecksumLedger:
    """Append-only per-step ledger with linearity-chain validation."""

    # |sum(p_t) - (sum(p_{t-1}) + sum(u_t))| <= CHAIN_RTOL * scale
    CHAIN_RTOL = 1e-3
    SLOT_RTOL = 1e-4
    SLOT_ATOL = 1e-2

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = None

    # -- write side -----------------------------------------------------------
    def append(self, rec: LedgerRecord) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a", buffering=1)
        self._fh.write(rec.to_json() + "\n")
        self._fh.flush()
        with tracing.span("adcc.fsync"):
            os.fsync(self._fh.fileno())  # the "CLFLUSH": a few KB, synchronous

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- read/verify side -----------------------------------------------------
    def read_all(self) -> List[LedgerRecord]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(LedgerRecord.from_json(line))
                except (json.JSONDecodeError, TypeError, KeyError):
                    break  # torn tail: discard the rest
        return out

    def validated_records(self) -> List[LedgerRecord]:
        """Drop any suffix that breaks the linearity chain (invariant 1)."""
        recs = self.read_all()
        good: List[LedgerRecord] = []
        for rec in recs:
            if good and rec.step == good[-1].step + 1 \
                    and len(rec.cks_params) == len(good[-1].cks_params):
                prev = np.asarray(good[-1].cks_params, np.float64)
                upd = np.asarray(rec.cks_updates, np.float64)
                cur = np.asarray(rec.cks_params, np.float64)
                scale = np.maximum(np.abs(cur), 1.0)
                if np.any(np.abs(cur - (prev + upd)) > self.CHAIN_RTOL * scale):
                    break  # chain broken: discard this record and the rest
            elif good and rec.step != good[-1].step + 1:
                break
            good.append(rec)
        return good

    def record_for_step(self, step: int) -> Optional[LedgerRecord]:
        for rec in reversed(self.validated_records()):
            if rec.step == step:
                return rec
        return None


def leaf_checksum(leaf) -> torch.Tensor:
    """f32 sum of a tensor, or the sum of the per-layer sums of a stacked
    leaf's list. A DTensor's is its global sum, on every rank (the
    shards' sums added over the ranks that split it)."""
    if isinstance(leaf, list):
        return torch.stack([leaf_checksum(x) for x in leaf]).sum()
    total = torch.sum(leaf.to(torch.float32))
    return total.full_tensor() if isinstance(total, DTensor) else total


def verify_state_against_record(lm, opt_state, rec: LedgerRecord,
                                rtol: float = None, atol: float = None
                                ) -> Tuple[bool, int]:
    """Invariant 2: recompute per-leaf sums of the LM's parameters and the
    optimizer state and compare with the ledger. Returns (ok, number of
    mismatching leaves)."""
    rtol = rtol if rtol is not None else ChecksumLedger.SLOT_RTOL
    atol = atol if atol is not None else ChecksumLedger.SLOT_ATOL
    cfg = lm.cfg
    trees = (reference_tree(cfg, dict(lm.named_parameters())),
             opt_tree(cfg, opt_state))
    sums = [leaf_checksum(x) for tree in trees for _, x in tree_items(tree)]
    got = np.asarray(torch.stack(sums).tolist(), np.float64)
    want = np.asarray(rec.cks_params + rec.cks_opt, np.float64)
    if got.shape != want.shape:
        return False, max(len(got), len(want))
    tol = atol + rtol * np.maximum(np.abs(want), 1.0)
    bad = int(np.sum(np.abs(got - want) > tol))
    return bad == 0, bad

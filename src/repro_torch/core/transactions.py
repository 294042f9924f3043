"""Undo-log transactions — the Intel PMEM (libpmemobj-style) baseline.

The paper's test case (5) uses the Intel NVM library's transaction
mechanism: before a tracked object is modified inside a transaction, its
old value is copied into a persistent undo log (log write + flush), the
modification is applied, and at commit the modified data is flushed and
the log discarded. On recovery, an open (uncommitted) transaction is
rolled back from the log, restoring the pre-transaction state.

This is the expensive path the paper measures at 4.3x (CG) / 5.5x (MM)
slowdown — every update pays old-value copy + two persist barriers.

Log integrity: every entry carries a checksum computed at append time
(libpmemobj stamps entries the same way). Recovery validates the log
oldest-to-newest and rejects everything from the first invalid entry on
— the *torn log-tail* rule: the log is sequential, so nothing after a
torn entry can be trusted. Because appends here are fenced (write +
flush charged per entry), every reachable crash leaves an intact log
and the rejection count is 0; the validator is the guard that makes
that a checked invariant rather than an assumption, and
tests/test_torn_crashes.py exercises the rejection path on a
hand-corrupted log.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .nvm import CrashEmulator
from .regions import PersistentRegion

__all__ = ["UndoLogTx", "TxManager", "RollbackReport"]


def _log_checksum(name: str, lo: int, hi: int, old: np.ndarray) -> int:
    h = zlib.crc32(name.encode())
    h = zlib.crc32(np.asarray([lo, hi], dtype=np.int64).tobytes(), h)
    return zlib.crc32(np.ascontiguousarray(old).tobytes(), h)


@dataclasses.dataclass(frozen=True)
class RollbackReport:
    """What rolling back an open transaction did."""

    entries_applied: int
    entries_rejected: int   # torn log-tail entries discarded unapplied


class UndoLogTx:
    """One transaction over a set of PersistentRegions."""

    def __init__(self, emu: CrashEmulator, tx_id: int):
        self._emu = emu
        self.tx_id = tx_id
        # persistent log: list of (region-name, lo, hi, old bytes, crc)
        self._log: List[Tuple[str, int, int, np.ndarray, int]] = []
        self._tracked: Dict[str, PersistentRegion] = {}
        self.committed = False

    def add(self, region: PersistentRegion) -> None:
        self._tracked[region.name] = region

    def snapshot(self, region: PersistentRegion, index=Ellipsis) -> None:
        """Copy-before-write: persist the old value of region[index] into
        the undo log. Charged as an NVM write of the old bytes plus the
        flush of the log entry (this is what makes PMEM transactions
        expensive for frequently-updated HPC arrays)."""
        from .regions import _flat_span

        lo, hi = _flat_span(region.shape, index)
        old = region._emu.truth_flat(region.name)[lo:hi].copy()
        self._log.append((region.name, lo, hi, old,
                          _log_checksum(region.name, lo, hi, old)))
        # log append is a persistent write + fence
        self._emu.store.stats.charge_write(old.nbytes, self._emu.cfg)
        self._emu.store.stats.charge_flush_issue(
            max(1, old.nbytes // self._emu.cfg.line_bytes), self._emu.cfg
        )

    def write(self, region: PersistentRegion, index, value) -> None:
        """Transactional store: snapshot old value, then write new."""
        self.snapshot(region, index)
        region[index] = value

    def commit(self) -> Dict[Tuple[str, int, int], int]:
        """Flush every region touched in the tx, then drop the log.

        Returns a crc32 per committed span, computed over the truth
        bytes the flush just persisted — the payload checksum recovery
        validates against the post-crash image so a media fault on a
        log-covered span cannot sail through silently (libpmemobj
        stamps committed object payloads the same way)."""
        crcs: Dict[Tuple[str, int, int], int] = {}
        for name, lo, hi, _old, _crc in self._log:
            self._emu.flush(name, lo, hi)
            span = self._emu.truth_flat(name)[lo:hi]
            crcs[(name, lo, hi)] = zlib.crc32(
                np.ascontiguousarray(span).tobytes())
        self._log.clear()
        self.committed = True
        return crcs

    def validate_log(self) -> int:
        """Index of the first invalid entry (== len(log) when the whole
        log checks out). The log is sequential, so entries past the
        first invalid one are unreachable — recovery must discard them
        (the torn log-tail rule)."""
        for k, (name, lo, hi, old, crc) in enumerate(self._log):
            if _log_checksum(name, lo, hi, old) != crc:
                return k
        return len(self._log)

    def rollback_after_crash(self) -> "RollbackReport":
        """Recovery path: validate the log, reject any torn tail, then
        apply the valid undo records (newest first) to the NVM image,
        restoring pre-transaction values.

        Re-entrant under nested crashes: each record routes through
        ``CrashEmulator.apply_undo`` (where the nested-crash trap can
        fire between records), and the log is cleared only after every
        record applied — a retry re-applies all of them, which is
        idempotent because undo records hold absolute old values."""
        valid = self.validate_log()
        rejected = len(self._log) - valid
        for name, lo, hi, old, _crc in reversed(self._log[:valid]):
            self._emu.apply_undo(name, lo, hi, old)
        self._log.clear()
        return RollbackReport(entries_applied=valid,
                              entries_rejected=rejected)

    # -- snapshot / fork ------------------------------------------------------
    def state_snapshot(self) -> Dict[str, object]:
        # log entries are write-once (old-value arrays are only ever
        # read after append), so a shallow list copy is a true capture
        return {"tx_id": self.tx_id, "committed": self.committed,
                "log": list(self._log)}

    @classmethod
    def from_state(cls, emu: CrashEmulator,
                   state: Dict[str, object]) -> "UndoLogTx":
        tx = cls(emu, state["tx_id"])
        tx._log = list(state["log"])
        tx.committed = state["committed"]
        return tx


class TxManager:
    """Issues transactions; remembers the open one for crash recovery.

    The undo log itself lives in NVM in a real PMEM system; we keep the
    entries in host memory but persist-charge every append, and replay
    them against the surviving NVM image on recovery — observationally
    equivalent for both cost and crash semantics.
    """

    def __init__(self, emu: CrashEmulator):
        self._emu = emu
        self._next_id = 0
        self.open_tx: UndoLogTx | None = None

    def begin(self) -> UndoLogTx:
        if self.open_tx is not None and not self.open_tx.committed:
            raise RuntimeError("nested transactions unsupported")
        tx = UndoLogTx(self._emu, self._next_id)
        self._next_id += 1
        self.open_tx = tx
        return tx

    def commit(self) -> Dict[Tuple[str, int, int], int]:
        assert self.open_tx is not None
        crcs = self.open_tx.commit()
        self.open_tx = None
        return crcs

    def recover(self) -> Optional[RollbackReport]:
        """Post-crash: roll back the open transaction, if any. Returns
        the :class:`RollbackReport` (truthy) if a rollback happened,
        ``None`` otherwise — so existing ``if mgr.recover():`` callers
        keep working while recovery code can see the torn-tail count."""
        if self.open_tx is not None and not self.open_tx.committed:
            report = self.open_tx.rollback_after_crash()
            self.open_tx = None
            return report
        return None

    # -- snapshot / fork ------------------------------------------------------
    def state_snapshot(self) -> Dict[str, object]:
        return {"next_id": self._next_id,
                "open_tx": (None if self.open_tx is None
                            else self.open_tx.state_snapshot())}

    def restore_state(self, state: Dict[str, object]) -> None:
        self._next_id = state["next_id"]
        self.open_tx = (None if state["open_tx"] is None
                        else UndoLogTx.from_state(self._emu,
                                                  state["open_tx"]))

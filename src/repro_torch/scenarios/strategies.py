"""Consistency strategies — *how* a run persists, behind one protocol.

A :class:`ConsistencyStrategy` observes the workload's step axis through
``before_step``/``after_step`` hooks and owns post-crash
:meth:`~ConsistencyStrategy.recover`. The registry covers the paper's
mechanism space:

  none                 no fault tolerance: crash => restart from scratch
  adcc                 algorithm-directed consistence (delegates the
                       flush policy and invariant-scan recovery to the
                       workload's ``adcc_*`` hooks — §III.B-D)
  undo_log             PMEM-style transactions over the critical regions
                       (wraps :class:`repro_torch.core.transactions.TxManager`)
  checkpoint_hdd       synchronous full-copy checkpoint to a hard drive
  checkpoint_nvm       ... to NVM (copy + cache flush)
  checkpoint_nvm_dram  ... on the heterogeneous NVM/DRAM system
                       (wrap :class:`repro_torch.core.checkpoint_baseline.CheckpointBaseline`)
  shadow_snapshot      copy-on-write shadow copy of the critical regions
                       + atomic root-pointer flip; recovery discards the
                       unflipped shadow (the kv-engine atomic-replace
                       design — beyond-paper, motivated by KV serving)

Per-interval variants are spelled ``"<name>@<k>"`` ("checkpoint_nvm@5"
checkpoints every 5 steps). Every strategy also exposes the *modeled*
per-persist-event cost (``modeled_step_seconds``) used by the paper's
runtime figures — see :mod:`repro_torch.scenarios.costmodel`.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.checkpoint_baseline import CheckpointBaseline
from ..core.nvm import NVMConfig
from ..core.transactions import TxManager
from . import costmodel
from .workloads import RecoveryResult, Workload, unknown_name_error

__all__ = [
    "ConsistencyStrategy",
    "NativeStrategy",
    "AdccStrategy",
    "UndoLogStrategy",
    "CheckpointStrategy",
    "ShadowSnapshotStrategy",
    "STRATEGIES",
    "register_strategy",
    "make_strategy",
    "strategy_names",
]


class ConsistencyStrategy:
    """Base: a no-op mechanism (also the "none"/native baseline)."""

    key: str = "none"
    wants_adcc: bool = False

    def __init__(self, interval: int = 1):
        if interval < 1:
            raise ValueError("interval must be >= 1")
        self.interval = int(interval)
        self.wl: Optional[Workload] = None

    @property
    def name(self) -> str:
        return self.key if self.interval == 1 else f"{self.key}@{self.interval}"

    def attach(self, workload: Workload) -> None:
        self.wl = workload

    # -- step hooks -------------------------------------------------------------
    def before_step(self, i: int) -> None:
        pass

    def after_step(self, i: int) -> None:
        pass

    # -- crash recovery ----------------------------------------------------------
    def recover(self, crash_step: int, torn: bool,
                survival=None) -> RecoveryResult:
        """Post-crash recovery. ``survival`` is the crash point's
        :class:`~repro_torch.core.backends.LineSurvival` (None for boundary
        and all-or-nothing torn crashes) — mechanisms with their own
        integrity machinery (the undo log's log validation) consume it;
        the base restart-from-scratch discards torn state wholesale."""
        self.wl.reset()
        return RecoveryResult(resume_step=0, restart_point=-1,
                              redo_steps=crash_step + 1,
                              steps_lost=crash_step + 1, from_scratch=True)

    # -- snapshot / fork ----------------------------------------------------------
    def snapshot(self) -> object:
        """Capture mid-run mechanism state (undo log, checkpoint area,
        commit counters) for the fork sweep engine. The base strategy —
        and ADCC, whose state lives entirely in the workload's regions —
        has nothing to carry."""
        return None

    def restore_snapshot(self, snap: object) -> None:
        """Reset to a :meth:`snapshot` taken on this attached instance."""

    # -- modeled cost -------------------------------------------------------------
    @classmethod
    def modeled_step_seconds(cls, profile: costmodel.StepCostProfile,
                             cfg: NVMConfig) -> float:
        return costmodel.mechanism_step_seconds(cls.key, profile, cfg)

    def modeled_overhead_seconds(self, profile: costmodel.StepCostProfile,
                                 cfg: NVMConfig, steps_run: int) -> float:
        """Total modeled mechanism cost of a run that executed
        ``steps_run`` steps — the ``overhead_seconds`` cell field,
        charged identically by full and measure-mode evaluation."""
        events = costmodel.persist_events(steps_run, self.interval,
                                          profile, self.wants_adcc)
        return events * self.modeled_step_seconds(profile, cfg)


class NativeStrategy(ConsistencyStrategy):
    key = "none"


class AdccStrategy(ConsistencyStrategy):
    """Algorithm-directed crash consistence: persistence and recovery
    are the workload's own (paper's central mechanism)."""

    key = "adcc"
    wants_adcc = True

    def __init__(self, interval: int = 1):
        if interval != 1:
            raise ValueError(
                "adcc cadence is algorithm-directed: configure it on the "
                "workload (e.g. xsbench flush_every_frac), not via @interval")
        super().__init__(interval)

    def before_step(self, i):
        self.wl.adcc_before_step(i)

    def after_step(self, i):
        self.wl.adcc_after_step(i)

    def recover(self, crash_step, torn, survival=None):
        return self.wl.adcc_recover(crash_step)


class UndoLogStrategy(ConsistencyStrategy):
    """One undo-log transaction per ``interval`` steps over the critical
    regions (copy-before-write at tx begin, flush at commit; a crash
    mid-interval rolls the open transaction back to its begin point)."""

    key = "undo_log"

    def __init__(self, interval: int = 1):
        super().__init__(interval)
        self._mgr: Optional[TxManager] = None
        self._last_commit: Optional[int] = None
        self._scalars: Dict[str, float] = {}
        self._commit_crcs: Dict = {}

    def attach(self, workload):
        super().attach(workload)
        # per-run state: a reused instance must not recover from a
        # previous run's commit point
        self._mgr = TxManager(workload.emu)
        self._last_commit = None
        self._scalars = {}
        self._commit_crcs = {}

    def before_step(self, i):
        if i % self.interval == 0:
            tx = self._mgr.begin()
            for region in self.wl.live_regions():
                tx.snapshot(region)

    def after_step(self, i):
        if (i + 1) % self.interval == 0:
            self._commit_crcs = self._mgr.commit()
            self._last_commit = i
            self._scalars = self.wl.scalar_state()

    def _validate_committed_spans(self) -> int:
        """Post-recovery integrity check: crc32 of every span the last
        commit covered, against the (possibly rolled-back) NVM image.
        Both recovery paths land those spans on exactly the last-commit
        state — rollback rewrites them from the undo records' absolute
        old values, the committed path leaves them as the flush left
        them — so a mismatch is a media fault, not ordinary crash
        damage. Reads are uncharged (``.nvm`` views): the rollback just
        touched these spans or they are resident from the commit, so the
        check rides the recovery's existing traffic."""
        by_name = {r.name: r for r in self.wl.live_regions()}
        bad = 0
        for (name, lo, hi), crc in self._commit_crcs.items():
            reg = by_name.get(name)
            if reg is None:
                continue
            span = reg.nvm.reshape(-1)[lo:hi]
            if zlib.crc32(np.ascontiguousarray(span).tobytes()) != crc:
                bad += 1
        return bad

    def recover(self, crash_step, torn, survival=None):
        report = self._mgr.recover()
        rolled_back = report is not None
        rejected = report.entries_rejected if rolled_back else 0
        if rolled_back:
            # the rollback mutated the NVM image after the crash reload:
            # re-sync program truth with the restored image
            self.wl.resync_from_nvm()
        crc_bad = self._validate_committed_spans()
        # torn_flagged: the mechanism positively identified inconsistent
        # post-crash state — an open (uncommitted) tx means the data it
        # covers may be torn, and the rollback discards it; a rejected
        # torn log-tail is the same signal at the log level
        info = {"rolled_back": rolled_back,
                "log_entries_rejected": rejected,
                "payload_crc_mismatches": crc_bad,
                "torn_flagged": rolled_back or rejected > 0}
        if self._last_commit is None:
            self.wl.reset()
            return RecoveryResult(resume_step=0, restart_point=-1,
                                  redo_steps=crash_step + 1,
                                  steps_lost=crash_step + 1,
                                  from_scratch=True, info=info)
        self.wl.restore(None, self._scalars, self._last_commit)
        resume = self._last_commit + 1
        return RecoveryResult(
            resume_step=resume, restart_point=self._last_commit,
            redo_steps=crash_step + 1 - resume,
            steps_lost=crash_step - self._last_commit, info=info)

    def snapshot(self):
        return {"last_commit": self._last_commit,
                "scalars": dict(self._scalars),
                "commit_crcs": dict(self._commit_crcs),
                "mgr": self._mgr.state_snapshot()}

    def restore_snapshot(self, snap):
        self._last_commit = snap["last_commit"]
        self._scalars = dict(snap["scalars"])
        self._commit_crcs = dict(snap["commit_crcs"])
        self._mgr.restore_state(snap["mgr"])


class CheckpointStrategy(ConsistencyStrategy):
    """Synchronous full-copy checkpoint every ``interval`` steps."""

    key = "checkpoint_nvm"
    target = "nvm_only"

    def __init__(self, interval: int = 1):
        super().__init__(interval)
        self._base: Optional[CheckpointBaseline] = None
        self._last_ckpt: Optional[int] = None
        self._scalars: Dict[str, float] = {}

    def attach(self, workload):
        super().attach(workload)
        # per-run state: a reused instance must not recover from a
        # previous run's checkpoint step
        self._base = CheckpointBaseline(workload.emu, self.target)
        self._last_ckpt = None
        self._scalars = {}

    def after_step(self, i):
        if (i + 1) % self.interval == 0:
            self._base.checkpoint(i, self.wl.live_regions())
            self._last_ckpt = i
            self._scalars = self.wl.scalar_state()

    def recover(self, crash_step, torn, survival=None):
        if self._last_ckpt is None:
            self.wl.reset()
            return RecoveryResult(resume_step=0, restart_point=-1,
                                  redo_steps=crash_step + 1,
                                  steps_lost=crash_step + 1,
                                  from_scratch=True)
        arrays = self._base.restore()
        self.wl.restore(arrays, self._scalars, self._last_ckpt)
        resume = self._last_ckpt + 1
        return RecoveryResult(
            resume_step=resume, restart_point=self._last_ckpt,
            redo_steps=crash_step + 1 - resume,
            steps_lost=crash_step - self._last_ckpt)

    def snapshot(self):
        return {"last_ckpt": self._last_ckpt,
                "scalars": dict(self._scalars),
                "base": self._base.state_snapshot()}

    def restore_snapshot(self, snap):
        self._last_ckpt = snap["last_ckpt"]
        self._scalars = dict(snap["scalars"])
        self._base.restore_state(snap["base"])


class CheckpointHddStrategy(CheckpointStrategy):
    key = "checkpoint_hdd"
    target = "hdd"


class CheckpointNvmDramStrategy(CheckpointStrategy):
    key = "checkpoint_nvm_dram"
    target = "nvm_dram"


class ShadowSnapshotStrategy(ConsistencyStrategy):
    """Copy-on-write shadow snapshot + atomic root-pointer flip every
    ``interval`` steps (the kv-engine atomic-replace design).

    Two snapshot slots alternate: a persist event copies the critical
    regions into the *staging* slot — sharing (not recopying) any region
    whose truth epoch is unchanged since the active snapshot, which is
    what makes this cheaper than a full checkpoint on workloads with
    cold regions (a KV store's untouched value extents) — then flips the
    root pointer to the staging slot with one persisted 8-byte write.
    A crash mid-copy loses nothing: the root still points at the old
    slot, and recovery simply discards the unflipped shadow."""

    key = "shadow_snapshot"

    def __init__(self, interval: int = 1):
        super().__init__(interval)
        self._slots: List[Optional[Dict[str, object]]] = [None, None]
        self._active: int = -1       # root pointer; -1 = never flipped

    def attach(self, workload):
        super().attach(workload)
        # per-run state: a reused instance must not recover from a
        # previous run's snapshot
        self._slots = [None, None]
        self._active = -1

    def after_step(self, i):
        if (i + 1) % self.interval:
            return
        emu = self.wl.emu
        cfg, stats = emu.cfg, emu.stats
        prev = self._slots[self._active] if self._active >= 0 else None
        arrays: Dict[str, object] = {}
        epochs: Dict[str, int] = {}
        for r in self.wl.live_regions():
            e = emu.truth_epoch(r.name)
            if prev is not None and prev["epochs"].get(r.name) == e:
                # unchanged since the active snapshot: share its copy
                arrays[r.name] = prev["arrays"][r.name]
            else:
                data = r.view.copy()
                # copy into the shadow area = source cache flush + NVM
                # write (the checkpoint_nvm charging model)
                self.wl.emu.flush(r.name)
                stats.charge_write(data.nbytes, cfg)
                arrays[r.name] = data
            epochs[r.name] = e
        staging = 1 - self._active if self._active >= 0 else 0
        self._slots[staging] = {"arrays": arrays,
                                "scalars": dict(self.wl.scalar_state()),
                                "step": i, "epochs": epochs}
        # the atomic commit: one persisted root-pointer write
        stats.charge_write(8, cfg)
        stats.charge_flush_issue(1, cfg)
        self._active = staging

    def recover(self, crash_step, torn, survival=None):
        # any half-written staging slot is simply discarded: the root
        # pointer only ever references a fully-persisted snapshot
        discarded = (self._slots[1 - self._active] is not None
                     if self._active >= 0 else self._slots[0] is not None)
        info = {"shadow_discarded": discarded}
        if self._active < 0:
            self.wl.reset()
            return RecoveryResult(resume_step=0, restart_point=-1,
                                  redo_steps=crash_step + 1,
                                  steps_lost=crash_step + 1,
                                  from_scratch=True, info=info)
        slot = self._slots[self._active]
        cfg, stats = self.wl.emu.cfg, self.wl.emu.stats
        for data in slot["arrays"].values():
            stats.charge_read(data.nbytes, cfg)
        self.wl.restore(dict(slot["arrays"]), dict(slot["scalars"]),
                        slot["step"])
        resume = slot["step"] + 1
        return RecoveryResult(
            resume_step=resume, restart_point=slot["step"],
            redo_steps=crash_step + 1 - resume,
            steps_lost=crash_step - slot["step"], info=info)

    def snapshot(self):
        # slots are replaced wholesale (never mutated in place), so a
        # shallow copy of the slot list is a true capture
        return {"slots": list(self._slots), "active": self._active}

    def restore_snapshot(self, snap):
        self._slots = list(snap["slots"])
        self._active = snap["active"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

STRATEGIES: Dict[str, Callable[..., ConsistencyStrategy]] = {
    "none": NativeStrategy,
    "adcc": AdccStrategy,
    "undo_log": UndoLogStrategy,
    "checkpoint_hdd": CheckpointHddStrategy,
    "checkpoint_nvm": CheckpointStrategy,
    "checkpoint_nvm_dram": CheckpointNvmDramStrategy,
    "shadow_snapshot": ShadowSnapshotStrategy,
}


def register_strategy(name: str,
                      factory: Callable[..., ConsistencyStrategy], *,
                      override: bool = False) -> None:
    """Register a strategy factory under ``name``.

    Re-registering an existing name raises (a silent overwrite would
    make every subsequent sweep spec mean something else) unless the
    factory is identical (idempotent re-import) or ``override=True``.
    """
    if not override and name in STRATEGIES and STRATEGIES[name] is not factory:
        raise ValueError(
            f"strategy {name!r} already registered "
            f"(registered: {strategy_names()}); pass override=True "
            f"to replace it")
    STRATEGIES[name] = factory


def strategy_names() -> List[str]:
    return sorted(STRATEGIES)


def make_strategy(spec) -> ConsistencyStrategy:
    """spec: instance | "name" | "name@interval" (e.g. "checkpoint_nvm@5")."""
    if isinstance(spec, ConsistencyStrategy):
        return spec
    name, _, interval = str(spec).partition("@")
    if name not in STRATEGIES:
        raise unknown_name_error("strategy", name, STRATEGIES)
    return STRATEGIES[name](interval=int(interval)) if interval \
        else STRATEGIES[name]()

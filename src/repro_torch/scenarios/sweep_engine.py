"""Prefix-sharing fork engine for crash-point sweeps.

All crash points of one (workload, strategy) pair share an identical
execution prefix — re-running it per cell is what made dense
recompute-vs-crash-point curves (paper figs 3/7/10-12, EasyCrash-style
batches of thousands of crash instances) O(cells × full run). This
engine is the WITCHER-style record/fork alternative: run the pair
forward ONCE, capture a snapshot at the sorted union of every plan's
crash points, then evaluate each cell by restoring its snapshot —
crash, recover, and execute only the tail. Cost per cell drops from
O(setup + prefix + tail) to O(restore + tail).

Snapshots capture the whole observable state: the emulator (truth
arrays, NVM image, volatile-cache occupancy/dirtiness/recency, traffic
stats incl. the float ``modeled_seconds``), host-side workload scalars,
and mechanism state (open undo-log transaction, checkpoint area, commit
counters). A forked tail therefore replays the exact trace the rerun
engine's tail would, and cells come out identical field-for-field
(``wall_seconds`` aside) — enforced by tests/test_scenarios.py and the
``sweep_timing`` benchmark's divergence check.

Correctness requirement: ``Workload.step(i)`` must be deterministic in
(state, i) — true for all three adapters (XSBench sampling is
counter-based SplitMix64 precisely so restarted runs replay the same
lookups, matching the paper's methodology).

Dense ladders (measure mode snapshots EVERY step) can outgrow RAM on
big workloads, so the snapshot dictionary optionally runs under an LRU
byte budget (:class:`SnapshotTier`, ``sweep(snapshot_budget_bytes=...)``
or ``REPRO_SNAPSHOT_BUDGET``). Over budget, the least-recently-used
snapshot's heavy payload is evicted under one of two policies:

  policy="spill"     serialize the payload to a per-run tempdir and
                     reload it byte-identical on the next access;
  policy="recompute" drop the payload and, on the next access, re-run
                     the golden prefix from the nearest retained
                     boundary snapshot (the pinned pre-step-0 snapshot
                     is the tier-0 root that always remains).

Either way the per-key metadata (step timings, footprint) stays
resident, the pinned pre-step-0 / completed-run snapshots are never
evicted, and every evaluated cell is byte-identical to the unbudgeted
sweep (tests/test_snapshot_tiering.py pins this cell-for-cell).
:class:`SnapshotTierStats` counts hits/spills/reloads/recomputes/bytes
and rides the results as ``info["snapshot_tier"]``.

Not public API — use ``repro_torch.scenarios.sweep(engine="fork")``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .crashplan import CrashPlan, CrashPoint
from .driver import ScenarioResult, _digests_equal, _finish, _measure
from .strategies import ConsistencyStrategy
from .workloads import Workload

__all__ = ["run_pair_forked", "SnapshotTier", "SnapshotTierStats",
           "SNAPSHOT_POLICIES"]

SNAPSHOT_POLICIES = ("spill", "recompute")


class _CellSnapshot:
    """State at one potential crash position, plus the timing of its
    (possibly partial — torn) final step."""

    __slots__ = ("wl_snap", "strat_snap", "wall_last", "modeled_last")

    def __init__(self, wl: Workload, strat: ConsistencyStrategy,
                 wall_last: float, modeled_last: float):
        self.wl_snap = wl.snapshot()
        self.strat_snap = strat.snapshot()
        self.wall_last = wall_last
        self.modeled_last = modeled_last

    @classmethod
    def from_parts(cls, wl_snap, strat_snap, wall_last: float,
                   modeled_last: float) -> "_CellSnapshot":
        """Reassemble from an already-captured payload (tier reload /
        recompute) without re-snapshotting the live workload."""
        snap = cls.__new__(cls)
        snap.wl_snap = wl_snap
        snap.strat_snap = strat_snap
        snap.wall_last = wall_last
        snap.modeled_last = modeled_last
        return snap

    def restore(self, wl: Workload, strat: ConsistencyStrategy) -> None:
        wl.restore_snapshot(self.wl_snap)
        strat.restore_snapshot(self.strat_snap)


def _payload_nbytes(obj) -> int:
    """Nominal byte footprint of a snapshot payload: the sum of every
    ndarray's nbytes in the nested dict/sequence/dataclass structure.
    Copy-on-write sharing across ladder snapshots is deliberately NOT
    discounted — the budget bounds what one restore materializes, and
    double-counting shared arrays only makes eviction conservative."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_payload_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_payload_nbytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_payload_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _freeze_arrays(obj) -> None:
    """Re-mark a reloaded payload's arrays read-only — pickle does not
    round-trip the writeable flag, and live snapshots are immutable by
    contract (nvm.EmuSnapshot)."""
    if isinstance(obj, np.ndarray):
        if obj.flags.owndata:
            obj.flags.writeable = False
        return
    if isinstance(obj, dict):
        for v in obj.values():
            _freeze_arrays(v)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _freeze_arrays(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _freeze_arrays(getattr(obj, f.name))


@dataclasses.dataclass
class SnapshotTierStats:
    """One pair's snapshot-tier bookkeeping. Attached to every cell of
    the pair as ``info["snapshot_tier"]`` (info is excluded from cell
    dicts, so the stats never perturb engine-identity gates) and
    surfaced by the ``sweep_timing`` benchmark into BENCH_sweep.json."""

    policy: str = "spill"
    budget_bytes: int = 0
    hits: int = 0                  # payload was resident on access
    spills: int = 0                # payloads serialized to disk
    reloads: int = 0               # payloads deserialized back
    recomputes: int = 0            # payloads re-derived by prefix replay
    spilled_bytes: int = 0         # total bytes written to the spill dir
    resident_bytes: int = 0        # current in-RAM payload footprint
    resident_peak_bytes: int = 0   # high-water mark of resident_bytes

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class _TierEntry:
    __slots__ = ("payload", "wall_last", "modeled_last", "footprint",
                 "pinned", "path")


class SnapshotTier:
    """LRU byte-budget over the fork/measure snapshot ladder.

    Keys are the engine's ``(step, torn)`` snapshot positions. The
    heavy payload — the (workload, strategy) snapshot pair — is what
    the budget governs; per-key metadata (step timings, footprint)
    always stays resident, so an evicted key is still *known*, just
    not materialized. ``policy="spill"`` serializes evicted payloads
    to a per-run tempdir and reloads them byte-identical;
    ``policy="recompute"`` drops them and re-derives on miss through
    the ``regen`` callback (the engine's golden-prefix replay from the
    nearest retained boundary). Pinned keys — the pre-step-0 tier-0
    snapshot and the completed-run state — are never evicted: they are
    the recompute roots everything else can be re-derived from."""

    def __init__(self, budget_bytes: int, policy: str = "spill"):
        if policy not in SNAPSHOT_POLICIES:
            raise ValueError(f"unknown snapshot policy {policy!r}; "
                             f"choose from {SNAPSHOT_POLICIES}")
        self._budget = max(0, int(budget_bytes))
        self._policy = policy
        self._entries: "OrderedDict" = OrderedDict()
        self._regen: Optional[Callable] = None
        self._dir: Optional[str] = None
        self._seq = 0
        self.stats = SnapshotTierStats(policy=policy,
                                       budget_bytes=self._budget)

    def set_regen(self, fn: Callable) -> None:
        """Install the recompute-on-miss callback ``key -> (wl_snap,
        strat_snap)`` (the engine builds it after the golden pass)."""
        self._regen = fn

    def put(self, key, snap: _CellSnapshot, pin: bool = False) -> None:
        entry = _TierEntry()
        entry.payload = (snap.wl_snap, snap.strat_snap)
        entry.wall_last = snap.wall_last
        entry.modeled_last = snap.modeled_last
        entry.footprint = _payload_nbytes(entry.payload)
        entry.pinned = pin
        entry.path = None
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._admit(entry.footprint)
        self._shrink()

    def get(self, key) -> Optional[_CellSnapshot]:
        """The snapshot at ``key`` (None if never captured), reloading
        or recomputing an evicted payload transparently."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        if entry.payload is not None:
            self.stats.hits += 1
        elif entry.path is not None:
            with open(entry.path, "rb") as fh:
                entry.payload = pickle.load(fh)
            _freeze_arrays(entry.payload)
            self.stats.reloads += 1
            self._admit(entry.footprint)
            self._shrink(keep=key)
        else:
            if self._regen is None:
                raise RuntimeError(
                    f"snapshot {key} was evicted and no regenerator is "
                    f"installed (engine bug)")
            entry.payload = tuple(self._regen(key))
            self.stats.recomputes += 1
            self._admit(entry.footprint)
            self._shrink(keep=key)
        wl_snap, strat_snap = entry.payload
        return _CellSnapshot.from_parts(wl_snap, strat_snap,
                                        entry.wall_last, entry.modeled_last)

    def nearest_boundary(self, bound: int) -> Tuple[int, bool]:
        """Greatest *materialized* (resident or spilled) boundary key
        ``(s, False)`` with ``s <= bound`` — the replay root a
        recompute-on-miss restores from. The pinned pre-step-0
        snapshot guarantees one always exists."""
        best = -1
        for (s, torn), entry in self._entries.items():
            if torn or s is None or s > bound or s <= best:
                continue
            if entry.payload is None and entry.path is None:
                continue
            best = s
        return (best, False)

    def close(self) -> None:
        """Delete the spill directory (idempotent)."""
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    # -- internals ---------------------------------------------------------

    def _admit(self, nbytes: int) -> None:
        self.stats.resident_bytes += nbytes
        self.stats.resident_peak_bytes = max(self.stats.resident_peak_bytes,
                                             self.stats.resident_bytes)

    def _shrink(self, keep=None) -> None:
        """Evict LRU-first until the resident payload footprint fits
        the budget. ``keep`` (the key being returned right now) and
        pinned keys are skipped."""
        if self.stats.resident_bytes <= self._budget:
            return
        for key in list(self._entries):
            if self.stats.resident_bytes <= self._budget:
                break
            entry = self._entries[key]
            if entry.pinned or entry.payload is None or key == keep:
                continue
            if self._policy == "spill" and entry.path is None:
                # a payload spilled once never needs rewriting —
                # snapshots are immutable, so the file stays valid
                # across any number of reload/evict cycles
                entry.path = self._spill_path()
                with open(entry.path, "wb") as fh:
                    pickle.dump(entry.payload, fh,
                                protocol=pickle.HIGHEST_PROTOCOL)
                self.stats.spills += 1
                self.stats.spilled_bytes += os.path.getsize(entry.path)
            entry.payload = None
            self.stats.resident_bytes -= entry.footprint

    def _spill_path(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="repro-snaptier-")
        self._seq += 1
        return os.path.join(self._dir, f"snap{self._seq:06d}.pkl")


def _make_regen(tier: SnapshotTier, wl: Workload,
                strat: ConsistencyStrategy) -> Callable:
    """Recompute-on-miss for one pair: restore the nearest retained
    boundary snapshot and re-run the golden prefix up to the evicted
    key's position. ``Workload.step`` is deterministic in (state, i)
    and boundary snapshots carry the traffic stats, so the recomputed
    payload is byte-identical to the evicted one (pinned by
    tests/test_snapshot_tiering.py)."""
    n = wl.n_steps

    def regen(key):
        step, torn = key
        bound = (n - 1) if step is None else step - 1
        root_key = tier.nearest_boundary(bound)
        tier.get(root_key).restore(wl, strat)
        # full steps up to the key's position; a torn key stops inside
        # its final step, before the strategy's persistence hook
        last_full = (n - 1) if step is None else (step - 1 if torn
                                                  else step)
        for i in range(root_key[0] + 1, last_full + 1):
            strat.before_step(i)
            wl.step(i)
            strat.after_step(i)
        if torn:
            strat.before_step(step)
            wl.step(step)
        return wl.snapshot(), strat.snapshot()

    return regen


def run_pair_forked(wl: Workload, strat: ConsistencyStrategy,
                    grounded: Sequence[Tuple[CrashPlan, List[CrashPoint]]],
                    progress=None, mode: str = "full",
                    snapshot_budget_bytes: Optional[int] = None,
                    snapshot_policy: str = "spill") -> List[ScenarioResult]:
    """Evaluate every cell of one set-up (workload, strategy) pair.

    ``grounded`` is the pre-resolved [(plan, [CrashPoint...]), ...] for
    this pair. Returns ScenarioResults in plan-major, point-minor order
    — the same order the rerun engine emits.

    ``mode="measure"`` evaluates each crashed cell as restore + crash +
    recover only — the recompute/restart fields are computed from the
    recovered state instead of executing the tail and ``finalize()``
    (see :func:`repro_torch.scenarios.driver._measure`), dropping the
    per-cell cost from O(restore + tail) to O(restore + recover).
    no_crash cells always take the full path (it is already tail-free).

    Measure mode additionally captures a boundary snapshot at EVERY
    executed step (not just the wanted crash points): a recovered
    cell's restart point can land anywhere in the prefix, and the
    byte-certification closure (``state_certified``) needs the golden
    digest at exactly that step. Copy-on-write snapshots keep the
    ladder O(changed state) per step.

    ``snapshot_budget_bytes`` caps the ladder's resident footprint
    through a :class:`SnapshotTier` with the given ``snapshot_policy``
    (module docstring); the final tier stats ride every cell as
    ``info["snapshot_tier"]``. ``None`` (default) keeps the plain
    unbounded dictionary.
    """
    strat.attach(wl)
    emu = wl.emu
    n = wl.n_steps

    # the union of snapshot positions all plans need; (None, False) is
    # the completed-run state no_crash cells finalize from
    want = set()
    for _plan, points in grounded:
        for p in points:
            want.add((p.step, p.torn) if p.step is not None
                     else (None, False))

    # -- golden forward pass: one shared prefix execution -----------------
    need_full = (None, False) in want
    ladder = mode == "measure"   # boundary snapshot every step (certify)
    last_point = max((s for s, _ in want if s is not None), default=-1)
    snaps: Dict[Tuple[Optional[int], bool], _CellSnapshot] = {}
    tier: Optional[SnapshotTier] = None
    if snapshot_budget_bytes is not None:
        tier = SnapshotTier(snapshot_budget_bytes, snapshot_policy)

    def snap_put(key, snap: _CellSnapshot, pin: bool = False) -> None:
        if tier is None:
            snaps[key] = snap
        else:
            tier.put(key, snap, pin=pin)

    def snap_get(key) -> Optional[_CellSnapshot]:
        if tier is None:
            return snaps.get(key)
        return tier.get(key)

    wall: List[float] = []
    modeled: List[float] = []
    if ladder or tier is not None:
        # pre-step-0 snapshot: the golden state a scratch restart
        # (restart_point == -1) must reproduce — certifies that
        # ``Workload.reset()`` actually restores initial-state fidelity.
        # With a tier it is additionally the pinned tier-0 root every
        # recompute-on-miss can replay from
        snap_put((-1, False), _CellSnapshot(wl, strat, 0.0, 0.0), pin=True)
    for i in range(n):
        ts = time.perf_counter()
        m0 = emu.modeled_seconds()
        strat.before_step(i)
        wl.step(i)
        if (i, True) in want:   # torn: before the persistence hook
            torn_wall = time.perf_counter() - ts
            snap_put((i, True), _CellSnapshot(
                wl, strat, torn_wall, emu.modeled_seconds() - m0))
            # keep capture cost out of the step's recorded duration
            ts = time.perf_counter() - torn_wall
        strat.after_step(i)
        wall.append(time.perf_counter() - ts)
        modeled.append(emu.modeled_seconds() - m0)
        if (i, False) in want or ladder:
            snap_put((i, False), _CellSnapshot(wl, strat, wall[-1],
                                               modeled[-1]))
        if not need_full and i == last_point:
            break   # no plan needs the completed-run state
    if need_full:
        # captured BEFORE any finalize(): finalize may charge traffic
        # (CG reads z), and each no_crash cell must pay it exactly once
        snap_put((None, False), _CellSnapshot(wl, strat, 0.0, 0.0),
                 pin=True)
    if tier is not None:
        tier.set_regen(_make_regen(tier, wl, strat))

    def certify(rec) -> Optional[bool]:
        """Byte-certification: diff the recovered state's digest against
        the golden-prefix digest at the restart point. May leave ``wl``
        restored to the golden state — callers restore per cell."""
        r = rec.restart_point
        if r is None:
            return None
        if r < 0:
            r = -1               # scratch: certify against pre-step-0
        # the recovered digest FIRST: fetching the golden snapshot may
        # replay the prefix on ``wl`` (tier recompute-on-miss), which
        # would clobber the recovered state we are certifying
        recovered = wl.restart_digest(r)
        if recovered is None:
            return None
        golden_snap = snap_get((r, False))
        if golden_snap is None:
            return None
        wl.restore_snapshot(golden_snap.wl_snap)
        return _digests_equal(recovered, wl.restart_digest(r))

    # -- fork one cell per (plan, point) ----------------------------------
    results: List[ScenarioResult] = []
    for plan, points in grounded:
        for point in points:
            t0 = time.perf_counter()
            if point.step is None:
                snap = snap_get((None, False))
                snap.restore(wl, strat)
                res = _finish(wl, strat, point, plan.describe(),
                              recover=True, crashed=False,
                              wall_durs=wall, modeled_durs=modeled, t0=t0)
            else:
                snap = snap_get((point.step, point.torn))
                snap.restore(wl, strat)
                # prefix timings come from the golden run; the last
                # step's entry is partial for torn crashes, matching
                # what the rerun engine's broken-off loop records
                s = point.step
                durs = dict(wall_durs=wall[:s] + [snap.wall_last],
                            modeled_durs=modeled[:s] + [snap.modeled_last])
                if mode == "measure":
                    res = _measure(wl, strat, point, plan.describe(),
                                   t0=t0, certify=certify, **durs)
                else:
                    res = _finish(wl, strat, point, plan.describe(),
                                  recover=True, crashed=True, t0=t0, **durs)
            results.append(res)
            if progress is not None:
                progress(res)
    if tier is not None:
        tier_info = tier.stats.to_dict()
        for res in results:
            res.info["snapshot_tier"] = tier_info
        tier.close()
    return results

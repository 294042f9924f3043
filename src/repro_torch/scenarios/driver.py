"""Scenario driver: one loop that runs any Workload under any
ConsistencyStrategy against any CrashPlan, and a batched sweep.

``run_scenario`` is the uniform experiment harness the paper's
per-algorithm drivers used to hand-roll: set up, step, optionally crash
(at a step boundary, or *torn* — inside the boundary, before the
strategy's persistence hook; with a ``TornSpec`` the torn crash also
persists a seeded subset of the dirty cache lines, see
repro_torch.scenarios.crashplan), recover through the strategy, resume, and
report a :class:`ScenarioResult` with overhead / recompute / correctness
/ traffic fields that mean the same thing in every cell. Line-survival
cells carry the extended ``torn_detected`` / ``torn_corrupt``
correctness classes (:func:`classify_recovery`).

``sweep`` expands a workloads × strategies × crash-plans matrix
(seeded ``random`` plans contribute one cell per sampled crash point),
runs every cell on the vectorized emulation backend, and optionally
writes the ``BENCH_scenarios.json`` artifact. Two execution engines:

  engine="fork"  (default) the prefix-sharing engine in
                 :mod:`repro_torch.scenarios.sweep_engine`: each (workload,
                 strategy) pair runs forward ONCE, snapshots are
                 captured at the union of the plans' crash points, and
                 every cell forks from its snapshot — crash, recover,
                 run only the tail. O(tail) per cell.
  engine="rerun" the from-scratch baseline: every cell re-executes its
                 whole prefix on a fresh workload. O(full run) per
                 cell; kept as the oracle the fork engine must match
                 cell-for-cell (tests/benchmarks enforce it).

Orthogonal to the engine, two execution *modes*:

  mode="full"    (default) every crashed cell recovers, re-executes the
                 tail, and runs ``finalize()`` — the complete
                 ScenarioResult including end-of-run correctness,
                 metrics, and traffic.
  mode="measure" the EasyCrash/WITCHER crash-image-inspection shape:
                 crashed cells stop after strategy recovery and
                 *compute* the recompute-cost and correctness-class
                 fields from the recovered state + the cost model —
                 no tail execution, no ``finalize()``. Each crashed
                 cell costs O(restore + recover) instead of O(tail),
                 which is what makes exhaustive dense sweeps
                 (``CrashPlan.at_every_step()`` over every strategy)
                 cheap. Measured cells omit the fields only a full run
                 defines (:data:`FULL_RUN_FIELDS`); every field they DO
                 emit is identical to the full-execution cell
                 (``measure_divergence_fields`` is the checker; tests
                 and the ``sweep_timing`` CI gate enforce it).
                 ``no_crash`` cells always run full (their "tail" is
                 empty, so finalize is the only cost).

``workers=N`` shards the (workload, strategy) pairs of a sweep across
N processes — pairs are fully independent (fork-engine snapshots are
per-emulator), results merge back in deterministic pair-major order,
and ``workers=1`` is byte-identical to the serial path.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.nvm import NestedCrashFault, NVMConfig
from ..device import selected_device, use_device
from ..kernels import launch_counts
from .crashplan import CrashPlan, CrashPoint
from .strategies import STRATEGIES, ConsistencyStrategy, make_strategy
from .workloads import (WORKLOADS, Workload, make_workload,
                        unknown_name_error)

__all__ = ["ScenarioResult", "run_scenario", "sweep", "DEFAULT_SWEEP_PLANS",
           "AVG_STEP_JITTER_FLOOR", "SWEEP_ENGINES", "SWEEP_MODES",
           "WALL_CLOCK_FIELDS", "FULL_RUN_FIELDS", "FORK_ONLY_FIELDS",
           "deterministic_cell_dict", "measure_divergence_fields",
           "classify_recovery", "shard_launches"]

# Below this measured mean step wall-time, per-step timing is dominated
# by timer resolution / interpreter jitter, so ``avg_step_seconds``
# falls back to the emulator's deterministic modeled per-step cost
# (which also makes fork- and rerun-engine results comparable bit for
# bit at smoke sizes).
AVG_STEP_JITTER_FLOOR = 1e-3

SWEEP_ENGINES = ("fork", "rerun")
SWEEP_MODES = ("full", "measure", "batched")

# Kernel launches made by the workers of the last ``sweep(workers>1)``,
# summed over its shards by kernel name: the parent's own counters never
# see a launch made in a child process.
shard_launches: Dict[str, int] = {}

# ScenarioResult fields derived from host wall-clock measurement.
# Everything else is deterministic — modeled seconds, traffic counts,
# recompute/restart bookkeeping, correctness — and must come out
# IDENTICAL from both sweep engines (tests + the sweep_timing
# benchmark's divergence gate enforce it). avg_step_seconds /
# resume_seconds are wall-derived only above AVG_STEP_JITTER_FLOOR,
# but whether the floor triggers is itself a wall-clock fact, so the
# engine-invariance contract excludes all three.
WALL_CLOCK_FIELDS = ("wall_seconds", "avg_step_seconds", "resume_seconds")

# ScenarioResult fields only a FULL execution (tail replay + finalize)
# defines: end-of-run correctness/metrics, end-of-run traffic counters,
# and the emulator's total modeled seconds. mode="measure" cells stop
# at strategy recovery, set these to None, and ``to_json_dict`` omits
# them — so a measured cell dict is a strict subset of the full cell
# dict, equal on every shared deterministic field.
FULL_RUN_FIELDS = ("correct", "metrics", "traffic", "modeled_total_seconds")

# Fields only the FORK engine can compute: byte-certification diffs the
# recovered state against the golden-prefix snapshot at the restart
# point, and only the fork engine holds those snapshots. Excluded from
# the engine-invariance contract the same way wall-clock fields are.
FORK_ONLY_FIELDS = ("state_certified",)


def deterministic_cell_dict(res: "ScenarioResult") -> Dict[str, Any]:
    """``to_json_dict`` minus :data:`WALL_CLOCK_FIELDS` and
    :data:`FORK_ONLY_FIELDS` — the payload on which fork- and
    rerun-engine sweeps must agree cell-for-cell."""
    d = res.to_json_dict()
    for f in WALL_CLOCK_FIELDS + FORK_ONLY_FIELDS:
        d.pop(f, None)
    return d


def measure_divergence_fields(measured: "ScenarioResult",
                              full: "ScenarioResult") -> List[str]:
    """The measure-mode contract checker: every deterministic field a
    measured cell emits must exist in — and equal — the full-execution
    cell. Returns the offending field names ([] = contract holds)."""
    dm = deterministic_cell_dict(measured)
    df = deterministic_cell_dict(full)
    return sorted(k for k in dm if k not in df or dm[k] != df[k])


def _digests_equal(a, b) -> bool:
    """np.array_equal-aware dict equality for ``restart_digest`` values
    (shared by the fork engine's byte-certification and the fault
    campaigns' golden-cell comparison)."""
    if set(a) != set(b):
        return False
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                return False
        elif va != vb:
            return False
    return True


def _crash_and_recover(wl: Workload, strat: ConsistencyStrategy,
                       point: CrashPoint,
                       recover: bool = True) -> Optional["RecoveryResult"]:
    """Crash at ``point`` and run strategy recovery, honoring the
    point's recovery-time :class:`~repro_torch.scenarios.crashplan.FaultSpec`.

    Fault-free points (and ``recover=False``) keep the classic shape:
    one crash, one recovery. A faulted point first runs the *golden*
    pass — the identical crash with no fault, recovered once — records
    its restart bookkeeping and ``restart_digest``, and rewinds the
    workload+strategy to the pre-crash snapshot (``crash()`` is
    deterministic, so the faulted re-crash produces a byte-identical
    image). The faulted pass then injects the media fault (if any) into
    the post-crash image and retries recovery under the armed
    nested-crash trap, re-crashing with the spec's derived torn
    survival each time the trap fires, up to ``max_attempts``.

    Returns the final RecoveryResult annotated with the fault
    bookkeeping ``classify_recovery`` consumes (``recovery_attempts``,
    ``nested_crashes``, ``fault_words_injected``,
    ``recovery_golden_match``) — or None when recovery never completed
    within the attempt budget (the cell classifies ``unrecovered``)."""
    emu = wl.emu
    crash_step, torn = point.step, point.torn
    fault = point.fault
    if not recover:
        emu.crash(point.survival)
        return None
    if fault is None:
        emu.crash(point.survival)
        return strat.recover(crash_step, torn, point.survival)

    # golden pass: the single-crash cell this faulted cell is certified
    # against. The snapshot rewind restores emulator state (truth,
    # image, cache, stats) AND mechanism state, so the faulted pass
    # re-crashes from exactly the same pre-crash world.
    pre_wl = wl.snapshot()
    pre_strat = strat.snapshot()
    emu.crash(point.survival)
    golden = strat.recover(crash_step, torn, point.survival)
    golden_restart = (golden.restart_point, golden.resume_step)
    golden_digest = wl.restart_digest(golden.restart_point)
    wl.restore_snapshot(pre_wl)
    strat.restore_snapshot(pre_strat)

    # faulted pass
    emu.crash(point.survival)
    injected = []
    mf = fault.media_fault()
    if mf is not None:
        names = fault.resolve_poison_regions(
            r.name for r in wl.live_regions())
        if names:
            injected = emu.inject_media_fault(mf, names)
    rec = None
    firings = 0
    attempts = 0
    while attempts < fault.max_attempts:
        attempts += 1
        if fault.nested_after is not None and firings < fault.nested_crashes:
            emu.arm_nested_crash(fault.nested_after)
        try:
            rec = strat.recover(crash_step, torn, point.survival)
            emu.disarm_nested_crash()
            break
        except NestedCrashFault:
            firings += 1
            emu.crash(fault.nested_survival(firings))
    if rec is None:
        emu.disarm_nested_crash()
        return None

    rec.info["recovery_attempts"] = attempts
    if fault.nested_after is not None:
        rec.info["nested_crashes"] = firings
    if mf is not None:
        rec.info["fault_words_injected"] = len(injected)
    match = (rec.restart_point, rec.resume_step) == golden_restart
    if match:
        digest = wl.restart_digest(rec.restart_point)
        if digest is not None and golden_digest is not None:
            match = _digests_equal(digest, golden_digest)
    rec.info["recovery_golden_match"] = bool(match)
    return rec


def classify_recovery(crashed: bool, crash_step: Optional[int],
                      rec: Optional["RecoveryResult"],
                      survival=None) -> str:
    """Correctness class of a cell, computed from the recovered state's
    bookkeeping (the strategy's :class:`RecoveryResult`) — no tail
    execution required, so measure-mode cells carry it too:

      complete             the run never crashed
      unrecovered          crashed and recovery was not attempted
      scratch_restart      recovery restarts from step 0
      consistent_rollback  recovery resumed from a consistent earlier
                           point; deterministic tail replay re-derives
                           everything that was lost
      lost_updates         completed work was lost that replay will NOT
                           re-derive (steps_lost exceeds the steps the
                           tail re-executes — the XSBench Fig.-10
                           stale-counter shape)

    Serving-style workloads (the KV store) generalize ``lost_updates``
    through the ``Workload.audit_recovery`` hook, whose oracle-side
    violation counts in ``rec.info`` map to two classes checked before
    everything below — a recovered store that fails its clients is the
    dominant fact about the cell, whatever the restart bookkeeping says
    (WITCHER's crash-consistency bug taxonomy, applied to a request
    log):

      atomicity_violation  partially-applied state is reader-visible in
                           the recovered store (a torn value or slot a
                           non-validating reader would serve)
      durability_violation an acknowledged update is missing or stale
                           after recovery (the client was told the put
                           committed; the recovered store disagrees)

    For sub-step torn crashes (``survival`` is the crash point's
    :class:`~repro_torch.core.backends.LineSurvival`), two classes report
    *detection coverage* — whether the mechanism's integrity machinery
    caught the inconsistent crash image:

      torn_detected        the mechanism positively identified torn
                           state and excluded or repaired it (CG's
                           invariant scan rejected versions, ABFT's
                           checksums flagged chunks, the undo log
                           rolled back / rejected a torn log-tail,
                           XSBench's counters disagreed with the index)
                           and the resume point loses nothing replay
                           cannot re-derive;
      torn_corrupt         torn state slipped into the recovered run:
                           either the strategy certifies the state
                           un-repairable (``info["state_corrupt"]``,
                           e.g. surviving counter increments past the
                           persisted index that replay double-counts)
                           or work was lost that replay cannot
                           re-derive (the lost_updates condition).

    Cells whose crash point carried a
    :class:`~repro_torch.scenarios.crashplan.FaultSpec` are certified against
    the *golden* single-crash cell (same crash, no fault — see
    :func:`_crash_and_recover`) and classify through four fault classes,
    checked before everything above except ``unrecovered`` (a fault
    campaign's question — did recovery survive the fault, did the
    machinery see the corruption — outranks the ordinary bookkeeping,
    which the golden comparison already covers):

      recovery_idempotent  >= 1 nested crash interrupted recovery and
                           the retried recovery still landed on exactly
                           the golden cell's restart point and digest —
                           recovery is re-entrant here, proven not
                           assumed;
      recovery_diverged    the nested crash changed where (or on what
                           state) recovery landed — the WITCHER class
                           of crash-unsafe recovery code;
      fault_detected       silently corrupted post-crash state was
                           positively flagged by the mechanism's
                           integrity machinery (invariant scan, ABFT
                           checksums, undo-log CRCs, KV row checksums);
      fault_silent         the corruption was neither flagged nor
                           landed on golden-equivalent state: the
                           recovered run proceeds on bad data with no
                           signal — the coverage hole this class exists
                           to surface. (An injected fault that recovery
                           neither sees nor is affected by — e.g. a
                           poisoned version slot the backward scan never
                           visits — is harmless and falls through to the
                           ordinary classes.)
    """
    if not crashed or crash_step is None:
        return "complete"
    if rec is None:
        return "unrecovered"
    if int(rec.info.get("nested_crashes") or 0) > 0:
        return ("recovery_idempotent"
                if rec.info.get("recovery_golden_match")
                else "recovery_diverged")
    if int(rec.info.get("fault_words_injected") or 0) > 0:
        detected = bool(rec.info.get("torn_flagged")
                        or rec.info.get("state_corrupt")
                        or int(rec.info.get("log_entries_rejected") or 0) > 0
                        or int(rec.info.get("payload_crc_mismatches") or 0) > 0
                        or int(rec.info.get("slots_dropped") or 0) > 0
                        or int(rec.info.get("corrected_elements") or 0) > 0)
        if detected:
            return "fault_detected"
        if not rec.info.get("recovery_golden_match"):
            return "fault_silent"
        # injected but undetected AND golden-equivalent: harmless —
        # fall through to the ordinary classes
    if int(rec.info.get("atomicity_violations") or 0) > 0:
        return "atomicity_violation"
    if int(rec.info.get("durability_violations") or 0) > 0:
        return "durability_violation"
    torn_sub = survival is not None
    if torn_sub and rec.info.get("state_corrupt"):
        return "torn_corrupt"
    if rec.from_scratch or rec.restart_point < 0:
        return "scratch_restart"
    lost, redo = _recovery_bookkeeping(rec, crash_step)
    if lost > redo:
        return "torn_corrupt" if torn_sub else "lost_updates"
    if torn_sub and rec.info.get("torn_flagged"):
        return "torn_detected"
    return "consistent_rollback"


@dataclasses.dataclass
class ScenarioResult:
    """Uniform per-cell outcome (JSON-serializable via ``to_json_dict``).

    The fields in :data:`FULL_RUN_FIELDS` are ``None`` on mode="measure"
    cells (they require tail execution + ``finalize()``) and omitted
    from the JSON dict; everything else means the same thing in every
    cell regardless of engine or mode."""

    workload: str
    workload_params: Dict[str, Any]
    strategy: str
    plan: str
    crash_step: Optional[int]
    torn: bool
    # line-survival spec of a sub-step torn crash ("random:f0.5:s3");
    # None for boundary and bare-torn crashes. Part of the cell's
    # identity: multi-sample TornSpec plans emit several cells at the
    # same (plan, crash_step) that differ only here
    torn_survival: Optional[str]
    # fault campaign spec of the crash point ("nested:a3:f0.5:s0",
    # "poison:w2:s1:kv.index"); None for ordinary cells. Part of the
    # cell's identity, like torn_survival
    fault: Optional[str]
    steps_total: int
    steps_done: int
    restart_point: Optional[int]     # newest surviving step; -1 => scratch
    resume_step: Optional[int]
    steps_lost: int
    steps_recomputed: int
    detect_seconds: float
    resume_seconds: float
    # mean seconds per pre-crash step of the phase the crash landed in:
    # measured wall-clock when the mean is >= AVG_STEP_JITTER_FLOOR,
    # otherwise the emulator's modeled per-step seconds (wall timing at
    # smoke sizes is pure jitter; the modeled cost is deterministic)
    avg_step_seconds: float
    overhead_seconds: float          # modeled mechanism cost (cost model)
    modeled_total_seconds: Optional[float]  # emulator's total modeled seconds
    wall_seconds: float
    correct: Optional[bool]
    # recovered-state classification (see classify_recovery) — defined
    # in every mode, unlike the end-of-run ``correct`` bit
    correctness_class: str
    # measure-mode byte-certification (fork engine only): recovered
    # state byte-equals the golden-prefix digest at the restart point
    # (scratch restarts certify against the pre-step-0 snapshot). None
    # when not computable (rerun engine, full mode, or no golden
    # snapshot at the restart step)
    state_certified: Optional[bool]
    metrics: Optional[Dict[str, float]]
    traffic: Optional[Dict[str, int]]
    info: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def to_json_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("info")
        for f in FULL_RUN_FIELDS + FORK_ONLY_FIELDS + ("torn_survival",
                                                       "fault"):
            if d[f] is None:
                d.pop(f)
        return _jsonable(d)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _avg_step_seconds(wall_durs: Sequence[float],
                      modeled_durs: Sequence[float]) -> float:
    wall = sum(wall_durs) / max(1, len(wall_durs))
    if wall >= AVG_STEP_JITTER_FLOOR:
        return wall
    return sum(modeled_durs) / max(1, len(modeled_durs))


def _forward(wl: Workload, strat: ConsistencyStrategy, point: CrashPoint
             ) -> Tuple[bool, List[float], List[float]]:
    """Run forward until completion or the crash point. Returns
    (crashed, per-step wall durations, per-step modeled-seconds deltas)
    — the modeled deltas are the deterministic counterpart the jitter
    floor falls back to. A torn crash's last entry covers only
    before_step+step (the persistence hook never ran)."""
    crash_step, torn = point.step, point.torn
    emu = wl.emu
    wall: List[float] = []
    modeled: List[float] = []
    crashed = False
    for i in range(wl.n_steps):
        ts = time.perf_counter()
        m0 = emu.modeled_seconds()
        strat.before_step(i)
        wl.step(i)
        if torn and crash_step == i:
            wall.append(time.perf_counter() - ts)
            modeled.append(emu.modeled_seconds() - m0)
            crashed = True
            break
        strat.after_step(i)
        wall.append(time.perf_counter() - ts)
        modeled.append(emu.modeled_seconds() - m0)
        if crash_step == i:
            crashed = True
            break
    return crashed, wall, modeled


def _crash_avg_step(wl: Workload, crash_step: Optional[int], crashed: bool,
                    wall_durs: Sequence[float],
                    modeled_durs: Sequence[float]) -> float:
    """Mean per-step seconds, normalized against the phase the crash
    landed in (loop-2 block additions are much cheaper than loop-1
    chunk multiplies)."""
    if not crashed:
        return _avg_step_seconds(wall_durs, modeled_durs)
    phase_rng = next((rng for rng in wl.phases().values()
                      if crash_step in rng), range(wl.n_steps))
    idx = [j for j in phase_rng if j < len(wall_durs)]
    return _avg_step_seconds([wall_durs[j] for j in idx],
                             [modeled_durs[j] for j in idx])


def _recovery_bookkeeping(rec, crash_step: int) -> Tuple[int, int]:
    """(steps_lost, steps_recomputed) from a RecoveryResult."""
    lost = rec.steps_lost if rec.steps_lost is not None else (
        crash_step - rec.restart_point if rec.restart_point >= 0
        else crash_step + 1)
    return lost, rec.redo_steps


def _finish(wl: Workload, strat: ConsistencyStrategy, point: CrashPoint,
            plan_desc: str, recover: bool, crashed: bool,
            wall_durs: Sequence[float], modeled_durs: Sequence[float],
            t0: float) -> ScenarioResult:
    """Crash (if armed), recover, run the tail, finalize, and assemble
    the ScenarioResult. Shared verbatim by the rerun path (after its own
    forward pass) and the fork engine (after restoring a snapshot)."""
    crash_step, torn = point.step, point.torn
    emu = wl.emu
    n = wl.n_steps
    steps_run = (crash_step + 1) if crashed else n
    avg_step = _crash_avg_step(wl, crash_step, crashed, wall_durs,
                               modeled_durs)

    restart: Optional[int] = None
    resume: Optional[int] = None
    lost = 0
    redo = 0
    detect_s = 0.0
    rec = None
    rec_info: Dict[str, Any] = {}
    steps_done = n

    if crashed:
        rec = _crash_and_recover(wl, strat, point, recover)
        if rec is not None:
            # oracle-side audit of the recovered state (durability /
            # atomicity violation counts) BEFORE the tail replay papers
            # over what recovery actually produced
            wl.audit_recovery(rec, crash_step, torn)
            restart, resume = rec.restart_point, rec.resume_step
            detect_s = rec.detect_seconds
            lost, redo = _recovery_bookkeeping(rec, crash_step)
            rec_info = dict(rec.info)
            for j in range(rec.resume_step, n):
                strat.before_step(j)
                wl.step(j)
                strat.after_step(j)
        else:
            steps_done = crash_step + 1
            if recover:
                # recovery itself died (nested crashes exhausted every
                # attempt): nothing recovered, nothing replayed
                lost = crash_step + 1

    report = wl.finalize()
    overhead = strat.modeled_overhead_seconds(wl.step_cost_profile(),
                                              emu.cfg, steps_run)
    stats = emu.stats

    # a recovery the audit caught violating durability/atomicity is not
    # a correct run even when the deterministic tail replay re-derives a
    # clean end state — the clients already observed the violation
    violations = (int(rec_info.get("durability_violations") or 0)
                  + int(rec_info.get("atomicity_violations") or 0))
    info = dict(report.info)
    info.update(rec_info)
    return ScenarioResult(
        workload=wl.name, workload_params=wl.params(),
        strategy=strat.name, plan=plan_desc,
        crash_step=crash_step, torn=torn,
        torn_survival=(point.survival.describe()
                       if point.survival is not None else None),
        fault=(point.fault.describe() if point.fault is not None else None),
        steps_total=n, steps_done=steps_done,
        restart_point=restart, resume_step=resume,
        steps_lost=lost, steps_recomputed=redo,
        detect_seconds=detect_s, resume_seconds=avg_step * redo,
        avg_step_seconds=avg_step,
        overhead_seconds=overhead,
        modeled_total_seconds=emu.modeled_seconds(),
        wall_seconds=time.perf_counter() - t0,
        correct=report.correct and violations == 0,
        correctness_class=classify_recovery(crashed, crash_step, rec,
                                            point.survival),
        state_certified=None,
        metrics=dict(report.metrics),
        traffic={
            "nvm_bytes_written": stats.nvm_bytes_written,
            "nvm_bytes_read": stats.nvm_bytes_read,
            "lines_flushed": stats.lines_flushed,
            "lines_evicted": stats.lines_evicted,
            "torn_bytes_persisted": stats.torn_bytes_persisted,
            "torn_entries_persisted": stats.torn_entries_persisted,
        },
        info=info,
    )


def _measure(wl: Workload, strat: ConsistencyStrategy, point: CrashPoint,
             plan_desc: str, wall_durs: Sequence[float],
             modeled_durs: Sequence[float], t0: float,
             certify=None) -> ScenarioResult:
    """The mode="measure" cell evaluator: crash, run strategy recovery,
    then *compute* every recompute/restart/cost field from the recovered
    state + the cost model — no tail execution, no ``finalize()``. The
    caller must hand us the workload positioned at the crash point (the
    fork engine restores a snapshot; the rerun engine just ran forward).

    ``certify`` (fork engine only) is a callable ``(RecoveryResult) ->
    Optional[bool]`` that byte-diffs the recovered state against the
    golden-prefix digest at the restart point — the ``state_certified``
    field. It may leave the workload in an arbitrary restored state;
    the measured cell is already fully determined by then.

    Only called for crashed cells — no_crash cells carry end-of-run
    correctness/metrics, which require ``finalize()``, so both engines
    route them through :func:`_finish` (whose "tail" is empty there)."""
    crash_step, torn = point.step, point.torn
    emu = wl.emu
    n = wl.n_steps
    avg_step = _crash_avg_step(wl, crash_step, True, wall_durs,
                               modeled_durs)

    torn_before = emu.stats.torn_bytes_persisted
    rec = _crash_and_recover(wl, strat, point)
    # the golden pass (fault cells) rewinds its own traffic via
    # restore_snapshot, so the delta covers exactly the faulted crash
    # plus any nested re-crashes
    torn_persisted = emu.stats.torn_bytes_persisted - torn_before
    if rec is not None:
        # audit BEFORE certify: the certification closure may restore
        # the workload to the golden state, and the audit must see what
        # recovery actually produced
        wl.audit_recovery(rec, crash_step, torn)
        lost, redo = _recovery_bookkeeping(rec, crash_step)
        restart, resume = rec.restart_point, rec.resume_step
        detect_s = rec.detect_seconds
        certified = certify(rec) if certify is not None else None
        info = dict(rec.info)
    else:
        # recovery died under nested crashes on every allowed attempt
        lost, redo = crash_step + 1, 0
        restart = resume = None
        detect_s = 0.0
        certified = None
        info = {}
    overhead = strat.modeled_overhead_seconds(wl.step_cost_profile(),
                                              emu.cfg, crash_step + 1)
    if point.survival is not None:
        # measure cells carry no end-of-run traffic dict; surface this
        # crash's in-flight writebacks for fig_torn's survivor budget
        info["torn_bytes_persisted"] = torn_persisted

    return ScenarioResult(
        workload=wl.name, workload_params=wl.params(),
        strategy=strat.name, plan=plan_desc,
        crash_step=crash_step, torn=torn,
        torn_survival=(point.survival.describe()
                       if point.survival is not None else None),
        fault=(point.fault.describe() if point.fault is not None else None),
        steps_total=n, steps_done=n,
        restart_point=restart, resume_step=resume,
        steps_lost=lost, steps_recomputed=redo,
        detect_seconds=detect_s, resume_seconds=avg_step * redo,
        avg_step_seconds=avg_step,
        overhead_seconds=overhead,
        modeled_total_seconds=None,
        wall_seconds=time.perf_counter() - t0,
        correct=None,
        correctness_class=classify_recovery(True, crash_step, rec,
                                            point.survival),
        state_certified=certified,
        metrics=None,
        traffic=None,
        info=info,
    )


def _run_point(wl: Workload, strat: ConsistencyStrategy, point: CrashPoint,
               plan_desc: str, recover: bool,
               mode: str = "full") -> ScenarioResult:
    t0 = time.perf_counter()
    crashed, wall, modeled = _forward(wl, strat, point)
    if mode == "measure" and crashed:
        return _measure(wl, strat, point, plan_desc, wall, modeled, t0)
    return _finish(wl, strat, point, plan_desc, recover, crashed,
                   wall, modeled, t0)


def run_scenario(workload, strategy, plan: Optional[CrashPlan] = None,
                 cfg: Optional[NVMConfig] = None, *,
                 recover: bool = True) -> ScenarioResult:
    """Run one scenario cell.

    workload: Workload | "name" | ("name", {params})
    strategy: ConsistencyStrategy | "name" | "name@interval"
    plan:     CrashPlan (default: no_crash). Must resolve to a single
              crash point — use :func:`sweep` for batch (``random``) plans.
    """
    plan = plan or CrashPlan.no_crash()
    wl = make_workload(workload)
    strat = make_strategy(strategy)
    if wl.mode is None:
        wl.setup(cfg, "adcc" if strat.wants_adcc else "plain")
    elif strat.wants_adcc and wl.mode != "adcc":
        raise ValueError(f"workload set up in mode {wl.mode!r} cannot run "
                         f"the {strat.name!r} strategy")
    strat.attach(wl)
    points = plan.resolve(wl)
    if len(points) != 1:
        raise ValueError(
            f"plan {plan.describe()!r} resolves to {len(points)} crash "
            f"points; run_scenario takes exactly one (use sweep())")
    return _run_point(wl, strat, points[0], plan.describe(), recover)


DEFAULT_SWEEP_PLANS: Sequence[CrashPlan] = (
    CrashPlan.no_crash(),
    CrashPlan.at_fraction(0.3),
    CrashPlan.at_fraction(0.75, torn=True),
    CrashPlan.random(count=1, seed=0),
)


def _shard_grounded(grounded: List[Tuple[CrashPlan, List[CrashPoint]]],
                    shard: Tuple[int, int]
                    ) -> List[Tuple[CrashPlan, List[CrashPoint]]]:
    """This shard's contiguous slice of the pair's grounded crash
    points, flattened plan-major point-minor and regrouped by plan —
    concatenating every shard's results in shard order reproduces the
    serial cell list exactly."""
    index, count = shard
    flat = [(plan, point) for plan, points in grounded for point in points]
    lo = index * len(flat) // count
    hi = (index + 1) * len(flat) // count
    out: List[Tuple[CrashPlan, List[CrashPoint]]] = []
    for plan, point in flat[lo:hi]:
        if out and out[-1][0] is plan:
            out[-1][1].append(point)
        else:
            out.append((plan, [point]))
    return out


def _sweep_pair(wl_spec, strat_spec, plans: Sequence[CrashPlan],
                cfg: Optional[NVMConfig], engine: str, mode: str,
                progress=None, shard: Optional[Tuple[int, int]] = None,
                snapshot_budget_bytes: Optional[int] = None,
                snapshot_policy: str = "spill"
                ) -> Tuple[List[ScenarioResult], List[Dict[str, str]]]:
    """Run every cell of one (workload, strategy) pair. The unit of work
    both the serial loop and the multiprocess executor share — results
    come back in plan-major, point-minor order either way.

    ``shard=(i, k)`` evaluates only the i-th of k contiguous slices of
    the pair's grounded crash points (plan grounding is deterministic,
    so every shard derives the identical global cell order and its
    slice independently); each shard regenerates its own golden prefix,
    which the fork engine truncates at the shard's last crash point.
    Only shard 0 reports the pair's skipped plans — they are per-pair
    facts, not per-cell."""
    # late imports: both engines import this module (avoids the cycle)
    from .sweep_engine import run_pair_forked

    # one probe per (workload, strategy) pair grounds every plan
    probe = make_workload(wl_spec)
    strat = make_strategy(strat_spec)
    probe.setup(cfg, "adcc" if strat.wants_adcc else "plain")
    skipped: List[Dict[str, str]] = []
    grounded: List[Tuple[CrashPlan, List[CrashPoint]]] = []
    for plan in plans:
        try:
            grounded.append((plan, plan.resolve(probe)))
        except ValueError as exc:
            skipped.append({"workload": probe.name,
                            "strategy": strat.name,
                            "plan": plan.describe(),
                            "reason": str(exc)})
    if shard is not None:
        if shard[0] != 0:
            skipped = []
        grounded = _shard_grounded(grounded, shard)
    if not grounded:
        return [], skipped
    tier_kw = dict(snapshot_budget_bytes=snapshot_budget_bytes,
                   snapshot_policy=snapshot_policy)
    if engine == "fork":
        if mode == "batched":
            from .batched_engine import run_pair_batched
            return (run_pair_batched(probe, strat, grounded,
                                     progress=progress, **tier_kw), skipped)
        return (run_pair_forked(probe, strat, grounded, progress=progress,
                                mode=mode, **tier_kw), skipped)
    results: List[ScenarioResult] = []
    reuse: Optional[Tuple[Workload, ConsistencyStrategy]] = (probe, strat)
    for plan, points in grounded:
        for point in points:
            if reuse is not None:
                wl, st = reuse
                reuse = None
            else:
                wl = make_workload(wl_spec)
                st = make_strategy(strat_spec)
                wl.setup(cfg, "adcc" if st.wants_adcc else "plain")
            st.attach(wl)
            res = _run_point(wl, st, point, plan.describe(),
                             recover=True, mode=mode)
            results.append(res)
            if progress is not None:
                progress(res)
    return results, skipped


def _run_pair_job(job) -> Tuple[List[ScenarioResult], List[Dict[str, str]]]:
    """Top-level (picklable) worker entry for ``sweep(workers=N)``.

    A job is the classic 6-tuple ``(wl_spec, strat_spec, plans, cfg,
    engine, mode)`` — kept as-is so pair-shard journal fingerprints
    stay stable — optionally extended by a 7th options dict carrying
    ``shard`` (crash-point sharding) and the snapshot-tier knobs."""
    wl_spec, strat_spec, plans, cfg, engine, mode = job[:6]
    opts = job[6] if len(job) > 6 else {}
    return _sweep_pair(wl_spec, strat_spec, plans, cfg, engine, mode,
                       shard=opts.get("shard"),
                       snapshot_budget_bytes=opts.get(
                           "snapshot_budget_bytes"),
                       snapshot_policy=opts.get("snapshot_policy", "spill"))


def _run_pair_job_on(dev: Optional[str], job):
    """:func:`_run_pair_job` under the parent's device selection: a
    spawned worker starts with none of its own, and would otherwise ask
    for the default card even when the parent runs on the CPU. Returns
    the job's results, its skipped cells and the kernel launches the
    job made in this worker, by kernel name."""
    before = launch_counts()
    if dev is None:
        results, skipped = _run_pair_job(job)
    else:
        with use_device(dev):
            results, skipped = _run_pair_job(job)
    after = launch_counts()
    return results, skipped, {k: after[k] - before[k] for k in after}


def _check_parallelizable(workloads: Sequence, strategies: Sequence) -> None:
    """workers>1 ships pair specs to worker processes, so specs must be
    the picklable registry forms, not live instances."""
    for wl_spec in workloads:
        if isinstance(wl_spec, Workload):
            raise ValueError(
                "sweep(workers>1) requires registry workload specs "
                "('name' or ('name', {params})), not Workload instances")
    for strat_spec in strategies:
        if isinstance(strat_spec, ConsistencyStrategy):
            raise ValueError(
                "sweep(workers>1) requires strategy spec strings "
                "('name' or 'name@interval'), not instances")


def _validate_sweep_specs(workloads: Sequence, strategies: Sequence) -> None:
    """Fail a typo'd matrix up front in the parent — with the registered
    names and a closest-match suggestion — instead of a bare KeyError
    surfacing from (possibly) a worker process mid-sweep."""
    for wl_spec in workloads:
        if isinstance(wl_spec, Workload):
            continue
        name = wl_spec if isinstance(wl_spec, str) else wl_spec[0]
        if name not in WORKLOADS:
            raise unknown_name_error("workload", name, WORKLOADS)
    for strat_spec in strategies:
        if isinstance(strat_spec, ConsistencyStrategy):
            continue
        name = str(strat_spec).partition("@")[0]
        if name not in STRATEGIES:
            raise unknown_name_error("strategy", name, STRATEGIES)


def _degrade_job(job, reason: str):
    """Graceful-degradation hook for sharded sweeps: a measure shard
    whose worker keeps dying or hanging steps down to full, the plain
    rerun-style execution path. Both agree on every deterministic field,
    so a degraded shard changes how cells are computed, never what they
    say. Point-shard jobs degrade the same way — the trailing options
    dict (shard slice, snapshot-tier knobs) is preserved verbatim.

    Two failures are never healed this way and raise
    :class:`~repro_torch.scenarios.pool.ShardFailure` instead. A batched
    shard does not step down to measure: its cells would come back
    identical and unmarked, computed per cell on the host, and a kernel
    that does not build or launch on the selected card would go unseen.
    And a worker that raised (``reason == "error"``) reports a fault in
    the code, which another mode must not hide; the failure carries the
    worker's traceback.
    """
    wl_spec, strat_spec, plans, cfg, engine, mode = job[:6]
    if reason == "error" or mode != "measure":
        return None
    return (wl_spec, strat_spec, plans, cfg, engine, "full") + tuple(job[6:])


def sweep(workloads: Sequence = ("cg", "mm", "xsbench"),
          strategies: Sequence = ("none", "adcc", "undo_log",
                                  "checkpoint_hdd", "checkpoint_nvm",
                                  "checkpoint_nvm_dram"),
          plans: Sequence[CrashPlan] = DEFAULT_SWEEP_PLANS,
          cfg: Optional[NVMConfig] = None,
          out_json: Optional[str] = None,
          progress=None,
          engine: str = "fork",
          mode: str = "full",
          workers: int = 1,
          shard_timeout: Optional[float] = None,
          shard_retries: int = 2,
          journal: Optional[str] = None,
          chaos: Optional[Dict[int, str]] = None,
          snapshot_budget_bytes: Optional[int] = None,
          snapshot_policy: Optional[str] = None) -> List[ScenarioResult]:
    """Run the full workloads × strategies × crash-plans matrix.

    All plans of a (workload, strategy) pair are grounded against one
    probe workload; a seeded ``CrashPlan.random(count=k)`` contributes
    ``k`` cells. ``engine`` selects execution (module docstring):
    ``"fork"`` (default) runs each pair forward once and forks every
    cell from a snapshot at its crash point; ``"rerun"`` re-executes
    each cell from step 0 on a fresh workload instance. Both engines
    produce identical cells (modulo ``wall_seconds``); fork makes dense
    plans (``CrashPlan.at_every_step()``) tractable.

    ``mode="measure"`` stops each crashed cell after strategy recovery
    and computes the recompute/restart fields from the recovered state
    (module docstring) — the cell omits :data:`FULL_RUN_FIELDS`.

    ``mode="batched"`` (fork engine only) goes one step further: crashed
    cells are evaluated analytically from the fork snapshots — torn
    survivor selection replayed host-side, recovery derived from the
    post-crash image, and the heavy integrity math (CG invariants, ABFT
    checksums) dispatched as batched kernel launches over ALL cells at once
    (:mod:`repro_torch.scenarios.batched_engine`). Deterministic fields are
    identical to measure cells except ``state_certified`` (None — a
    :data:`FORK_ONLY_FIELDS` member, excluded from cell comparisons).
    Pairs the analytic evaluators don't cover fall back to per-cell
    measure evaluation, so batched mode is always safe to request.

    ``workers=N`` shards the (workload, strategy) pairs across N
    supervised processes (pairs are independent; snapshots are
    per-emulator) and merges results in deterministic pair-major order,
    so the cell list is identical to ``workers=1`` regardless of
    completion order. Requires picklable registry specs. ``progress``
    then fires per pair (in merge order) instead of per cell. When
    ``workers`` exceeds the pair count, the spare workers split
    individual pairs' crash points: each point-shard re-grounds the
    pair's plans (grounding is deterministic), takes its contiguous
    slice of the flattened cell list, and regenerates its own golden
    prefix — the merged cell list stays identical to serial
    cell-for-cell, and the journal/retry/chaos machinery covers
    point-shards exactly as it covers pair-shards.

    ``snapshot_budget_bytes`` (default ``REPRO_SNAPSHOT_BUDGET``) caps
    each pair's resident fork-snapshot footprint; over budget the
    least-recently-used snapshot payload is spilled to disk
    (``snapshot_policy="spill"``, the default, env
    ``REPRO_SNAPSHOT_POLICY``) or dropped and re-derived from the
    golden prefix on its next access (``"recompute"``) — see
    :class:`~repro_torch.scenarios.sweep_engine.SnapshotTier`. Cells are
    byte-identical either way; the tier stats ride every cell as
    ``info["snapshot_tier"]``. The rerun engine takes no snapshots and
    ignores the knobs.

    Sharded sweeps self-heal (:mod:`repro_torch.scenarios.pool`): each shard
    gets a wall-clock deadline (``shard_timeout`` seconds, default from
    ``REPRO_SWEEP_SHARD_TIMEOUT`` or 600), a worker that dies or hangs
    is re-dispatched with exponential backoff up to ``shard_retries``
    times, and a measure shard whose worker keeps dying or hanging
    degrades to full before the sweep gives up. A batched shard never
    degrades, and neither does a shard whose worker raised: both fail
    the sweep (:func:`_degrade_job`). The kernel launches that the
    shards of the last sharded sweep made in their workers are summed
    in :data:`shard_launches`.
    ``journal=<path>`` appends each completed shard to a jsonl journal
    so an interrupted sweep resumed with the same arguments re-executes
    only the missing shards (the journal is deleted on success).
    ``chaos={shard_index: "kill"|"hang"}`` injects a failure into that
    shard's first attempt — the hook the chaos gate uses to prove the
    healing loop, never set in production sweeps.

    ``out_json`` writes the ``BENCH_scenarios.json`` artifact:
    ``{"schema": ..., "cells": [<ScenarioResult>...], "skipped": [...]}``.

    A plan that cannot be grounded for some (workload, strategy) pair —
    e.g. ``at_phase("loop2", ...)`` against the single-loop plain-mode
    MM, or ``at_step(k)`` past a shorter workload's step count — skips
    that cell (recorded in ``skipped``) instead of aborting the matrix.
    """
    if engine not in SWEEP_ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r}; "
                         f"choose from {SWEEP_ENGINES}")
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}; "
                         f"choose from {SWEEP_MODES}")
    if mode == "batched" and engine != "fork":
        raise ValueError('mode="batched" requires engine="fork" — cells '
                         "are evaluated from fork snapshots")
    if workers < 1:
        raise ValueError("workers must be >= 1")
    _validate_sweep_specs(workloads, strategies)
    if snapshot_budget_bytes is None:
        env_budget = os.environ.get("REPRO_SNAPSHOT_BUDGET", "").strip()
        if env_budget:
            snapshot_budget_bytes = int(env_budget)
    if snapshot_policy is None:
        snapshot_policy = os.environ.get("REPRO_SNAPSHOT_POLICY", "spill")
    from .sweep_engine import SNAPSHOT_POLICIES
    if snapshot_policy not in SNAPSHOT_POLICIES:
        raise ValueError(f"unknown snapshot policy {snapshot_policy!r}; "
                         f"choose from {SNAPSHOT_POLICIES}")

    pairs = [(wl_spec, strat_spec)
             for wl_spec in workloads for strat_spec in strategies]
    results: List[ScenarioResult] = []
    skipped: List[Dict[str, str]] = []

    if workers > 1:
        # uniform contract: the spec requirement holds whenever sharding
        # was REQUESTED, even if a single-pair matrix ends up serial
        _check_parallelizable(workloads, strategies)
    if workers > 1:
        import multiprocessing as mp

        from .pool import run_sharded
        start = "fork" if "fork" in mp.get_all_start_methods() else "spawn"
        from ..core.backends.batched import cuda_runtime_live
        # a forked child cannot use a CUDA context its parent
        # initialised, e.g. a serial batched sweep followed by a
        # sharded one: spawn instead, and let each child create its own
        # context and load the built kernel library itself. Batched
        # children run torch math even on the CPU, and a forked child
        # does not inherit the worker threads of the parent's intra-op
        # pool either (its first parallel reduction would wait for them
        # forever), so batched shards always spawn, and so does every
        # shard whose emulator runs its forward pass on the torch device.
        backend = (cfg if cfg is not None else NVMConfig()).backend
        if mode == "batched" or backend == "device" or cuda_runtime_live():
            start = "spawn"
        selected = selected_device()
        worker_fn = functools.partial(
            _run_pair_job_on, None if selected is None else str(selected))
        if shard_timeout is None:
            shard_timeout = float(
                os.environ.get("REPRO_SWEEP_SHARD_TIMEOUT", "600"))
        # spare workers beyond the pair count split individual pairs'
        # crash points into contiguous point-shards
        shard_counts = [1] * len(pairs)
        if workers > len(pairs):
            base, extra = divmod(workers, len(pairs))
            shard_counts = [base + (1 if i < extra else 0)
                            for i in range(len(pairs))]
        tier_opts: Dict[str, Any] = {}
        if snapshot_budget_bytes is not None:
            tier_opts = {"snapshot_budget_bytes": snapshot_budget_bytes,
                         "snapshot_policy": snapshot_policy}
        jobs: List[tuple] = []
        for (w, s), k in zip(pairs, shard_counts):
            # an unsharded, untiered pair keeps the classic 6-tuple so
            # its journal fingerprint matches pre-point-sharding runs
            base_job = (w, s, tuple(plans), cfg, engine, mode)
            if k == 1:
                jobs.append(base_job + ((dict(tier_opts),)
                                        if tier_opts else ()))
            else:
                jobs.extend(base_job + (dict(tier_opts, shard=(i, k)),)
                            for i in range(k))
        # the merge is job-major (= pair-major, point-shard-minor, i.e.
        # plan-major point-minor within each pair) and deterministic no
        # matter which worker finishes first or how often one is healed
        shard_launches.clear()
        for pair_results, pair_skipped, pair_launches in run_sharded(
                jobs, worker_fn, min(workers, len(jobs)),
                timeout=shard_timeout, retries=shard_retries,
                journal=journal, chaos=chaos, degrade=_degrade_job,
                start_method=start):
            results.extend(pair_results)
            skipped.extend(pair_skipped)
            for kernel, count in pair_launches.items():
                shard_launches[kernel] = shard_launches.get(kernel, 0) + count
            if progress is not None:
                for res in pair_results:
                    progress(res)
    else:
        for wl_spec, strat_spec in pairs:
            pair_results, pair_skipped = _sweep_pair(
                wl_spec, strat_spec, plans, cfg, engine, mode,
                progress=progress,
                snapshot_budget_bytes=snapshot_budget_bytes,
                snapshot_policy=snapshot_policy)
            results.extend(pair_results)
            skipped.extend(pair_skipped)

    if out_json:
        write_scenarios_json(out_json, results, skipped=skipped)
    return results


def dump_json(path: str, payload) -> None:
    """The artifact writer (benchmarks/common.py re-exports it)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1)


def write_scenarios_json(path: str, results: Iterable[ScenarioResult],
                         skipped: Optional[List[Dict[str, str]]] = None
                         ) -> None:
    dump_json(path, {
        "schema": "repro.scenarios.sweep/v1",
        "cells": [r.to_json_dict() for r in results],
        "skipped": skipped or [],
    })

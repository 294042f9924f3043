"""Batched crash-image evaluation for sweeps — ``sweep(mode="batched")``.

The fork engine made dense crash-point sweeps O(restore + recover) per
cell; this engine removes the per-cell restore/recover execution
entirely. The observation: a measure-mode cell's deterministic fields
are a *pure function* of (a) the golden prefix's modeled step costs and
(b) the post-crash NVM image at the cell's crash point — the live
strategy ``recover()`` call only re-derives information the snapshot
already holds. So:

1. Run the golden forward pass once (same as the fork engine), but
   alongside each crash-point snapshot capture the backend's dirty
   replacement queue (``dirty_eviction_order``) and region geometry.
2. For each crashed cell, replay the torn-survivor selection host-side
   (the exact shared :func:`~repro_torch.core.backends.select_survivors` /
   :func:`~repro_torch.core.backends.select_survivor_words` code) and build
   the post-crash view as *image overlaid with surviving dirty spans'
   truth* — byte-identical to what ``CrashEmulator.crash`` leaves in
   the image, without touching the emulator.
3. Evaluate every cell's recovery analytically from that view, with the
   numerically heavy parts — CG's invariant backward-scan and ABFT's
   per-chunk checksum verification — stacked across the *entire cell
   batch* and dispatched as a handful of launches through
   :mod:`repro_torch.core.backends.batched` (on the card a dense
   symmetrized-operator GEMM and a strided tile-sums pass through the
   hand-written CUDA kernels; on the CPU a batched sparse gather
   matvec and plain reductions — see
   :func:`~repro_torch.core.backends.batched.cg_route`). Device error
   magnitudes are accepted only outside a 2x certainty band around
   each tolerance; borderline candidates are re-checked with the exact
   host invariant/ABFT code, keeping batched cells bit-identical to
   measure cells.

Identity contract: a batched cell equals the corresponding measure cell
on every field of :func:`~repro_torch.scenarios.driver.deterministic_cell_dict`
(``state_certified`` is fork/measure-only and stays ``None`` here; wall
-clock fields are excluded as always). tests/test_torch_sweep.py,
tests/test_torch_kv.py and the card's smoke run enforce this
cell-for-cell.

The KV family evaluates analytically too: the request stream is a pure
function of (seed, i), so the strategies that restore a wholesale
committed state (none/checkpoint/shadow_snapshot/undo_log) reduce to
arithmetic on the host oracle's per-prefix live maps, and the adcc
policies replay root/commit-record validation plus the
durability/atomicity audit from each cell's crash image, with the
SplitMix64 row-checksum and value-word verification stacked over every
claimed row of the batch into
:func:`~repro_torch.core.backends.batched.kv_row_checksums` /
:func:`~repro_torch.core.backends.batched.kv_value_match` calls (int64
math — exact on device, so no certainty band; flagged-bad rows are
still re-confirmed by the exact host code, and ``stats`` counts the
verdicts that re-confirmation overturned, which must stay 0).

Pairs the analytic evaluators do not cover — user-registered strategy
or workload subclasses, or CG systems too large to densify on the dense
route (:data:`~repro_torch.core.backends.batched.GEMM_MAX_N`; the sparse
route is ungated) — fall back per-cell
to restore + ``_measure``
(without byte-certification), so ``mode="batched"`` is always safe to
request. Fallback cells carry the machine-readable reason in
``info["batched_fallback"]`` so benchmarks can assert zero fallbacks
for evaluator-covered workloads.

Not public API — use ``repro_torch.scenarios.sweep(engine="fork",
mode="batched")``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..algorithms.cg import _sym_matvec
from ..core import abft
from ..core.backends import batched as device
from ..core.backends.base import (LineSurvival, entry_span,
                                  select_survivor_words, select_survivors)
from ..core.invariants import (InvariantSet, OrthogonalityInvariant,
                               ResidualInvariant)
from .crashplan import CrashPlan, CrashPoint
from .driver import (AVG_STEP_JITTER_FLOOR, ScenarioResult, _finish,
                     _measure, _recovery_bookkeeping, classify_recovery)
from .kv import (_META_W as _KV_META_W, KVWorkload,
                 _mix_words as _kv_mix_words,
                 _value_words as _kv_value_words)
from .strategies import (AdccStrategy, CheckpointHddStrategy,
                         CheckpointNvmDramStrategy, CheckpointStrategy,
                         ConsistencyStrategy, NativeStrategy,
                         ShadowSnapshotStrategy, UndoLogStrategy)
from .sweep_engine import SnapshotTier, _CellSnapshot, _make_regen
from .workloads import (CGWorkload, MMWorkload, RecoveryResult, Workload,
                        XSBenchWorkload)

__all__ = ["run_pair_batched", "stats", "reset_stats"]

_log = logging.getLogger(__name__)

# (workload type, strategy type, reason) triples already INFO-logged as
# uncovered by an analytic evaluator — later sweeps of the same pair in
# this process log at DEBUG only
_FALLBACK_LOGGED: set = set()

# CG invariant tolerances (ADCC_CG.recover) and the certainty-band
# factor: a device error magnitude within [tol/_BAND, tol*_BAND] is
# re-checked with the exact host code. Device and host agree to a few
# ulps (~1e-15 relative), so a factor-2 band is unreachable by rounding
# yet torn garbage still lands orders of magnitude outside it.
_CG_ORTH_TOL = 1e-7
_CG_RES_TOL = 1e-6
_BAND = 2.0

# ABFT tolerances MMWorkload's recovery passes to abft.verify/correct
_MM_RTOL = 1e-9
_MM_ATOL = 1e-6

# what the analytic evaluators of this process did since reset_stats():
# CG scan waves and candidates screened on the device and the wall
# seconds of the wave loops (device calls and the host work between
# them), ABFT chunks screened, how many of either fell inside the
# certainty band and were re-checked by the exact host code, and (ABFT)
# how many chunks went to the host loop body at all (band-borderline or
# certainly failing); KV index rows and meta roots that the device math
# flagged bad and the exact host code then found good (exact integer
# math on both sides: anything but 0 is a fault of the device math)
stats: Dict[str, float] = {}


def reset_stats() -> None:
    stats.clear()
    stats.update(cg_waves=0, cg_candidates=0, cg_band_rechecks=0,
                 cg_wave_seconds=0.0, mm_chunks=0, mm_band_rechecks=0,
                 mm_host_checks=0, kv_overturned=0)


reset_stats()


# ---------------------------------------------------------------------------
# post-crash view assembly (host-side crash replay)
# ---------------------------------------------------------------------------

def _survivor_spans(survival: Optional[LineSurvival],
                    order: Sequence[Tuple[str, int]],
                    geometry: Dict[str, Tuple[int, int, int]]
                    ) -> Tuple[Dict[str, List[Tuple[int, int]]], int]:
    """Replay torn-survivor selection for one cell: the surviving element
    spans per region plus the persisted byte total (the cell's
    ``torn_bytes_persisted``). Uses the same shared selection/span code
    the backends call inside ``crash()``, so the result can never drift
    from a real crash."""
    spans: Dict[str, List[Tuple[int, int]]] = {}
    nbytes = 0
    if survival is None:
        return spans, nbytes
    if survival.granularity == "word":
        for name, _entry, lo, hi in select_survivor_words(
                order, survival, lambda nm: geometry[nm]):
            spans.setdefault(name, []).append((lo, hi))
            nbytes += (hi - lo) * geometry[name][2]
    else:
        for name, entry in select_survivors(order, survival):
            epe, n_elems, itemsize = geometry[name]
            lo, hi = entry_span(entry, epe, n_elems)
            spans.setdefault(name, []).append((lo, hi))
            nbytes += (hi - lo) * itemsize
    return spans, nbytes


class _CrashImage:
    """The post-crash NVM view of one cell, assembled host-side: the
    snapshot's image with the surviving dirty spans' *truth* pasted over
    — exactly the image ``CrashEmulator.crash`` would leave (writeback
    always persists truth spans, and post-crash truth is reloaded from
    the image, so this view serves reads of either side)."""

    __slots__ = ("_image", "_truth", "_spans")

    def __init__(self, emu_snap, spans: Dict[str, List[Tuple[int, int]]]):
        self._image = emu_snap.image
        self._truth = emu_snap.truth
        self._spans = spans

    def region(self, name: str) -> np.ndarray:
        img = self._image[name]
        spans = self._spans.get(name)
        if not spans:
            return img          # read-only snapshot view; callers only read
        out = img.copy()
        truth = self._truth[name]
        for lo, hi in spans:
            out[lo:hi] = truth[lo:hi]
        return out

    def scalar(self, name: str) -> int:
        return int(self.region(name)[0])


class _BatchedCell:
    """One crashed cell queued for analytic evaluation.

    Holds a snapshot *handle* (a zero-argument fetch), not the snapshot
    itself: under a snapshot tier the payload may be spilled or dropped
    between capture and evaluation, and the handle re-materializes it
    on access instead of keeping a reference that defeats eviction."""

    __slots__ = ("plan_desc", "point", "_snap_get", "spans", "torn_bytes",
                 "rec")

    def __init__(self, plan_desc: str, point: CrashPoint,
                 snap_get, order: Sequence[Tuple[str, int]],
                 geometry: Dict[str, Tuple[int, int, int]]):
        self.plan_desc = plan_desc
        self.point = point
        self._snap_get = snap_get
        self.spans, self.torn_bytes = _survivor_spans(
            point.survival, order, geometry)
        self.rec: Optional[RecoveryResult] = None

    @property
    def snap(self) -> _CellSnapshot:
        return self._snap_get()

    def crash_image(self) -> _CrashImage:
        return _CrashImage(self.snap.wl_snap["emu"], self.spans)


# ---------------------------------------------------------------------------
# per-strategy analytic evaluators
# ---------------------------------------------------------------------------

class _ScratchEvaluator:
    """none/native: crash always restarts from scratch."""

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        return [RecoveryResult(resume_step=0, restart_point=-1,
                               redo_steps=c.point.step + 1,
                               steps_lost=c.point.step + 1,
                               from_scratch=True)
                for c in cells]


class _CheckpointEvaluator:
    """checkpoint_*: resume from the snapshot's last checkpoint step."""

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        out = []
        for c in cells:
            crash = c.point.step
            last = c.snap.strat_snap["last_ckpt"]
            if last is None:
                out.append(RecoveryResult(
                    resume_step=0, restart_point=-1, redo_steps=crash + 1,
                    steps_lost=crash + 1, from_scratch=True))
            else:
                out.append(RecoveryResult(
                    resume_step=last + 1, restart_point=last,
                    redo_steps=crash - last, steps_lost=crash - last))
        return out


class _UndoLogEvaluator:
    """undo_log: an open uncommitted transaction at the crash point rolls
    back to the last commit. Log appends are fenced (transactions.py), so
    every reachable crash leaves an intact log: validation rejects 0
    entries and the torn flag reduces to "was a transaction open"."""

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        out = []
        for c in cells:
            crash = c.point.step
            snap = c.snap.strat_snap
            open_tx = snap["mgr"]["open_tx"]
            rolled_back = open_tx is not None and not open_tx["committed"]
            info = {"rolled_back": rolled_back,
                    "log_entries_rejected": 0,
                    "torn_flagged": rolled_back}
            last = snap["last_commit"]
            if last is None:
                out.append(RecoveryResult(
                    resume_step=0, restart_point=-1, redo_steps=crash + 1,
                    steps_lost=crash + 1, from_scratch=True, info=info))
            else:
                out.append(RecoveryResult(
                    resume_step=last + 1, restart_point=last,
                    redo_steps=crash - last, steps_lost=crash - last,
                    info=info))
        return out


class _ShadowSnapshotEvaluator:
    """shadow_snapshot: the root pointer only ever references a fully
    persisted slot, so recovery resumes from the active slot's step (or
    scratch before the first flip); a half-written staging slot is
    simply discarded."""

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        out = []
        for c in cells:
            crash = c.point.step
            snap = c.snap.strat_snap
            active = snap["active"]
            slots = snap["slots"]
            discarded = (slots[1 - active] is not None if active >= 0
                         else slots[0] is not None)
            info = {"shadow_discarded": discarded}
            if active < 0:
                out.append(RecoveryResult(
                    resume_step=0, restart_point=-1, redo_steps=crash + 1,
                    steps_lost=crash + 1, from_scratch=True, info=info))
            else:
                step = slots[active]["step"]
                out.append(RecoveryResult(
                    resume_step=step + 1, restart_point=step,
                    redo_steps=crash - step, steps_lost=crash - step,
                    info=info))
        return out


class _CGScan:
    """One cell's backward-scan state in the wave loop."""

    __slots__ = ("cell", "upper", "p", "q", "r", "z", "b", "tested",
                 "restart")

    def __init__(self, cell, upper, p, q, r, z, b):
        self.cell = cell
        self.upper = upper
        self.p, self.q, self.r, self.z, self.b = p, q, r, z, b
        self.tested = 0
        self.restart = -1


class _CGAdccEvaluator:
    """adcc + CG: the invariant backward-scan as a *wave* scan — each
    device launch evaluates one candidate per still-unresolved cell, so
    the batch does the same early-exiting amount of invariant math as
    the host scan (most cells accept their first or second candidate)
    instead of upper+1 candidates per cell. Only band-borderline
    candidates are re-checked by the exact host invariants."""

    def __init__(self, wl: CGWorkload):
        impl = wl._impl
        self._A = impl.A
        self._n = int(impl.A.n)
        # per-candidate read charge: 4 overlay rows + the operator —
        # ADCC_CG.recover's charge() (python ints summed, one division)
        self._charge = (4 * self._n * 8 + impl.A.nbytes()) / impl.emu.cfg.read_bw
        self._op = None

    def _operator(self):
        """The symmetrized operator S = 0.5*(A + A^T) in the
        representation ``cg_invariant_errors`` will route: densified
        for the GEMM kernel on the card; as padded equal-width row
        slabs (vals/cols (n, K), K the widest row, zero entries
        padding) for the gather-only sparse matvec on the CPU.
        Duplicate (row, col) entries are summed either way, exactly
        like the host's ``_sym_matvec``. Built and uploaded once per
        evaluator: the wave loop moves only its row blocks."""
        if self._op is None:
            A, n = self._A, self._n
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
            if device.cg_route() == "dense":
                # scatter-ADD via bincount: CSR rows may repeat a column
                # index, and assignment would silently drop the
                # duplicates' sum; bincount accumulates them like
                # np.add.at, in one vectorized pass
                dense = np.bincount(rows * n + A.indices, weights=A.data,
                                    minlength=n * n).reshape(n, n)
                op = ("dense", 0.5 * (dense + dense.T))
            else:
                keys = np.concatenate([rows * n + A.indices,
                                       A.indices.astype(np.int64) * n + rows])
                uniq, inv = np.unique(keys, return_inverse=True)
                svals = 0.5 * np.bincount(
                    inv, weights=np.concatenate([A.data, A.data]))
                srows = (uniq // n).astype(np.int64)
                counts = np.bincount(srows, minlength=n)
                K = int(counts.max()) if len(counts) else 1
                starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
                pos = np.arange(len(uniq)) - np.repeat(starts, counts)
                vals2d = np.zeros((n, K))
                cols2d = np.zeros((n, K), dtype=np.int32)
                vals2d[srows, pos] = svals
                cols2d[srows, pos] = (uniq % n).astype(np.int32)
                op = ("sparse", vals2d, cols2d)
            self._op = device.cg_operator_to_device(op)
        return self._op

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        n = self._n
        states: List[_CGScan] = []
        active: List[_CGScan] = []
        b0: Optional[np.ndarray] = None
        for c in cells:
            ci = c.crash_image()
            st = _CGScan(c, ci.scalar("iter"),
                         ci.region("p").reshape(-1, n),
                         ci.region("q").reshape(-1, n),
                         ci.region("r").reshape(-1, n),
                         ci.region("z").reshape(-1, n),
                         np.asarray(ci.region("b"), dtype=np.float64))
            states.append(st)
            if b0 is None:
                b0 = st.b
            if st.upper < 0:
                continue            # no candidates: scratch restart
            if np.array_equal(st.b, b0):
                active.append(st)
            else:
                # b is never written after init, so one b serves the
                # whole device batch; if a cell ever disagreed, its
                # screen verdicts would be unsound — scan it with the
                # exact host code instead
                for j in range(st.upper, -1, -1):
                    st.tested += 1
                    if self._exact_ok(st, j):
                        st.restart = j
                        break
        op = self._operator() if active else None
        b_dev = device.upload(b0) if active else None
        t_waves = time.perf_counter()
        while active:
            W = len(active)
            P = np.empty((W, n))
            Q = np.empty((W, n))
            R = np.empty((W, n))
            Z = np.empty((W, n))
            for k, st in enumerate(active):
                j = st.upper - st.tested
                P[k] = st.p[j + 1]
                Q[k] = st.q[j]
                R[k] = st.r[j + 1]
                Z[k] = st.z[j + 1]
            orth, rel = device.cg_invariant_errors(P, Q, R, Z, b_dev, op)
            stats["cg_waves"] += 1
            stats["cg_candidates"] += W
            nxt: List[_CGScan] = []
            for k, st in enumerate(active):
                j = st.upper - st.tested
                st.tested += 1
                o = float(orth[k])
                r = float(rel[k])
                if o <= _CG_ORTH_TOL / _BAND and r <= _CG_RES_TOL / _BAND:
                    ok = True
                elif o >= _CG_ORTH_TOL * _BAND or r >= _CG_RES_TOL * _BAND:
                    ok = False
                else:
                    stats["cg_band_rechecks"] += 1
                    ok = self._exact_ok(st, j)
                if ok:
                    st.restart = j
                elif j > 0:
                    nxt.append(st)
            active = nxt
        stats["cg_wave_seconds"] += time.perf_counter() - t_waves
        out = []
        for st in states:
            # backward_scan accumulates the constant charge candidate by
            # candidate; repeat the float additions so detect_seconds is
            # bit-identical, not just close
            detect = 0.0
            for _ in range(st.tested):
                detect += self._charge
            crash = st.cell.point.step
            if st.restart >= 0:
                resume, lost = st.restart + 1, crash - st.restart
            else:
                resume, lost = 0, crash + 1
            out.append(RecoveryResult(
                resume_step=resume, restart_point=st.restart,
                detect_seconds=detect, redo_steps=crash + 1 - resume,
                steps_lost=lost, from_scratch=st.restart < 0,
                info={"iterations_lost": lost,
                      "torn_flagged": st.tested > 1}))
        return out

    def _exact_ok(self, st: _CGScan, j: int) -> bool:
        invs = InvariantSet([
            OrthogonalityInvariant("p_next", "q_cur", tol=_CG_ORTH_TOL),
            ResidualInvariant("r_next", "z_next", b=st.b,
                              matvec=lambda x: _sym_matvec(self._A, x),
                              tol=_CG_RES_TOL),
        ])
        return invs.holds({"p_next": st.p[j + 1], "q_cur": st.q[j],
                           "r_next": st.r[j + 1], "z_next": st.z[j + 1]})


class _MMAdccEvaluator:
    """adcc + MM: checksum-classify every examined loop-1 chunk in device
    batches over all cells (exact host ABFT only where the screen is
    not certain), then the cheap exact loop-2 block classification."""

    def __init__(self, wl: MMWorkload):
        impl = wl._impl
        self._n = int(impl.n)
        self._m = self._n + 1
        self._nchunks = int(impl.nchunks)
        self._row_blocks = list(impl.row_blocks)
        self._read_bw = impl.emu.cfg.read_bw

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        # cells are screened one launch group at a time: a group's chunk
        # images are built, stacked, uploaded, classified and dropped
        # before the next group's are built, so neither the host nor
        # the card ever holds the whole sweep's stack
        budget = device.mm_slabs_per_launch(self._m)
        out: List[RecoveryResult] = []
        group: List[tuple] = []
        slabs = 0
        for c in cells:
            ci = c.crash_image()
            upper = ci.scalar("mm_iter")
            # a loop-2 crash still scans ALL chunks (the persisted
            # counter is past nchunks), and loop-2 cells need the scan's
            # corrected_elements even though chunks don't set their lost
            examined = min(upper + 1, self._nchunks)
            if group and slabs + examined > budget:
                out.extend(self._recover_group(group))
                group, slabs = [], 0
            m = self._m
            chunk_views = [np.asarray(ci.region(f"C_s{s}")).reshape(m, m)
                           for s in range(examined)]
            group.append((c, ci, examined, chunk_views))
            slabs += examined
        if group:
            out.extend(self._recover_group(group))
        return out

    def _recover_group(self, group: List[tuple]) -> List[RecoveryResult]:
        m = self._m
        views = [v for _c, _ci, _ex, chunk_views in group
                 for v in chunk_views]
        if views:
            nonzero, absmax, rowmax, colmax = device.mm_chunk_stats(views)
        out = []
        base = 0
        for c, ci, examined, chunk_views in group:
            crash = c.point.step
            bad: List[int] = []
            corrected = 0
            nbytes = 0
            for s in range(examined):
                view = chunk_views[s]
                nbytes += view.nbytes
                i = base + s
                tol = _MM_ATOL + _MM_RTOL * max(float(absmax[i]), 1.0)
                rmax, cmax = float(rowmax[i]), float(colmax[i])
                stats["mm_chunks"] += 1
                if (bool(nonzero[i]) and rmax <= tol / _BAND
                        and cmax <= tol / _BAND):
                    continue        # certainly verifies: chunk is good
                # not certain — run the exact host loop body
                stats["mm_host_checks"] += 1
                if (bool(nonzero[i]) and rmax < tol * _BAND
                        and cmax < tol * _BAND):
                    stats["mm_band_rechecks"] += 1
                if np.any(view != 0) and abft.verify(view, rtol=_MM_RTOL,
                                                     atol=_MM_ATOL):
                    continue
                fixed, nfix = abft.correct_single_error(view, rtol=_MM_RTOL,
                                                        atol=_MM_ATOL)
                if fixed is not None:
                    corrected += nfix
                else:
                    bad.append(s)
            base += examined
            detect = nbytes / self._read_bw
            if crash < self._nchunks:
                lost, crashed_in = len(bad), "loop1"
            else:
                blocks_done = crash - self._nchunks + 1
                ct = np.asarray(ci.region("C_temp")).reshape(m, m)
                row_resid = ct[:, self._n] - ct[:, :self._n].sum(axis=1)
                scale = max(float(np.max(np.abs(ct))), 1.0)
                tol2 = _MM_ATOL + _MM_RTOL * scale
                bad_blocks = [
                    bi for bi, (lo, hi)
                    in enumerate(self._row_blocks[:blocks_done])
                    if np.any(np.abs(row_resid[lo:hi]) > tol2)
                    or not np.any(ct[lo:hi, :] != 0)]
                detect = detect + ct.nbytes / self._read_bw
                lost, crashed_in = len(bad_blocks), "loop2"
            out.append(RecoveryResult(
                resume_step=crash + 1, restart_point=crash,
                detect_seconds=detect, redo_steps=lost, steps_lost=lost,
                info={"crashed_in": crashed_in, "chunks_lost": lost,
                      "corrected_elements": corrected,
                      "torn_flagged": lost > 0 or corrected > 0}))
        return out


class _XSBenchEvaluator:
    """adcc + XSBench: pure counter arithmetic on the post-crash view —
    no device work needed, and the dominant cell population of dense
    torn sweeps (every cell is O(1) here vs a restore + recover)."""

    def __init__(self, wl: XSBenchWorkload):
        self._ntypes = len(wl._impl._counters)

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        out = []
        for c in cells:
            ci = c.crash_image()
            crash = c.point.step
            crashed_lookups = crash + 1
            resume_i = ci.scalar("lookup_index")
            counted = sum(ci.scalar(f"type_counter_{t}")
                          for t in range(self._ntypes))
            lost = max(0, resume_i - counted) + (crashed_lookups - resume_i)
            out.append(RecoveryResult(
                resume_step=resume_i, restart_point=resume_i - 1,
                redo_steps=crashed_lookups - resume_i, steps_lost=lost,
                from_scratch=resume_i == 0,
                info={"iterations_lost": lost,
                      "torn_flagged": counted != resume_i,
                      "state_corrupt": counted > resume_i}))
        return out


# ---------------------------------------------------------------------------
# KV-family evaluators
# ---------------------------------------------------------------------------

class _KVStateEvaluator:
    """Wrap a state-restoring evaluator (scratch / checkpoint / shadow /
    undo log) with the KV durability/atomicity audit, computed from the
    host request oracle instead of the live recovered store.

    Every strategy on this route restores a wholesale committed state,
    so the store the audit would inspect is byte-for-byte the clean
    end-of-step state of ``resume_step - 1``: its semantic map is the
    oracle's live map at that prefix with every integrity verdict True,
    no reader-visible corrupt rows, and an intact meta root. The audit
    therefore reduces to dictionary arithmetic on the oracle maps — and
    ``resume_step <= acked_requests`` always holds (strategy persistence
    runs in ``after_step``, torn snapshots are captured before it), so
    the in-flight atomicity scan range is empty and atomicity is 0."""

    def __init__(self, wl: KVWorkload, base):
        self._maps = wl._oracle()[0]
        self._base = base

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        recs = self._base.recover_batch(cells)
        for c, rec in zip(cells, recs):
            acked_n = c.point.step + (0 if c.point.torn else 1)
            acked = self._maps[acked_n]
            vis = self._maps[rec.resume_step]
            dur = sum(1 for key, (seq_o, _nw) in acked.items()
                      if key not in vis or vis[key][0] < seq_o)
            dur += sum(1 for key in vis if key not in acked)
            rec.info["acked_requests"] = acked_n
            rec.info["durability_violations"] = dur
            rec.info["atomicity_violations"] = 0
        return recs


class _KVAdccEvaluator:
    """adcc + KV: replay root/commit-record validation and the
    durability/atomicity audit from each cell's crash image (post-crash
    truth is reloaded from the image, so the image serves reads of
    either side). The dominant cost — per-row SplitMix64 checksum
    chains and value-word recomputation, O(rows x words) integer
    hashing — runs as one stacked device call over every claimed row
    of the whole cell batch
    (:func:`~repro_torch.core.backends.batched.kv_row_checksums` /
    :func:`~repro_torch.core.backends.batched.kv_value_match`). The device
    pipeline computes the same 63-bit integer function exactly, so
    there is no certainty band; per the established discipline any row
    the device flags bad is still re-confirmed by the exact host
    ``_row_ok`` port before it can reject a root or count a violation,
    and ``stats["kv_overturned"]`` counts the flags it overturned."""

    def __init__(self, wl: KVWorkload):
        self._wl = wl
        self._maps = wl._oracle()[0]
        self._read_bw = wl.emu.cfg.read_bw

    def _host_row_ok(self, row: np.ndarray,
                     vlogs: List[np.ndarray]) -> bool:
        """Exact image-side port of ``KVWorkload._row_ok``."""
        wl = self._wl
        if int(row[7]) != _kv_mix_words(row[:7]):
            return False
        nw = int(row[3])
        if nw <= 0:
            return True
        key, seq, goff = int(row[0]) - 1, int(row[1]), int(row[2])
        e, off = divmod(goff, wl.extent_words)
        if not (0 <= e < wl.n_extents and 0 <= off
                and off + nw <= wl.extent_words):
            return False
        got = vlogs[e][off:off + nw]
        return bool(np.array_equal(got, _kv_value_words(key, seq, nw)))

    def _audit(self, rec: RecoveryResult, acked_n: int, idx: np.ndarray,
               rows_ok: Dict[int, bool], meta: np.ndarray,
               meta_ok: Sequence[bool]) -> None:
        """``KVWorkload.audit_recovery`` on an image-side store view:
        ``rows_ok`` maps reader-visible claimed row -> integrity verdict
        (rows a validate recovery dropped are simply absent, matching
        the zeroed live rows the real audit walks)."""
        wl = self._wl
        visible: Dict[int, Tuple[int, bool]] = {}   # key -> (seq, ok)
        corrupt = 0
        for s in range(wl.n_slots):
            best = None
            for v in (0, 1):
                r = 2 * s + v
                if r not in rows_ok:
                    continue
                if best is None or int(idx[r, 1]) > int(idx[best, 1]):
                    best = r
            if best is None:
                continue
            if not rows_ok[best]:
                corrupt += 1
            if int(idx[best, 3]) > 0:
                visible[int(idx[best, 0]) - 1] = (int(idx[best, 1]),
                                                  rows_ok[best])
        atom = corrupt
        if not any(int(meta[v, 1]) == rec.resume_step and meta_ok[v]
                   for v in (0, 1)):
            atom += 1
        for j in range(acked_n, rec.resume_step):
            op, key, _nw = wl._request(j)
            if op == "get":
                continue
            ent = visible.get(key)
            if op == "put":
                if ent is None or ent[0] != j + 1 or not ent[1]:
                    atom += 1
            elif ent is not None and ent[0] < j + 1:
                atom += 1
        acked = self._maps[acked_n]
        dur = 0
        for key, (seq_o, _nw) in acked.items():
            ent = visible.get(key)
            if (ent is None or ent[0] < seq_o
                    or (ent[0] == seq_o and not ent[1])):
                dur += 1
        for key, ent in visible.items():
            if key not in acked and ent[1] and ent[0] <= acked_n:
                dur += 1
        rec.info["acked_requests"] = acked_n
        rec.info["durability_violations"] = dur
        rec.info["atomicity_violations"] = atom

    def recover_batch(self, cells: List[_BatchedCell]) -> List[RecoveryResult]:
        wl = self._wl
        n_rows = 2 * wl.n_slots
        ew = wl.extent_words
        prepared = []
        idx_blocks: List[np.ndarray] = []
        meta_blocks: List[np.ndarray] = []
        bounds_bad: List[np.ndarray] = []
        val_pos: List[int] = []     # flat claimed-row position of each item
        val_keys: List[int] = []
        val_seqs: List[int] = []
        val_nws: List[int] = []
        val_spans: List[np.ndarray] = []
        base = 0
        for c in cells:
            ci = c.crash_image()
            meta = np.asarray(ci.region("kv.meta")).reshape(2, _KV_META_W)
            idx = np.asarray(ci.region("kv.index")).reshape(n_rows, 8)
            vlogs = [np.asarray(ci.region(f"kv.vlog{e}"))
                     for e in range(wl.n_extents)]
            claimed = np.flatnonzero(idx[:, 0] != 0)
            rows = idx[claimed]
            bad = np.zeros(len(claimed), dtype=bool)
            for p in range(len(claimed)):
                nw = int(rows[p, 3])
                if nw <= 0:
                    continue
                e, off = divmod(int(rows[p, 2]), ew)
                if not (0 <= e < wl.n_extents and off + nw <= ew):
                    bad[p] = True       # torn (goff, nwords): row invalid
                    continue
                val_pos.append(base + p)
                val_keys.append(int(rows[p, 0]) - 1)
                val_seqs.append(int(rows[p, 1]))
                val_nws.append(nw)
                val_spans.append(vlogs[e][off:off + nw])
            idx_blocks.append(rows)
            meta_blocks.append(meta)
            bounds_bad.append(bad)
            prepared.append((c, meta, idx, vlogs, claimed, base))
            base += len(claimed)

        # one stacked call per verification kind across the whole batch
        if base:
            all_rows = np.vstack(idx_blocks)
            row_ok_flat = (device.kv_row_checksums(all_rows[:, :7])
                           == all_rows[:, 7])
            row_ok_flat &= ~np.concatenate(bounds_bad)
        else:
            row_ok_flat = np.empty(0, dtype=bool)
        all_meta = np.vstack(meta_blocks)
        meta_ck = (device.kv_row_checksums(all_meta[:, :_KV_META_W - 1])
                   == all_meta[:, _KV_META_W - 1])
        if val_pos:
            wmax = max(val_nws)
            got = np.zeros((len(val_pos), wmax), dtype=np.int64)
            for i, span in enumerate(val_spans):
                got[i, :len(span)] = span
            vok = device.kv_value_match(
                np.asarray(val_keys, dtype=np.int64),
                np.asarray(val_seqs, dtype=np.int64), got,
                np.asarray(val_nws, dtype=np.int64))
            row_ok_flat[np.asarray(val_pos)] &= vok

        out = []
        for i, (c, meta, idx, vlogs, claimed, b) in enumerate(prepared):
            # host re-confirmation of every device-flagged-bad row/root
            rows_ok: Dict[int, bool] = {}
            for j, r in enumerate(claimed):
                ok = bool(row_ok_flat[b + j])
                if not ok:
                    ok = self._host_row_ok(idx[r], vlogs)
                    stats["kv_overturned"] += ok
                rows_ok[int(r)] = ok
            meta_ok = []
            for v in (0, 1):
                ok = bool(meta_ck[2 * i + v])
                if not ok:
                    ok = (int(meta[v, -1]) == _kv_mix_words(meta[v, :-1]))
                    stats["kv_overturned"] += ok
                meta_ok.append(ok)
            out.append(self._eval_cell(c, meta, meta_ok, idx, rows_ok))
        return out

    def _eval_cell(self, c: _BatchedCell, meta: np.ndarray,
                   meta_ok: Sequence[bool], idx: np.ndarray,
                   rows_ok: Dict[int, bool]) -> RecoveryResult:
        """Exact replay of ``KVWorkload.adcc_recover`` + the audit on the
        resulting store view."""
        wl = self._wl
        crash = c.point.step
        acked_n = crash + (0 if c.point.torn else 1)
        raw = max(int(meta[v, 1]) for v in (0, 1))
        if wl.policy == "blind":
            rec = RecoveryResult(
                resume_step=raw, restart_point=raw - 1,
                detect_seconds=meta.nbytes / self._read_bw,
                redo_steps=crash + 1 - raw, from_scratch=raw == 0,
                info={"policy": "blind", "torn_flagged": False})
            self._audit(rec, acked_n, idx, rows_ok, meta, meta_ok)
            return rec
        read_bytes = meta.nbytes + idx.nbytes
        for r in rows_ok:
            read_bytes += 8 * max(0, int(idx[r, 3]))
        detect = read_bytes / self._read_bw
        valid = [v for v in (0, 1) if meta_ok[v]]
        resume = None
        for cc, v in sorted(((int(meta[v, 1]), v) for v in valid),
                            reverse=True):
            ok_c = all(ok or int(idx[r, 1]) != cc
                       for r, ok in rows_ok.items())
            fp = int(meta[v, 7])
            if ok_c and fp:
                r = fp - 1
                ok_c = (0 <= r < 2 * wl.n_slots
                        and rows_ok.get(r, False)
                        and int(idx[r, 1]) == cc
                        and int(idx[r, 7]) == int(meta[v, 8]))
            if ok_c:
                resume = cc
                break
        if resume is None:
            rec = RecoveryResult(
                resume_step=0, restart_point=-1, detect_seconds=detect,
                redo_steps=crash + 1, steps_lost=crash + 1,
                from_scratch=True,
                info={"policy": "validate", "torn_flagged": True,
                      "slots_dropped": 0})
            # the real path resets the store before the audit: empty
            # semantic map, intact committed=0 root => every acked live
            # key is a durability violation and nothing else counts
            rec.info["acked_requests"] = acked_n
            rec.info["durability_violations"] = len(self._maps[acked_n])
            rec.info["atomicity_violations"] = 0
            return rec
        dropped = 0
        kept: Dict[int, bool] = {}
        for r, ok in rows_ok.items():
            if not ok or int(idx[r, 1]) > resume:
                dropped += 1
            else:
                kept[r] = True
        rec = RecoveryResult(
            resume_step=resume, restart_point=resume - 1,
            detect_seconds=detect, redo_steps=crash + 1 - resume,
            from_scratch=resume == 0,
            info={"policy": "validate",
                  "torn_flagged": dropped > 0 or resume < raw,
                  "slots_dropped": dropped})
        self._audit(rec, acked_n, idx, kept, meta, meta_ok)
        return rec


_SCRATCH_TYPES = (ConsistencyStrategy, NativeStrategy)
_CKPT_TYPES = (CheckpointStrategy, CheckpointHddStrategy,
               CheckpointNvmDramStrategy)


def _make_evaluator(wl: Workload, strat: ConsistencyStrategy):
    """``(evaluator, fallback_reason)`` for this (workload, strategy)
    pair: an analytic batch evaluator with ``reason=None``, or
    ``(None, reason)`` to fall back to per-cell measure evaluation. The
    reason string is machine-readable and lands in fallback cells'
    ``info["batched_fallback"]`` so sweep gates can assert zero
    fallbacks for covered workloads. Dispatch is on EXACT types: a
    subclass may override ``recover()``, and guessing wrong would
    silently break the batched==measure identity."""
    t = type(strat)
    if type(wl) is KVWorkload:
        # the KV audit inspects the recovered store; the evaluators
        # reproduce it from the request oracle (state-restoring
        # strategies) or from the crash image (adcc)
        if t in _SCRATCH_TYPES:
            return _KVStateEvaluator(wl, _ScratchEvaluator()), None
        if t in _CKPT_TYPES:
            return _KVStateEvaluator(wl, _CheckpointEvaluator()), None
        if t is ShadowSnapshotStrategy:
            return _KVStateEvaluator(wl, _ShadowSnapshotEvaluator()), None
        if t is UndoLogStrategy:
            return _KVStateEvaluator(wl, _UndoLogEvaluator()), None
        if t is AdccStrategy:
            return _KVAdccEvaluator(wl), None
        return None, f"unsupported-strategy:{t.__name__}"
    if type(wl).audit_recovery is not Workload.audit_recovery:
        # an unknown auditing workload inspects the live recovered
        # state; analytic evaluators never run recovery, so its info
        # fields would diverge from measure cells
        return None, f"audit-override:{type(wl).__name__}"
    if t in _SCRATCH_TYPES:
        return _ScratchEvaluator(), None
    if t in _CKPT_TYPES:
        return _CheckpointEvaluator(), None
    if t is ShadowSnapshotStrategy:
        return _ShadowSnapshotEvaluator(), None
    if t is UndoLogStrategy:
        return _UndoLogEvaluator(), None
    if t is AdccStrategy:
        if type(wl) is XSBenchWorkload:
            return _XSBenchEvaluator(wl), None
        if type(wl) is CGWorkload:
            # only the dense (GEMM kernel) route densifies the
            # operator; the sparse route scales with nnz and is ungated
            if (device.cg_route() == "dense"
                    and wl._impl.A.n > device.GEMM_MAX_N):
                return None, "cg-too-large"
            return _CGAdccEvaluator(wl), None
        if type(wl) is MMWorkload:
            return _MMAdccEvaluator(wl), None
    return None, f"unsupported:{type(wl).__name__}/{t.__name__}"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _AvgStepCache:
    """O(1) crash-phase mean step seconds from prefix sums — the
    quantity ``_crash_avg_step`` computes from the sliced duration
    lists, without building an O(crash_step) list per cell. avg_step
    feeds only wall-clock fields (``avg_step_seconds``,
    ``resume_seconds``), which cell comparisons exclude, so the
    reassociated summation is safe."""

    def __init__(self, wl: Workload, wall: List[float],
                 modeled: List[float]):
        self._phases = list(wl.phases().values())
        self._n = wl.n_steps
        self._cw = np.concatenate(([0.0], np.cumsum(wall)))
        self._cm = np.concatenate(([0.0], np.cumsum(modeled)))

    def at(self, crash_step: int, wall_last: float,
           modeled_last: float) -> float:
        rng = next((r for r in self._phases if crash_step in r),
                   range(self._n))
        lo = rng.start
        hi = min(rng.stop, crash_step + 1)  # durs list has crash_step+1
        cnt = max(1, hi - lo)
        if hi == crash_step + 1:            # crash step is in the phase:
            w = self._cw[crash_step] - self._cw[lo] + wall_last
            m = self._cm[crash_step] - self._cm[lo] + modeled_last
        else:
            w = self._cw[hi] - self._cw[lo]
            m = self._cm[hi] - self._cm[lo]
        if w / cnt >= AVG_STEP_JITTER_FLOOR:
            return float(w / cnt)
        return float(m / cnt)


def _assemble(wl: Workload, strat: ConsistencyStrategy, cell: _BatchedCell,
              avg_cache: _AvgStepCache, t0: float) -> ScenarioResult:
    """Build the ScenarioResult for one analytically evaluated cell —
    field-for-field the ``driver._measure`` construction, with the
    RecoveryResult coming from the batch evaluator instead of a live
    ``strat.recover()`` and ``torn_bytes_persisted`` from the host-side
    survivor replay instead of the emulator's stats delta."""
    point = cell.point
    crash_step = point.step
    snap = cell.snap
    n = wl.n_steps
    avg_step = avg_cache.at(crash_step, snap.wall_last, snap.modeled_last)
    rec = cell.rec
    lost, redo = _recovery_bookkeeping(rec, crash_step)
    overhead = strat.modeled_overhead_seconds(wl.step_cost_profile(),
                                              wl.emu.cfg, crash_step + 1)
    info = dict(rec.info)
    if point.survival is not None:
        info["torn_bytes_persisted"] = cell.torn_bytes
    return ScenarioResult(
        workload=wl.name, workload_params=wl.params(),
        strategy=strat.name, plan=cell.plan_desc,
        crash_step=crash_step, torn=point.torn,
        torn_survival=(point.survival.describe()
                       if point.survival is not None else None),
        fault=None,  # fault-carrying points route to per-cell fallback
        steps_total=n, steps_done=n,
        restart_point=rec.restart_point, resume_step=rec.resume_step,
        steps_lost=lost, steps_recomputed=redo,
        detect_seconds=rec.detect_seconds, resume_seconds=avg_step * redo,
        avg_step_seconds=avg_step,
        overhead_seconds=overhead,
        modeled_total_seconds=None,
        wall_seconds=time.perf_counter() - t0,
        correct=None,
        correctness_class=classify_recovery(True, crash_step, rec,
                                            point.survival),
        state_certified=None,
        metrics=None,
        traffic=None,
        info=info,
    )


def run_pair_batched(wl: Workload, strat: ConsistencyStrategy,
                     grounded: Sequence[Tuple[CrashPlan, List[CrashPoint]]],
                     progress=None,
                     snapshot_budget_bytes: Optional[int] = None,
                     snapshot_policy: str = "spill") -> List[ScenarioResult]:
    """Evaluate every cell of one set-up (workload, strategy) pair in
    batched mode. Same contract as ``run_pair_forked(mode="measure")``
    minus ``state_certified``: ScenarioResults in plan-major,
    point-minor order, deterministic fields identical cell-for-cell.

    ``snapshot_budget_bytes``/``snapshot_policy`` run the snapshot set
    under the same :class:`~repro_torch.scenarios.sweep_engine.SnapshotTier`
    as the fork engine; batched cells hold tier *handles*, so a
    snapshot evicted between capture and analytic evaluation is
    reloaded (or recomputed from the golden prefix) on access."""
    strat.attach(wl)
    emu = wl.emu
    n = wl.n_steps

    want = set()
    for _plan, points in grounded:
        for p in points:
            want.add((p.step, p.torn) if p.step is not None
                     else (None, False))

    # -- golden forward pass (mirrors run_pair_forked, no certify ladder);
    #    additionally captures the crash context — dirty replacement
    #    queue + region geometry — each survivor replay needs
    need_full = (None, False) in want
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

    ctxs: Dict[Tuple[int, bool], tuple] = {}
    wall: List[float] = []
    modeled: List[float] = []

    def capture_ctx(key):
        order = emu.backend.dirty_eviction_order()
        geometry = {name: emu.backend.entry_geometry(name)
                    for name in {nm for nm, _ in order}}
        ctxs[key] = (order, geometry)

    if tier is not None:
        # pinned tier-0 root every recompute-on-miss can replay from
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
            capture_ctx((i, True))
            # keep capture cost out of the step's recorded duration
            ts = time.perf_counter() - torn_wall
        strat.after_step(i)
        wall.append(time.perf_counter() - ts)
        modeled.append(emu.modeled_seconds() - m0)
        if (i, False) in want:
            snap_put((i, False), _CellSnapshot(wl, strat, wall[-1],
                                               modeled[-1]))
            capture_ctx((i, False))
        if not need_full and i == last_point:
            break
    if need_full:
        snap_put((None, False), _CellSnapshot(wl, strat, 0.0, 0.0),
                 pin=True)
    if tier is not None:
        tier.set_regen(_make_regen(tier, wl, strat))

    # -- split cells: analytic batch vs full/fallback ---------------------
    evaluator, fallback_reason = _make_evaluator(wl, strat)
    if evaluator is None:
        key = (type(wl).__name__, type(strat).__name__, fallback_reason)
        # INFO once per uncovered pair per process (a dense sweep visits
        # the same pair for every plan), DEBUG after
        level = logging.DEBUG if key in _FALLBACK_LOGGED else logging.INFO
        _FALLBACK_LOGGED.add(key)
        _log.log(level,
                 "batched sweep: no analytic evaluator for (%s, %s) "
                 "[%s]; crashed cells fall back to per-cell measure",
                 type(wl).__name__, type(strat).__name__, fallback_reason)
    pending: List[_BatchedCell] = []
    emit: List[tuple] = []      # (kind, plan_desc, point, cell|None)
    for plan, points in grounded:
        desc = plan.describe()
        for point in points:
            if point.step is None:
                emit.append(("full", desc, point, None))
            elif evaluator is None or point.fault is not None:
                # fault cells need the live golden-compare recovery
                # harness (nested-crash retry, media-fault injection) —
                # always the per-cell measure path
                emit.append(("fallback", desc, point, None))
            else:
                key = (point.step, point.torn)
                order, geometry = ctxs[key]
                cell = _BatchedCell(desc, point,
                                    lambda k=key: snap_get(k),
                                    order, geometry)
                pending.append(cell)
                emit.append(("batched", desc, point, cell))

    if pending:
        for cell, rec in zip(pending, evaluator.recover_batch(pending)):
            cell.rec = rec

    # -- emit in plan-major, point-minor order ----------------------------
    avg_cache = _AvgStepCache(wl, wall, modeled)
    results: List[ScenarioResult] = []
    for kind, desc, point, cell in emit:
        t0 = time.perf_counter()
        if kind == "full":
            snap = snap_get((None, False))
            snap.restore(wl, strat)
            res = _finish(wl, strat, point, desc, recover=True,
                          crashed=False, wall_durs=wall,
                          modeled_durs=modeled, t0=t0)
        elif kind == "fallback":
            snap = snap_get((point.step, point.torn))
            snap.restore(wl, strat)
            s = point.step
            res = _measure(wl, strat, point, desc,
                           wall[:s] + [snap.wall_last],
                           modeled[:s] + [snap.modeled_last], t0)
            res.info["batched_fallback"] = (
                "fault-cell" if point.fault is not None
                else fallback_reason)
        else:
            res = _assemble(wl, strat, cell, avg_cache, t0)
        results.append(res)
        if progress is not None:
            progress(res)
    if tier is not None:
        tier_info = tier.stats.to_dict()
        for res in results:
            res.info["snapshot_tier"] = tier_info
        tier.close()
    return results

"""Workload adapters: the paper's three algorithms behind one protocol.

A :class:`Workload` exposes the structure every crash-consistence
mechanism needs — a step axis, named phases, the set of critical
persistent regions, restart-from-scratch, snapshot/restore — plus the
two *algorithm-directed* hooks only ADCC uses (``adcc_*``: the selective
flushes and the invariant-scan recovery).

Workloads run in one of two modes, chosen by the strategy:

  "adcc"   the paper's extended algorithm (versioned CG iterates,
           checksummed two-loop MM, selective-flush XSBench) — the data
           layout ADCC's recovery reasons about;
  "plain"  the unmodified algorithm over persistent regions — what the
           checkpoint / undo-log / native baselines actually protect.

Adapters are extracted from (and delegate to) ``repro_torch.algorithms``:
``CGWorkload`` wraps :class:`~repro_torch.algorithms.cg.ADCC_CG` primitives,
``MMWorkload`` wraps :class:`~repro_torch.algorithms.mm_abft.ABFTMatmul`, and
``XSBenchWorkload`` wraps
:class:`~repro_torch.algorithms.xsbench.ADCC_XSBench`.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..algorithms.cg import ADCC_CG, _sym_matvec, make_spd_system, plain_cg
from ..algorithms.mm_abft import ABFTMatmul
from ..algorithms.xsbench import ADCC_XSBench, XSBenchConfig
from ..core.nvm import CrashEmulator, NVMConfig
from ..core.regions import PersistentRegion
from . import costmodel

__all__ = [
    "RecoveryResult",
    "FinalReport",
    "Workload",
    "CGWorkload",
    "MMWorkload",
    "XSBenchWorkload",
    "WORKLOADS",
    "register_workload",
    "make_workload",
    "unknown_name_error",
]


def unknown_name_error(kind: str, name: str,
                       registered) -> ValueError:
    """Uniform unknown-registry-name error: lists every registered name
    (sorted) and suggests the closest match. Shared by the workload,
    strategy, and sweep-argument validators so a typo'd spec fails the
    same way everywhere — with enough context to fix it — instead of a
    bare KeyError deep inside a worker process."""
    import difflib

    names = sorted(registered)
    msg = f"unknown {kind} {name!r} (registered: {names})"
    close = difflib.get_close_matches(str(name), names, n=1)
    if close:
        msg += f"; did you mean {close[0]!r}?"
    return ValueError(msg)


@dataclasses.dataclass
class RecoveryResult:
    """What a strategy's (or ADCC's) recovery did after a crash."""

    resume_step: int                 # first step index to (re-)execute
    restart_point: int = -1          # newest surviving step; -1 => scratch
    detect_seconds: float = 0.0      # modeled cost of finding the restart
    redo_steps: int = 0              # work re-executed because of the crash
    steps_lost: Optional[int] = None  # completed-work lost; default derived
    from_scratch: bool = False
    info: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FinalReport:
    """End-of-run correctness report (uniform across workloads)."""

    metrics: Dict[str, float]
    correct: bool
    info: Dict[str, object] = dataclasses.field(default_factory=dict)


class Workload(abc.ABC):
    """One crash-consistence experiment subject (setup/step/recover)."""

    name: str = "workload"

    def __init__(self) -> None:
        self.mode: Optional[str] = None

    # -- lifecycle -------------------------------------------------------------
    @abc.abstractmethod
    def setup(self, cfg: Optional[NVMConfig], mode: str) -> None:
        """Allocate emulator state for ``mode`` ("adcc" | "plain")."""

    @property
    @abc.abstractmethod
    def emu(self) -> CrashEmulator: ...

    @property
    @abc.abstractmethod
    def n_steps(self) -> int: ...

    def phases(self) -> Dict[str, range]:
        return {"main": range(self.n_steps)}

    @abc.abstractmethod
    def step(self, i: int) -> None:
        """Execute step i (computation + region writes)."""

    @abc.abstractmethod
    def reset(self) -> None:
        """Reinitialize program state for a restart from scratch."""

    @abc.abstractmethod
    def finalize(self) -> FinalReport: ...

    def params(self) -> Dict[str, object]:
        return {}

    # -- generic strategy support (checkpoint / undo-log / none) ---------------
    def live_regions(self) -> List[PersistentRegion]:
        """Critical data objects a traditional mechanism protects."""
        return []

    def scalar_state(self) -> Dict[str, float]:
        """Small host-side state a snapshot must carry (e.g. CG's rho)."""
        return {}

    def restore(self, arrays: Optional[Dict[str, np.ndarray]],
                scalars: Optional[Dict[str, float]], last_step: int) -> None:
        """Load a consistent snapshot taken at the end of ``last_step``."""
        if arrays:
            by_name = {r.name: r for r in self.live_regions()}
            for name, data in arrays.items():
                if name in by_name:
                    by_name[name][...] = np.asarray(data).reshape(
                        by_name[name].shape)
        if scalars:
            self.restore_scalars(scalars)

    def restore_scalars(self, scalars: Dict[str, float]) -> None:
        pass

    def resync_from_nvm(self) -> None:
        """Reload truth from the (possibly rolled-back) NVM image —
        used after an undo-log rollback mutates the image post-crash."""
        emu = self.emu
        for r in self.live_regions():
            emu.resync_truth(r.name)

    def restart_digest(self, restart_point: int):
        """The semantically-live state at a restart point, as a dict of
        plain arrays/scalars — what a resumed deterministic replay
        actually reads. The fork engine's measure-mode certification
        diffs a recovered digest against the golden-prefix digest at
        the same step (``state_certified``): byte equality means the
        recovery provably landed on consistent state without running
        the tail.

        The default — live-region truth views (uncharged) plus scalar
        state — fits the plain-mode adapters and XSBench (whose loop
        index is a resume *pointer*, already certified via
        ``restart_point``, not replay input). Workloads whose live
        state is a sub-view of their regions (CG's versioned iterates)
        override. Return None to opt out of certification."""
        d = {r.name: r.view.copy() for r in self.live_regions()}
        for k, v in self.scalar_state().items():
            d[f"scalar:{k}"] = v
        return d

    # -- snapshot / fork ---------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Capture the complete mid-run state for the fork sweep engine:
        the emulator snapshot (every region's truth + NVM image + cache
        state + traffic stats) plus host-side scalars (``scalar_state``,
        e.g. CG's rho). Restorable any number of times.

        This is sufficient for all three adapters because every state
        array (CG's versioned p/q/r/z, MM's C_s/C_temp and counters,
        XSBench's macro vector / counters / loop index) lives in
        emulator regions, and sampling is counter-based (SplitMix64 of
        the step index), so there is no live RNG state to carry.
        Workload.step must stay deterministic in (state, i) for forked
        tails to replay exactly — see README "Sweep engine"."""
        return {"emu": self.emu.snapshot(),
                "scalars": dict(self.scalar_state())}

    def restore_snapshot(self, snap: Dict[str, object]) -> None:
        """Reset to a :meth:`snapshot` taken on this instance (in-place:
        regions and the emulator keep their identity)."""
        self.emu.restore(snap["emu"])
        scalars = snap["scalars"]
        if scalars:
            self.restore_scalars(dict(scalars))

    # -- recovery audit ----------------------------------------------------------
    def audit_recovery(self, rec: "RecoveryResult", crash_step: int,
                       torn: bool) -> None:
        """Oracle-side audit of the just-recovered state, called by the
        driver immediately after ``strategy.recover(...)`` (before any
        tail replay or certification). Serving-style workloads override
        this to check the recovered store against the acknowledged
        request prefix and record violation counts in ``rec.info``
        (``durability_violations`` — an acknowledged update is missing
        or stale; ``atomicity_violations`` — partially-applied state is
        reader-visible), which ``classify_recovery`` maps to the
        ``durability_violation`` / ``atomicity_violation`` classes.

        Must be deterministic in the recovered state and side-effect
        free on regions/traffic (read via uncharged ``.view``s): its
        ``rec.info`` entries are part of the engine-invariance contract.
        The default is a no-op. The batched engine's analytic
        evaluators synthesize RecoveryResults without running live
        recovery, so a workload that overrides this needs a matching
        evaluator that reproduces the audit from the request oracle or
        the crash image;
        unknown auditing workloads take the per-cell measure fallback
        instead (``info["batched_fallback"] = "audit-override:..."``)."""

    # -- ADCC hooks -------------------------------------------------------------
    def adcc_before_step(self, i: int) -> None:
        pass

    def adcc_after_step(self, i: int) -> None:
        pass

    def adcc_recover(self, crash_step: int) -> RecoveryResult:
        raise NotImplementedError(
            f"workload {self.name!r} has no ADCC recovery")

    # -- cost model --------------------------------------------------------------
    def step_cost_profile(self) -> costmodel.StepCostProfile:
        raise NotImplementedError

    def _check_mode(self, mode: str) -> None:
        if mode not in ("adcc", "plain"):
            raise ValueError(f"unknown workload mode {mode!r}")


# ---------------------------------------------------------------------------
# input caches (sweep() runs many cells over identical problem inputs)
# ---------------------------------------------------------------------------

_SPD_CACHE: Dict[Tuple[int, int, int], Tuple[object, np.ndarray]] = {}
_CG_ORACLE_CACHE: Dict[Tuple[int, int, int, int], np.ndarray] = {}
_MM_CACHE: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def _spd_system(n: int, nnz: int, seed: int):
    key = (n, nnz, seed)
    if key not in _SPD_CACHE:
        _SPD_CACHE[key] = make_spd_system(n, nnz_per_row=nnz, seed=seed)
    return _SPD_CACHE[key]


def _cg_oracle(n: int, nnz: int, seed: int, iters: int) -> np.ndarray:
    key = (n, nnz, seed, iters)
    if key not in _CG_ORACLE_CACHE:
        A, b = _spd_system(n, nnz, seed)
        _CG_ORACLE_CACHE[key] = plain_cg(A, b, iters)
    return _CG_ORACLE_CACHE[key]


def _mm_inputs(n: int, seed: int):
    key = (n, seed)
    if key not in _MM_CACHE:
        rng = np.random.default_rng(seed)
        A = rng.uniform(-1, 1, (n, n))
        B = rng.uniform(-1, 1, (n, n))
        _MM_CACHE[key] = (A, B, A @ B)
    return _MM_CACHE[key]


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

class CGWorkload(Workload):
    """Conjugate gradient (paper §III.B)."""

    name = "cg"

    def __init__(self, n: int = 2048, iters: int = 12, nnz_per_row: int = 8,
                 seed: int = 0, emulate_reads: bool = True,
                 impl: Optional[ADCC_CG] = None):
        super().__init__()
        if impl is not None:
            n, iters = impl.A.n, impl.iters
        self.n, self.iters = n, iters
        self.nnz_per_row, self.seed = nnz_per_row, seed
        self.emulate_reads = emulate_reads
        self._impl = impl
        # a pre-built impl carries its own A/b; the (n, nnz, seed) cache
        # would regenerate a *different* system for the oracle
        self._ext_inputs = impl is not None
        self._oracle: Optional[np.ndarray] = None
        self._rho = 0.0

    def params(self):
        return {"n": self.n, "iters": self.iters, "seed": self.seed}

    def setup(self, cfg, mode):
        self._check_mode(mode)
        self.mode = mode
        if self._impl is not None:   # legacy bridge: pre-built ADCC_CG
            if mode != "adcc":
                raise ValueError("pre-built ADCC_CG implies adcc mode")
            self.A, self.b = self._impl.A, self._impl.b
            self._rho = self._impl._init_iterates()
            return
        self.A, self.b = _spd_system(self.n, self.nnz_per_row, self.seed)
        if mode == "adcc":
            self._impl = ADCC_CG(self.A, self.b, self.iters, cfg,
                                 emulate_reads=self.emulate_reads)
            self._rho = self._impl._init_iterates()
            return
        # plain mode: the unmodified algorithm over single-copy regions
        self._emu = CrashEmulator(cfg or NVMConfig())
        emu = self._emu
        self._rA = emu.alloc("A.data", self.A.data.shape, np.float64,
                             init=self.A.data, sector_lines=16)
        self._rAi = emu.alloc("A.indices", self.A.indices.shape, np.int32,
                              init=self.A.indices, sector_lines=16)
        self._rb = emu.alloc("b", self.b.shape, np.float64, init=self.b,
                             sector_lines=16)
        for reg in (self._rA, self._rAi, self._rb):
            reg.flush()
        self._rp = emu.alloc("p", (self.n,), np.float64, sector_lines=4)
        self._rq = emu.alloc("q", (self.n,), np.float64, sector_lines=4)
        self._rr = emu.alloc("r", (self.n,), np.float64, sector_lines=4)
        self._rz = emu.alloc("z", (self.n,), np.float64, sector_lines=4)
        self.reset()

    @property
    def emu(self):
        return self._impl.emu if self.mode == "adcc" else self._emu

    @property
    def n_steps(self):
        return self.iters

    def _touch_matvec_reads(self):
        if self.emulate_reads:
            self.emu.read("A.data", 0, self.A.data.shape[0])
            self.emu.read("A.indices", 0, self.A.indices.shape[0])

    def step(self, i):
        if self.mode == "adcc":
            self._rho = self._impl._iterate(i, self._rho)
            return
        self._touch_matvec_reads()
        p = self._rp[...]
        q = _sym_matvec(self.A, p)
        self._rq[...] = q
        pq = float(p @ q)
        if pq <= 0.0 or self._rho == 0.0:
            return  # converged: iterates carry forward unchanged
        alpha = self._rho / pq
        self._rz[...] = self._rz[...] + alpha * p
        r_new = self._rr[...] - alpha * q
        self._rr[...] = r_new
        rho_new = float(r_new @ r_new)
        beta = rho_new / self._rho
        self._rho = rho_new
        self._rp[...] = r_new + beta * p

    def reset(self):
        if self.mode == "adcc":
            self._rho = self._impl._init_iterates()
            return
        self._rz[...] = np.zeros(self.n)
        self._rq[...] = np.zeros(self.n)
        self._rr[...] = self.b
        self._rp[...] = self.b
        self._rho = float(self.b @ self.b)

    def live_regions(self):
        if self.mode == "adcc":
            return [self._impl.p.region, self._impl.q.region,
                    self._impl.r.region, self._impl.z.region]
        return [self._rp, self._rq, self._rr, self._rz]

    def scalar_state(self):
        return {"rho": self._rho}

    def restore_scalars(self, scalars):
        self._rho = float(scalars["rho"])

    # -- ADCC --------------------------------------------------------------------
    def adcc_recover(self, crash_step):
        impl = self._impl
        outcome = impl.recover(upper_iter=impl.counter.nvm_value())
        restart = outcome.restart_point
        if restart >= 0:
            impl.p.set(restart + 1, impl.p.nvm_version(restart + 1))
            impl.q.set(restart, impl.q.nvm_version(restart))
            impl.r.set(restart + 1, impl.r.nvm_version(restart + 1))
            impl.z.set(restart + 1, impl.z.nvm_version(restart + 1))
            r_cur = impl.r.get(restart + 1)
            self._rho = float(r_cur @ r_cur)
            resume = restart + 1
            lost = crash_step - restart
        else:
            self._rho = impl._init_iterates()
            resume = 0
            lost = crash_step + 1
        return RecoveryResult(
            resume_step=resume, restart_point=restart,
            detect_seconds=outcome.detection_seconds,
            redo_steps=crash_step + 1 - resume, steps_lost=lost,
            from_scratch=restart < 0,
            info={"recovery": outcome, "iterations_lost": lost,
                  # the invariant scan rejected >= 1 candidate version:
                  # it positively identified inconsistent (torn) state
                  "torn_flagged": outcome.candidates_tested > 1})

    def restart_digest(self, restart_point):
        if self.mode != "adcc":
            return super().restart_digest(restart_point)
        # live state is the version-indexed iterate views, not the whole
        # versioned regions (older/newer slots legitimately differ from
        # the golden prefix after a torn crash); uncharged truth reads
        impl, j = self._impl, restart_point
        return {"p": impl.p.region.view[j + 1].copy(),
                "q": impl.q.region.view[j].copy(),
                "r": impl.r.region.view[j + 1].copy(),
                "z": impl.z.region.view[j + 1].copy(),
                "scalar:rho": self._rho}

    def step_cost_profile(self):
        return costmodel.cg_step_profile(self.n, self.emu.cfg.line_bytes)

    def finalize(self):
        if self.mode == "adcc":
            z = self._impl.z.get(self.iters)
        else:
            z = self._rz[...]
        if self._oracle is None:
            self._oracle = (plain_cg(self.A, self.b, self.iters)
                            if self._ext_inputs else
                            _cg_oracle(self.n, self.nnz_per_row, self.seed,
                                       self.iters))
        oracle = self._oracle
        max_err = float(np.max(np.abs(z - oracle)))
        bnorm = float(np.linalg.norm(self.b)) + 1e-300
        resid = float(np.linalg.norm(self.b - _sym_matvec(self.A, z))) / bnorm
        scale = max(1.0, float(np.max(np.abs(oracle))))
        return FinalReport(
            metrics={"max_abs_err": max_err, "rel_residual": resid},
            correct=max_err <= 1e-7 * scale,
            info={"z": z})


# ---------------------------------------------------------------------------
# ABFT matrix multiplication
# ---------------------------------------------------------------------------

class MMWorkload(Workload):
    """Two-loop ABFT matmul (paper §III.C) / plain rank-k-update matmul."""

    name = "mm"

    def __init__(self, n: int = 128, k: int = 32, seed: int = 0,
                 impl: Optional[ABFTMatmul] = None):
        super().__init__()
        if impl is not None:
            n, k = impl.n, impl.k
        self.n, self.k, self.seed = n, k, seed
        self._impl = impl

    def params(self):
        return {"n": self.n, "k": self.k, "seed": self.seed}

    def setup(self, cfg, mode):
        self._check_mode(mode)
        self.mode = mode
        if self._impl is not None:
            if mode != "adcc":
                raise ValueError("pre-built ABFTMatmul implies adcc mode")
            self.A_np, self.B_np = self._impl.A, self._impl.B
            self._oracle = self.A_np @ self.B_np
            return
        self.A_np, self.B_np, self._oracle = _mm_inputs(self.n, self.seed)
        if mode == "adcc":
            self._impl = ABFTMatmul(self.A_np, self.B_np, self.k, cfg)
            return
        self._emu = CrashEmulator(cfg or NVMConfig())
        emu = self._emu
        n = self.n
        self._rA = emu.alloc("A", (n, n), np.float64, init=self.A_np,
                             sector_lines=16)
        self._rB = emu.alloc("B", (n, n), np.float64, init=self.B_np,
                             sector_lines=16)
        self._rA.flush(); self._rB.flush()
        self._rC = emu.alloc("C", (n, n), np.float64, sector_lines=8)

    @property
    def emu(self):
        return self._impl.emu if self.mode == "adcc" else self._emu

    @property
    def nchunks(self):
        return self.n // self.k

    @property
    def n_steps(self):
        if self.mode == "adcc":
            return self._impl.nchunks + len(self._impl.row_blocks)
        return self.nchunks

    def phases(self):
        if self.mode == "adcc":
            nc = self._impl.nchunks
            return {"loop1": range(nc), "loop2": range(nc, self.n_steps)}
        return {"loop1": range(self.nchunks)}

    def step(self, i):
        if self.mode == "adcc":
            nc = self._impl.nchunks
            if i < nc:
                self._impl._loop1_chunk(i)
            else:
                self._impl._loop2_block(i - nc)
            return
        n, k = self.n, self.k
        self.emu.read("A", 0, n * n)
        self.emu.read("B", i * k * n, (i + 1) * k * n)
        acc = self._rC[...]
        block = self.A_np[:, i * k:(i + 1) * k] @ self.B_np[i * k:(i + 1) * k, :]
        self._rC[...] = acc + block

    def reset(self):
        if self.mode == "adcc":
            # versioned-by-construction layout: recomputing chunk s simply
            # overwrites C_s, so scratch restart = run every step again
            return
        self._rC[...] = np.zeros((self.n, self.n))

    def live_regions(self):
        if self.mode == "adcc":
            return list(self._impl.C_s) + [self._impl.C_temp]
        return [self._rC]

    # -- ADCC --------------------------------------------------------------------
    def adcc_recover(self, crash_step):
        impl = self._impl
        nc = impl.nchunks
        # re-executions run with replay=True: the persisted progress
        # counter stays pinned at its crash-time value, so a nested crash
        # anywhere inside recovery re-enters with the same scan range and
        # the retry provably lands on the same state (idempotence).
        if crash_step < nc:
            bad, corrected, detect = impl._recover_loop1()
            for sb in bad:
                impl._loop1_chunk(sb, replay=True)
            lost, crashed_in = len(bad), "loop1"
        else:
            blocks_done = crash_step - nc + 1
            bad_chunks, corrected, d1 = impl._recover_loop1()
            for sb in bad_chunks:
                impl._loop1_chunk(sb, replay=True)
            bad_blocks, d2 = impl._recover_loop2(blocks_done)
            detect = d1 + d2
            for bb in bad_blocks:
                impl._loop2_block(bb, replay=True)
            lost, crashed_in = len(bad_blocks), "loop2"
        return RecoveryResult(
            resume_step=crash_step + 1, restart_point=crash_step,
            detect_seconds=detect, redo_steps=lost, steps_lost=lost,
            info={"crashed_in": crashed_in, "chunks_lost": lost,
                  "corrected_elements": corrected,
                  # checksums flagged bad chunks/blocks or corrected
                  # elements: the ABFT machinery caught torn state
                  "torn_flagged": lost > 0 or corrected > 0})

    def step_cost_profile(self):
        return costmodel.mm_step_profile(self.n, self.emu.cfg.line_bytes)

    def finalize(self):
        if self.mode == "adcc":
            from ..core import abft
            C = abft.strip(self._impl.C_temp.view.copy())
        else:
            C = self._rC[...]
        max_err = float(np.max(np.abs(C - self._oracle)))
        scale = max(1.0, float(np.max(np.abs(self._oracle))))
        return FinalReport(
            metrics={"max_error": max_err},
            correct=max_err <= 1e-8 * scale,
            info={"C": C})


# ---------------------------------------------------------------------------
# XSBench Monte-Carlo lookups
# ---------------------------------------------------------------------------

class XSBenchWorkload(Workload):
    """Monte-Carlo cross-section lookups (paper §III.D).

    ``policy`` selects the *ADCC design* ("selective" is the paper's fix,
    "basic" its Fig.-10 failing scheme, "every" the 16%-overhead
    strawman); it only matters under the ``adcc`` strategy.
    """

    name = "xsbench"

    def __init__(self, lookups: int = 1500, grid_points: int = 2000,
                 n_nuclides: int = 8, n_materials: int = 6,
                 max_nuclides_per_material: int = 4,
                 flush_every_frac: float = 0.01, seed: int = 7,
                 policy: str = "selective",
                 impl: Optional[ADCC_XSBench] = None):
        super().__init__()
        self.policy = policy if impl is None else impl.policy
        if impl is not None:
            self._cfg = impl.cfg
        else:
            self._cfg = XSBenchConfig(
                n_nuclides=n_nuclides, grid_points=grid_points,
                n_materials=n_materials,
                max_nuclides_per_material=max_nuclides_per_material,
                lookups=lookups, flush_every_frac=flush_every_frac,
                seed=seed)
        self._impl = impl

    def params(self):
        c = self._cfg
        return {"lookups": c.lookups, "grid_points": c.grid_points,
                "policy": self.policy, "seed": c.seed}

    def setup(self, cfg, mode):
        self._check_mode(mode)
        self.mode = mode
        if self._impl is None:
            # plain mode never flushes, so the impl policy is irrelevant;
            # reuse the same lookup kernel either way
            self._impl = ADCC_XSBench(
                self._cfg, cfg,
                policy=self.policy if self.policy != "none" else "selective")

    @property
    def emu(self):
        return self._impl.emu

    @property
    def n_steps(self):
        return self._cfg.lookups

    def step(self, i):
        self._impl._lookup(i)

    def reset(self):
        impl = self._impl
        impl._macro[...] = np.zeros(impl._macro.shape)
        for c in impl._counters:
            c[0] = 0
        impl._index[0] = 0

    def live_regions(self):
        impl = self._impl
        return [impl._macro] + list(impl._counters)

    # -- ADCC --------------------------------------------------------------------
    def adcc_before_step(self, i):
        if self.policy == "basic":
            impl = self._impl
            impl._index[0] = i
            impl._index.flush()

    def adcc_after_step(self, i):
        impl = self._impl
        if self.policy == "every":
            impl._flush_critical(i + 1)
        elif self.policy == "selective" and (i + 1) % impl.flush_every == 0:
            impl._flush_critical(i + 1)

    def adcc_recover(self, crash_step):
        impl = self._impl
        crashed_lookups = crash_step + 1
        resume_i = int(impl._index.nvm[0])
        counted = int(sum(int(c.view[0]) for c in impl._counters))
        lost = max(0, resume_i - counted) + (crashed_lookups - resume_i)
        # counter/index mismatch is the counters' torn-state signal.
        # counted < resume_i: updates lost (Fig. 10). counted > resume_i:
        # increments beyond the persisted index survived a torn crash —
        # replay from resume_i will RE-count them, so the recovered
        # state is positively corrupt (no repair exists: the extra
        # counts cannot be attributed and un-counted)
        return RecoveryResult(
            resume_step=resume_i, restart_point=resume_i - 1,
            redo_steps=crashed_lookups - resume_i, steps_lost=lost,
            from_scratch=resume_i == 0,
            info={"iterations_lost": lost,
                  "torn_flagged": counted != resume_i,
                  "state_corrupt": counted > resume_i})

    def step_cost_profile(self):
        line = self.emu.cfg.line_bytes
        if self.policy == "basic":
            # index-only flush, every lookup (Fig. 10's failing scheme)
            return costmodel.StepCostProfile(
                ckpt_bytes=8, log_bytes=line, adcc_bytes=line,
                adcc_lines=1, interval_steps=1, hdd_latency_s=5e-3)
        interval = 1 if self.policy == "every" else self._impl.flush_every
        return costmodel.xsbench_step_profile(line, interval_steps=interval)

    def finalize(self):
        impl = self._impl
        counts = np.array([int(c.view[0]) for c in impl._counters])
        total = max(1, int(counts.sum()))
        fractions = counts / total
        spread = float(np.max(fractions) - np.min(fractions))
        return FinalReport(
            metrics={"counts_total": float(counts.sum()),
                     "fraction_spread": spread},
            correct=int(counts.sum()) == self._cfg.lookups,
            info={"counts": counts, "fractions": fractions,
                  "macro_xs": impl._macro.view.copy()})


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

WORKLOADS: Dict[str, Callable[..., Workload]] = {
    "cg": CGWorkload,
    "mm": MMWorkload,
    "xsbench": XSBenchWorkload,
}


def register_workload(name: str, factory: Callable[..., Workload], *,
                      override: bool = False) -> None:
    """Register a workload factory under ``name``.

    Re-registering an existing name raises (a silent overwrite would
    make every subsequent sweep spec mean something else) unless the
    factory is identical (idempotent re-import) or ``override=True``.
    """
    if not override and name in WORKLOADS and WORKLOADS[name] is not factory:
        raise ValueError(
            f"workload {name!r} already registered "
            f"(registered: {sorted(WORKLOADS)}); pass override=True "
            f"to replace it")
    WORKLOADS[name] = factory


def make_workload(spec) -> Workload:
    """spec: Workload instance | "name" | ("name", {params})."""
    if isinstance(spec, Workload):
        return spec
    if isinstance(spec, str):
        name, kwargs = spec, {}
    else:
        name, kwargs = spec
    if name not in WORKLOADS:
        raise unknown_name_error("workload", name, WORKLOADS)
    return WORKLOADS[name](**dict(kwargs))

"""Conjugate Gradient with algorithm-directed crash consistence (§III.B).

Implements Fig. 2 of the paper: the four hot vectors p, q, r, z gain an
iteration dimension (VersionedArray), only the cache line holding the
iteration counter is flushed per iteration, and recovery backward-scans
iterations testing the two algorithm invariants

    Eq. 1:  p^(i+1) . q^(i) = 0            (A-conjugacy of directions)
    Eq. 2:  r^(i+1) = b - A z^(i+1)        (residual equality)

against the post-crash NVM image until a consistent iteration is found.

Note on the paper's pseudocode: Fig. 1/2 contain two classic typos
(line 7 should be ``r <- r - alpha*q`` and line 10 ``p <- r + beta*p``;
p must be initialized to r). We implement standard CG — the invariants
the paper states (Eqs. 1-2) hold for it exactly.

The sparse matrix is CSR, built as an NPB-CG-style random SPD system;
its data/index arrays live in NVM as read-only regions registered with
coarse cache sectors (DESIGN.md §7) so matvec read-traffic creates the
eviction pressure the paper's performance characterization relies on.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core.invariants import InvariantSet, OrthogonalityInvariant, ResidualInvariant
from ..core.nvm import CrashEmulator, NVMConfig
from ..core.recovery import RecoveryOutcome, backward_scan
from ..core.versioned import FlushedCounter, VersionedArray

__all__ = ["CsrMatrix", "make_spd_system", "CGRunResult", "ADCC_CG", "plain_cg"]


@dataclasses.dataclass
class CsrMatrix:
    """Minimal CSR sparse matrix (numpy-only; scipy is not installed)."""

    n: int
    data: np.ndarray      # (nnz,) float64
    indices: np.ndarray   # (nnz,) int32 column ids
    indptr: np.ndarray    # (n+1,) int64

    def matvec(self, x: np.ndarray) -> np.ndarray:
        prod = self.data * x[self.indices]
        # rows are equal-width in our generator; general path via reduceat
        return np.add.reduceat(prod, self.indptr[:-1])

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def nbytes(self) -> int:
        return self.data.nbytes + self.indices.nbytes + self.indptr.nbytes


def make_spd_system(n: int, nnz_per_row: int = 8, seed: int = 0
                    ) -> Tuple[CsrMatrix, np.ndarray]:
    """Random symmetric positive-definite CSR system (diagonally dominant),
    NPB-CG-flavoured: fixed nnz per row, random off-diagonal pattern."""
    rng = np.random.default_rng(seed)
    k = max(2, nnz_per_row)
    cols = np.empty((n, k), dtype=np.int32)
    vals = np.empty((n, k), dtype=np.float64)
    off = rng.integers(0, n, size=(n, k - 1), dtype=np.int64)
    offv = rng.uniform(-1.0, 1.0, size=(n, k - 1)) * 0.5 / (k - 1)
    # symmetrize implicitly by diagonal dominance (sufficient for SPD here):
    cols[:, :-1] = off
    vals[:, :-1] = offv
    cols[:, -1] = np.arange(n, dtype=np.int32)
    vals[:, -1] = 1.0 + np.abs(offv).sum(axis=1) + rng.uniform(0.1, 1.0, size=n)
    # CSR with equal-width rows; sort columns within the row for realism
    order = np.argsort(cols, axis=1)
    cols = np.take_along_axis(cols, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    A_unsym = CsrMatrix(
        n=n,
        data=vals.reshape(-1),
        indices=cols.reshape(-1),
        indptr=np.arange(0, n * k + 1, k, dtype=np.int64),
    )
    # make it symmetric: A := (A + A^T)/2 done implicitly by using
    # M(x) = 0.5*(A x + A^T x); cheaper: build normal-equations-free SPD by
    # keeping the unsymmetric pattern but using A^T A would square cond.
    # Diagonal dominance already gives positive-definiteness of (A+A^T)/2,
    # so expose the symmetrized operator while storing A once.
    return A_unsym, rng.uniform(-1.0, 1.0, size=n)


def _sym_matvec(A: CsrMatrix, x: np.ndarray) -> np.ndarray:
    """(A + A^T)/2 @ x without materializing A^T: scatter-add transpose."""
    ax = A.matvec(x)
    prod = A.data * np.repeat(x, np.diff(A.indptr))
    atx = np.bincount(A.indices, weights=prod, minlength=A.n)
    return 0.5 * (ax + atx)


def plain_cg(A: CsrMatrix, b: np.ndarray, iters: int) -> np.ndarray:
    """Reference CG (no persistence machinery) — the oracle."""
    n = A.n
    z = np.zeros(n)
    r = b.copy()
    p = r.copy()
    rho = float(r @ r)
    for _ in range(iters):
        q = _sym_matvec(A, p)
        pq = float(p @ q)
        if pq <= 0.0 or rho == 0.0:   # converged (or numerically exhausted)
            break
        alpha = rho / pq
        z = z + alpha * p
        r = r - alpha * q
        rho_new = float(r @ r)
        beta = rho_new / rho
        rho = rho_new
        p = r + beta * p
    return z


@dataclasses.dataclass
class CGRunResult:
    z: np.ndarray
    iters_done: int
    crashed_at: Optional[int]
    restart_iter: Optional[int]
    iterations_lost: Optional[int]
    detect_seconds: float
    resume_seconds: float
    avg_iter_seconds: float
    modeled_overhead_seconds: float
    recovery: Optional[RecoveryOutcome] = None


class ADCC_CG:
    """CG with the paper's ADCC extension over the crash emulator."""

    def __init__(self, A: CsrMatrix, b: np.ndarray, iters: int,
                 cfg: Optional[NVMConfig] = None, emulate_reads: bool = True):
        self.A, self.b, self.iters = A, b, iters
        self.emu = CrashEmulator(cfg or NVMConfig())
        self.emulate_reads = emulate_reads
        n = A.n
        V = iters + 2  # versions 0..iters+1
        # big read-mostly regions get coarse sectors (16 lines = 1KB)
        self._rA = self.emu.alloc("A.data", A.data.shape, np.float64,
                                  init=A.data, sector_lines=16)
        self._rAi = self.emu.alloc("A.indices", A.indices.shape, np.int32,
                                   init=A.indices, sector_lines=16)
        self._rb = self.emu.alloc("b", b.shape, np.float64, init=b, sector_lines=16)
        self.p = VersionedArray(self.emu, "p", V, n, sector_lines=4)
        self.q = VersionedArray(self.emu, "q", V, n, sector_lines=4)
        self.r = VersionedArray(self.emu, "r", V, n, sector_lines=4)
        self.z = VersionedArray(self.emu, "z", V, n, sector_lines=4)
        self.counter = FlushedCounter(self.emu, "iter")
        # inputs are persisted once up-front (they are program inputs)
        for reg in (self._rA, self._rAi, self._rb):
            reg.flush()

    # -- one CG iteration against the emulator ---------------------------------
    def _touch_matvec_reads(self) -> None:
        if self.emulate_reads:
            self.emu.read("A.data", 0, self.A.data.shape[0])
            self.emu.read("A.indices", 0, self.A.indices.shape[0])

    def _iterate(self, i: int, rho: float) -> float:
        """Iteration i: consumes version i, produces version i+1."""
        self.counter.set(i)                      # flush one cache line
        p_i = self.p.get(i)
        self._touch_matvec_reads()
        q_i = _sym_matvec(self.A, p_i)
        self.q.set(i, q_i)
        pq = float(p_i @ q_i)
        if pq <= 0.0 or rho == 0.0:
            # converged: carry the iterates forward unchanged (restarting
            # anywhere past convergence yields the same solution)
            self.z.set(i + 1, self.z.get(i))
            self.r.set(i + 1, self.r.get(i))
            self.p.set(i + 1, p_i)
            return rho
        alpha = rho / pq
        self.z.set(i + 1, self.z.get(i) + alpha * p_i)
        r_next = self.r.get(i) - alpha * q_i
        self.r.set(i + 1, r_next)
        rho_new = float(r_next @ r_next)
        beta = rho_new / rho if rho > 0 else 0.0
        self.p.set(i + 1, r_next + beta * p_i)
        return rho_new

    def _init_iterates(self) -> float:
        n = self.A.n
        r0 = self.b.copy()  # z0 = 0
        self.z.set(0, np.zeros(n))
        self.r.set(0, r0)
        self.p.set(0, r0)
        return float(r0 @ r0)

    # -- driver -----------------------------------------------------------------
    def run(self, crash_at_iter: Optional[int] = None) -> CGRunResult:
        """Deprecated: run CG, optionally crashing at the *end* of
        iteration ``crash_at_iter`` (after its stores, before the next
        counter flush), then recover and resume to completion.

        This is a legacy shim over the unified scenario driver — use
        ``repro_torch.scenarios.run_scenario(("cg", {...}), "adcc", plan)``.
        """
        warnings.warn(
            "ADCC_CG.run() is deprecated; use repro_torch.scenarios.run_scenario("
            "('cg', params), 'adcc', CrashPlan.at_step(k))",
            DeprecationWarning, stacklevel=2)
        from ..scenarios import CrashPlan, run_scenario
        from ..scenarios.workloads import CGWorkload

        # old semantics: a crash point past the last iteration never fires
        plan = (CrashPlan.at_step(crash_at_iter)
                if crash_at_iter is not None and 0 <= crash_at_iter < self.iters
                else CrashPlan.no_crash())
        res = run_scenario(CGWorkload(impl=self), "adcc", plan)
        return CGRunResult(
            z=res.info["z"], iters_done=self.iters,
            crashed_at=res.crash_step, restart_iter=res.restart_point,
            iterations_lost=res.info.get("iterations_lost"),
            detect_seconds=res.detect_seconds,
            resume_seconds=res.resume_seconds,
            avg_iter_seconds=res.avg_step_seconds,
            modeled_overhead_seconds=res.modeled_total_seconds,
            recovery=res.info.get("recovery"),
        )

    # -- recovery ------------------------------------------------------------------
    def recover(self, upper_iter: int) -> RecoveryOutcome:
        """Backward-scan from the persisted counter, checking Eqs. 1-2
        against the NVM image."""
        b_nvm = self._rb.nvm.copy()

        def load(j: int) -> Dict[str, np.ndarray]:
            return {
                "p_next": self.p.nvm_version(j + 1),
                "q_cur": self.q.nvm_version(j),
                "r_next": self.r.nvm_version(j + 1),
                "z_next": self.z.nvm_version(j + 1),
            }

        def invs(_j: int) -> InvariantSet:
            return InvariantSet([
                OrthogonalityInvariant("p_next", "q_cur", tol=1e-7),
                ResidualInvariant("r_next", "z_next", b=b_nvm,
                                  matvec=lambda x: _sym_matvec(self.A, x),
                                  tol=1e-6),
            ])

        def charge(data: Dict[str, np.ndarray]) -> float:
            nbytes = sum(a.nbytes for a in data.values()) + self.A.nbytes()
            return nbytes / self.emu.cfg.read_bw

        return backward_scan(upper_iter, 0, load, invs, charge)

"""ABFT matrix multiplication with crash consistence (§III.C, Fig. 6).

The original ABFT rank-k-update loop (Fig. 5) cannot establish restartable
state: C_f is overwritten every iteration and its checksums only hold at
iteration boundaries. The paper's extension (Fig. 6) decomposes it into

  loop 1 — submatrix multiplications:  C_s_temp = A_c[:, s-block] @ B_r[s-block, :]
           each C_s_temp carries full row+column checksums; only the
           checksums are flushed (one row + one column per chunk);
  loop 2 — row-blocked additions into C_temp whose *row* checksums are
           established once per k-row block, flushed, and never
           overwritten afterwards.

After a crash, the checksum relationships (Eq. 6) identify exactly which
C_s_temp chunks / C_temp row blocks are consistent in NVM; torn ones are
recomputed (or, when the damage is a single element, corrected in place).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import abft
from ..core.nvm import CrashEmulator, NVMConfig
from ..core.regions import PersistentRegion
from ..core.versioned import FlushedCounter

__all__ = ["ABFTMatmul", "MMRunResult"]


@dataclasses.dataclass
class MMRunResult:
    C: np.ndarray                      # the (n, n) result (checksums stripped)
    crashed_in: Optional[str]          # None | "loop1" | "loop2"
    chunks_lost: int                   # inconsistent chunks / row-blocks
    corrected_elements: int            # fixed via checksums w/o recompute
    detect_seconds: float
    resume_seconds: float
    avg_chunk_seconds: float
    modeled_overhead_seconds: float
    max_error: float                   # vs numpy oracle


class ABFTMatmul:
    """C = A @ B with ABFT checksums and ADCC over the crash emulator."""

    def __init__(self, A: np.ndarray, B: np.ndarray, k: int,
                 cfg: Optional[NVMConfig] = None):
        n = A.shape[0]
        assert A.shape == (n, n) and B.shape == (n, n), "square matrices"
        assert n % k == 0, "contraction dim must be divisible by rank k"
        self.n, self.k = n, k
        self.nchunks = n // k
        self.A, self.B = np.asarray(A, np.float64), np.asarray(B, np.float64)
        self.Ac = abft.encode_cols(self.A)     # (n+1, n)
        self.Br = abft.encode_rows(self.B)     # (n, n+1)
        self.emu = CrashEmulator(cfg or NVMConfig())
        # inputs in NVM (read-mostly, coarse sectors), persisted up-front
        self._rAc = self.emu.alloc("Ac", self.Ac.shape, np.float64,
                                   init=self.Ac, sector_lines=16)
        self._rBr = self.emu.alloc("Br", self.Br.shape, np.float64,
                                   init=self.Br, sector_lines=16)
        self._rAc.flush(); self._rBr.flush()
        # per-chunk temporaries, each (n+1, n+1) with full checksums
        self.C_s: List[PersistentRegion] = [
            self.emu.alloc(f"C_s{s}", (n + 1, n + 1), np.float64, sector_lines=8)
            for s in range(self.nchunks)
        ]
        # accumulation target with row checksums
        self.C_temp = self.emu.alloc("C_temp", (n + 1, n + 1), np.float64,
                                     sector_lines=8)
        self.counter = FlushedCounter(self.emu, "mm_iter")
        # row-block decomposition of loop 2 over the n+1 rows
        self.row_blocks: List[Tuple[int, int]] = []
        r0 = 0
        while r0 < n + 1:
            self.row_blocks.append((r0, min(r0 + k, n + 1)))
            r0 = self.row_blocks[-1][1]

    # -- the two loops ------------------------------------------------------
    def _loop1_chunk(self, s: int, replay: bool = False) -> None:
        """C_s_temp = Ac[:, s*k:(s+1)*k] @ Br[s*k:(s+1)*k, :] + flush its
        checksum row and column. ``replay=True`` (recovery re-execution)
        must not advance the persisted progress counter: a nested crash
        mid-recovery would otherwise strand the counter past chunks whose
        data never persisted, shrinking the next attempt's scan range."""
        if not replay:
            self.counter.set(s)  # which chunk we are in (one line flush)
        k, n = self.k, self.n
        self.emu.read("Ac", 0, self.Ac.size)                 # stream inputs
        self.emu.read("Br", s * k * (n + 1), (s + 1) * k * (n + 1))
        block = self.Ac[:, s * k:(s + 1) * k] @ self.Br[s * k:(s + 1) * k, :]
        reg = self.C_s[s]
        reg[...] = block
        # flush row checksums (last column) and column checksums (last row):
        # the last row is contiguous; the last column is flushed per row
        # block to respect row-major line spans.
        reg.flush((n, slice(None)))                    # checksum row
        for (lo, hi) in self.row_blocks:               # checksum column cells
            for i in range(lo, min(hi, n)):
                reg.flush((i, slice(n, n + 1)))

    def _loop2_block(self, bi: int, replay: bool = False) -> None:
        """C_temp[rows] = sum_s C_s[rows]; flush the block's row checksums.
        ``replay=True``: see ``_loop1_chunk`` — recovery re-execution keeps
        the progress counter pinned at its crash-time value."""
        if not replay:
            self.counter.set(self.nchunks + bi)
        lo, hi = self.row_blocks[bi]
        acc = np.zeros((hi - lo, self.n + 1))
        for s in range(self.nchunks):
            self.emu.read(f"C_s{s}", lo * (self.n + 1), hi * (self.n + 1))
            acc += self.C_s[s].view[lo:hi, :]
        self.C_temp[lo:hi, :] = acc
        for i in range(lo, hi):                        # row checksum cells
            self.C_temp.flush((i, slice(self.n, self.n + 1)))

    # -- driver ---------------------------------------------------------------
    def run(self, crash_after: Optional[Tuple[str, int]] = None) -> MMRunResult:
        """Deprecated: run the two-loop ABFT MM. ``crash_after=("loop1",
        s)`` crashes right after chunk s of loop 1 completes (paper's
        crash test 1); ``("loop2", b)`` after row-block b of loop 2
        (crash test 2).

        This is a legacy shim over the unified scenario driver — use
        ``repro_torch.scenarios.run_scenario(("mm", {...}), "adcc", plan)``.
        """
        warnings.warn(
            "ABFTMatmul.run() is deprecated; use repro_torch.scenarios."
            "run_scenario(('mm', params), 'adcc', CrashPlan.at_phase(...))",
            DeprecationWarning, stacklevel=2)
        from ..scenarios import CrashPlan, run_scenario
        from ..scenarios.workloads import MMWorkload

        plan = CrashPlan.no_crash()
        if crash_after is not None:
            loop, idx = crash_after
            # old semantics: an out-of-range crash point simply never fires
            if (loop == "loop1" and 0 <= idx < self.nchunks) or (
                    loop == "loop2" and 0 <= idx < len(self.row_blocks)):
                plan = CrashPlan.at_phase(loop, idx)
        res = run_scenario(MMWorkload(impl=self), "adcc", plan)
        return MMRunResult(
            C=res.info["C"], crashed_in=res.info.get("crashed_in"),
            chunks_lost=res.info.get("chunks_lost", 0),
            corrected_elements=res.info.get("corrected_elements", 0),
            detect_seconds=res.detect_seconds,
            resume_seconds=res.resume_seconds,
            avg_chunk_seconds=res.avg_step_seconds,
            modeled_overhead_seconds=res.modeled_total_seconds,
            max_error=res.metrics["max_error"],
        )

    # -- recovery ---------------------------------------------------------------
    def _recover_loop1(self) -> Tuple[List[int], int, float]:
        """Verify every C_s_temp in NVM via its checksums; single-element
        damage is corrected in place, torn chunks are reported for
        recomputation. Returns (bad chunk ids, corrected count, seconds)."""
        bad: List[int] = []
        corrected = 0
        nbytes = 0
        upper = self.counter.nvm_value()  # chunks beyond this were never run
        for s in range(min(upper + 1, self.nchunks)):
            view = self.C_s[s].nvm
            nbytes += view.nbytes
            # an all-zero image means *nothing* of a started chunk reached
            # NVM — checksums hold trivially but the chunk is lost
            if np.any(view != 0) and abft.verify(view, rtol=1e-9, atol=1e-6):
                # consistent in NVM: reload it as truth
                self.C_s[s][...] = view
                continue
            fixed, nfix = abft.correct_single_error(view, rtol=1e-9, atol=1e-6)
            if fixed is not None:
                self.C_s[s][...] = fixed
                corrected += nfix
            else:
                bad.append(s)
        return bad, corrected, nbytes / self.emu.cfg.read_bw

    def _recover_loop2(self, blocks_started: int) -> Tuple[List[int], float]:
        """Row checksums of C_temp decide which row blocks are consistent."""
        view = self.C_temp.nvm
        n = self.n
        row_resid = view[:, n] - view[:, :n].sum(axis=1)
        scale = max(float(np.max(np.abs(view))), 1.0)
        tol = 1e-6 + 1e-9 * scale
        bad: List[int] = []
        for bi, (lo, hi) in enumerate(self.row_blocks[:blocks_started]):
            rows = row_resid[lo:hi]
            # all-zero row blocks of a *started* block are fully lost
            # (checksum relations hold trivially on zeros)
            if np.any(np.abs(rows) > tol) or not np.any(view[lo:hi, :] != 0):
                bad.append(bi)
            else:
                self.C_temp[lo:hi, :] = view[lo:hi, :]
        # (C_s chunk integrity is re-established by _recover_loop1 before
        # this runs — see run(); reloading them here would clobber chunks
        # that were just recomputed into truth.)
        return bad, view.nbytes / self.emu.cfg.read_bw

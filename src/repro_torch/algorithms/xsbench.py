"""XSBench-style Monte-Carlo cross-section lookup with ADCC (§III.D).

Reproduces the paper's MC study:

  * two large read-only grids (unionized energy grid + per-nuclide cross
    section grids) dominate the footprint;
  * each lookup binary-searches the energy grid, gathers + interpolates
    per-nuclide cross sections for a random material, accumulates into a
    5-element ``macro_xs_vector``, then (the paper's determinism
    extension) picks an interaction type from the normalized CDF of the
    vector and bumps one of five counters;
  * contrary to intuition, the tiny hot accumulators are *never evicted*
    (each lookup touches only a few grid lines), so naive crash-restart
    loses many iterations of counts (Fig. 10);
  * the fix flushes macro_xs_vector + the five counters + the loop index
    every ``flush_every`` lookups (0.01% of total in the paper, Fig. 11),
    bounding the loss and restoring correctness (Fig. 12) at ~0.05%
    runtime overhead (Fig. 13).

Sampling is *counter-based* (hash of the lookup index) so a restarted run
replays the same per-iteration random inputs — the paper does the same
("these two tests use the same randomly sampled inputs for each lookup").
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.nvm import CrashEmulator, NVMConfig

__all__ = ["XSBenchConfig", "XSBenchResult", "ADCC_XSBench"]

N_TYPES = 5  # interaction types: total, elastic, absorption, fission, nu-fission


@dataclasses.dataclass(frozen=True)
class XSBenchConfig:
    n_nuclides: int = 34           # paper: 34 fuel nuclides (H-M model)
    grid_points: int = 40_000      # unionized energy grid size (scaled down)
    n_materials: int = 12
    max_nuclides_per_material: int = 8
    lookups: int = 200_000
    flush_every_frac: float = 1e-4  # 0.01% of total lookups (paper)
    seed: int = 7


def _hash_u64(x: np.ndarray | int) -> np.ndarray:
    """SplitMix64 — counter-based RNG so restarts replay identical inputs.
    uint64 wraparound is the intended mod-2^64 arithmetic."""
    with np.errstate(over="ignore"):
        z = (np.uint64(x) + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _u01(h: np.ndarray) -> np.ndarray:
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


@dataclasses.dataclass
class XSBenchResult:
    counts: np.ndarray             # (5,) interaction-type counts
    fractions: np.ndarray          # counts / lookups completed
    macro_xs: np.ndarray           # (5,) accumulated macroscopic XS
    lookups_done: int
    crashed_at: Optional[int]
    iterations_lost: int
    modeled_overhead_seconds: float
    wall_seconds: float

    def max_fraction_spread(self) -> float:
        """Max pairwise difference between type fractions — the paper's
        Fig. 10/12 correctness metric (should be ~0 for a fair CDF)."""
        return float(np.max(self.fractions) - np.min(self.fractions))


class ADCC_XSBench:
    """XSBench over the crash emulator with selectable flush policy."""

    def __init__(self, cfg: XSBenchConfig, nvm: Optional[NVMConfig] = None,
                 policy: str = "selective"):
        """policy: 'selective' (Fig. 11), 'basic' (index-only flush,
        Fig. 10's failing scheme), or 'every' (flush accumulators every
        lookup — the 16%-overhead strawman)."""
        assert policy in ("selective", "basic", "every")
        self.cfg = cfg
        self.policy = policy
        self.emu = CrashEmulator(nvm or NVMConfig())
        rng = np.random.default_rng(cfg.seed)

        # --- build grids (read-only, large) --------------------------------
        egrid = np.sort(rng.uniform(1e-11, 20.0, size=cfg.grid_points))
        # per (grid point, nuclide, xs-type) microscopic cross sections
        nuc = rng.uniform(0.1, 10.0,
                          size=(cfg.grid_points, cfg.n_nuclides, N_TYPES))
        self._egrid = self.emu.alloc("egrid", egrid.shape, np.float64,
                                     init=egrid, sector_lines=2)
        self._nuc = self.emu.alloc("nuclide_grid", nuc.shape, np.float64,
                                   init=nuc, sector_lines=2)
        self._egrid.flush(); self._nuc.flush()
        self.egrid_np = egrid
        self.nuc_np = nuc

        # materials -> nuclide lists (host-side metadata, tiny)
        self.materials = [
            rng.choice(cfg.n_nuclides,
                       size=rng.integers(2, cfg.max_nuclides_per_material + 1),
                       replace=False)
            for _ in range(cfg.n_materials)
        ]

        # --- critical small state (each on its own cache line) --------------
        self._macro = self.emu.alloc("macro_xs_vector", (N_TYPES,), np.float64)
        self._counters = [
            self.emu.alloc(f"type_counter_{t}", (1,), np.int64)
            for t in range(N_TYPES)
        ]
        self._index = self.emu.alloc("lookup_index", (1,), np.int64)
        self.flush_every = max(1, int(cfg.lookups * cfg.flush_every_frac))

    # -- one lookup ----------------------------------------------------------
    def _lookup(self, i: int) -> None:
        cfg = self.cfg
        h = _hash_u64(np.uint64((i * 2654435761) & 0xFFFFFFFFFFFFFFFF))
        e = _u01(h) * 19.9 + 1e-11
        mat = int(_hash_u64(h) % np.uint64(cfg.n_materials))

        # binary search on the energy grid: touches log2(G) cache lines
        idx = int(np.searchsorted(self.egrid_np, e)) - 1
        idx = min(max(idx, 0), cfg.grid_points - 2)
        for probe in self._bsearch_probes(cfg.grid_points, idx):
            self.emu.read("egrid", probe, probe + 1)

        t = (e - self.egrid_np[idx]) / max(
            self.egrid_np[idx + 1] - self.egrid_np[idx], 1e-300)
        macro = np.zeros(N_TYPES)
        row = cfg.n_nuclides * N_TYPES
        for nuclide in self.materials[mat]:
            lo = idx * row + int(nuclide) * N_TYPES
            self.emu.read("nuclide_grid", lo, lo + N_TYPES)
            self.emu.read("nuclide_grid", lo + row, lo + row + N_TYPES)
            xs0 = self.nuc_np[idx, nuclide]
            xs1 = self.nuc_np[idx + 1, nuclide]
            macro += xs0 * (1.0 - t) + xs1 * t

        # accumulate into the persistent macro_xs_vector (hot line!)
        self._macro[...] = self._macro.view + macro

        # paper's determinism extension: CDF -> pick interaction type
        cdf = np.cumsum(macro)
        cdf /= cdf[-1]
        x = _u01(_hash_u64(h ^ np.uint64(0xD6E8FEB86659FD93)))
        chosen = int(np.searchsorted(cdf, x))
        chosen = min(chosen, N_TYPES - 1)
        c = self._counters[chosen]
        c[0] = int(c.view[0]) + 1

    @staticmethod
    def _bsearch_probes(n: int, target: int):
        """Indices a binary search for `target` actually touches."""
        lo, hi = 0, n - 1
        probes = []
        while lo < hi:
            mid = (lo + hi) // 2
            probes.append(mid)
            if mid < target:
                lo = mid + 1
            elif mid > target:
                hi = mid - 1
            else:
                break
            if len(probes) > 64:
                break
        return probes

    def _flush_critical(self, i: int) -> None:
        self._macro.flush()
        for c in self._counters:
            c.flush()
        self._index[0] = i
        self._index.flush()

    # -- driver ------------------------------------------------------------------
    def run(self, crash_at: Optional[int] = None,
            restart: bool = True) -> XSBenchResult:
        """Deprecated: run the lookup loop, optionally crashing after
        ``crash_at`` lookups completed; with ``restart`` recover from
        the persisted index/counters and resume.

        This is a legacy shim over the unified scenario driver — use
        ``repro_torch.scenarios.run_scenario(("xsbench", {...}), "adcc", plan)``.
        """
        warnings.warn(
            "ADCC_XSBench.run() is deprecated; use repro_torch.scenarios."
            "run_scenario(('xsbench', params), 'adcc', CrashPlan.at_step(k))",
            DeprecationWarning, stacklevel=2)
        from ..scenarios import CrashPlan, run_scenario
        from ..scenarios.workloads import XSBenchWorkload

        # old semantics: the crash check ran after the loop counter was
        # incremented, so crash_at=0 (or None, or > lookups) never fires
        plan = (CrashPlan.at_step(crash_at - 1)
                if crash_at and 0 < crash_at <= self.cfg.lookups
                else CrashPlan.no_crash())
        res = run_scenario(XSBenchWorkload(impl=self), "adcc", plan,
                           recover=restart)
        return XSBenchResult(
            counts=res.info["counts"], fractions=res.info["fractions"],
            macro_xs=res.info["macro_xs"],
            lookups_done=res.steps_done,
            crashed_at=(res.crash_step + 1
                        if res.crash_step is not None else None),
            iterations_lost=res.info.get("iterations_lost", 0),
            modeled_overhead_seconds=res.modeled_total_seconds,
            wall_seconds=res.wall_seconds,
        )

"""Modeled per-step mechanism costs — the single source for the paper's
seven-mechanism runtime comparisons (Figs. 4/8/13).

Each workload reduces its persistence behaviour to a
:class:`StepCostProfile` (bytes checkpointed / logged / ADCC-flushed per
persist event); :func:`mechanism_step_seconds` turns (strategy, profile,
config) into modeled seconds per persist event using the paper's §III.A
bandwidth model. The runtime figures are then pure matrices:
``for case in mechanism_cases(): (native + case.step_seconds(p)) / native``.

Cost formulas (per persist event; ``line`` = ``cfg.line_bytes``):

  none                0
  checkpoint_hdd      hdd_latency + ckpt_bytes / hdd_bw
  checkpoint_nvm      ckpt_bytes / write_bw + ckpt_lines * flush_latency
  checkpoint_nvm_dram ... + dram_cache / dram_bw + dram_cache / write_bw
  undo_log            2 * (log_bytes / write_bw + log_lines * flush_latency)
                      (old-value copy + fence, then commit writeback + fence)
  adcc                adcc_bytes / write_bw + adcc_lines * flush_latency
  shadow_snapshot     shadow_bytes / write_bw + shadow_lines * flush_latency
                      + 8 / write_bw + flush_latency
                      (copy-on-write copies only regions dirtied since the
                      previous snapshot, then one persisted 8-byte
                      root-pointer flip; shadow_bytes defaults to
                      ckpt_bytes when a workload provides no COW estimate)
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from ..core.nvm import NVMConfig

__all__ = [
    "StepCostProfile",
    "MechanismCase",
    "MECHANISM_CASES",
    "mechanism_cases",
    "mechanism_step_seconds",
    "persist_events",
    "survivor_writeback_seconds",
    "cg_step_profile",
    "mm_step_profile",
    "xsbench_step_profile",
    "kv_step_profile",
]


def survivor_writeback_seconds(nbytes: int, cfg: NVMConfig) -> float:
    """Modeled NVM-write time of the dirty-line writebacks a torn crash
    completed before power loss (``traffic.torn_bytes_persisted``).

    Never charged to a run's ``modeled_seconds`` — the program did not
    wait for in-flight evictions — but it bounds the plausibility of a
    survival fraction: persisting those bytes must fit the power-fail
    hold-up window, and fig_torn reports this as per-cell context.
    """
    return nbytes / cfg.write_bw


@dataclasses.dataclass(frozen=True)
class StepCostProfile:
    """Per-persist-event byte/line counts of one workload."""

    ckpt_bytes: int                  # bytes a checkpoint copies
    log_bytes: int                   # bytes an undo-log tx copies (dirtied)
    adcc_bytes: int                  # bytes ADCC flushes
    adcc_lines: Optional[int] = None   # CLFLUSH issues (default bytes/line)
    ckpt_lines: Optional[int] = None
    log_lines: Optional[int] = None
    interval_steps: int = 1          # steps between persist events
    hdd_latency_s: float = 0.0       # per-checkpoint seek cost (tiny payloads)
    # bytes a shadow snapshot copies per persist event (regions dirtied
    # since the previous snapshot — the copy-on-write saving over
    # ckpt_bytes). None => no estimate, fall back to ckpt_bytes.
    shadow_bytes: Optional[int] = None
    shadow_lines: Optional[int] = None


def _lines(bytes_: int, explicit: Optional[int], line: int) -> int:
    return explicit if explicit is not None else max(1, math.ceil(bytes_ / line))


def mechanism_step_seconds(strategy: str, profile: StepCostProfile,
                           cfg: NVMConfig) -> float:
    """Modeled mechanism seconds per persist event."""
    line = cfg.line_bytes
    if strategy in ("none", "native"):
        return 0.0
    if strategy == "checkpoint_hdd":
        return profile.hdd_latency_s + profile.ckpt_bytes / cfg.hdd_bw
    if strategy in ("checkpoint_nvm", "checkpoint_nvm_dram"):
        t = (profile.ckpt_bytes / cfg.write_bw
             + _lines(profile.ckpt_bytes, profile.ckpt_lines, line)
             * cfg.flush_latency)
        if strategy == "checkpoint_nvm_dram":
            t += cfg.dram_cache_bytes / cfg.dram_bw
            t += cfg.dram_cache_bytes / cfg.write_bw
        return t
    if strategy == "undo_log":
        nlines = _lines(profile.log_bytes, profile.log_lines, line)
        return 2 * (profile.log_bytes / cfg.write_bw
                    + nlines * cfg.flush_latency)
    if strategy == "adcc":
        nlines = _lines(profile.adcc_bytes, profile.adcc_lines, line)
        return profile.adcc_bytes / cfg.write_bw + nlines * cfg.flush_latency
    if strategy == "shadow_snapshot":
        nb = (profile.shadow_bytes if profile.shadow_bytes is not None
              else profile.ckpt_bytes)
        nl = _lines(nb, profile.shadow_lines, line)
        # COW copy of the dirtied regions + one persisted root-pointer flip
        return (nb / cfg.write_bw + nl * cfg.flush_latency
                + 8 / cfg.write_bw + cfg.flush_latency)
    raise ValueError(f"unknown strategy {strategy!r}")


def persist_events(steps_run: int, strategy_interval: int,
                   profile: StepCostProfile, wants_adcc: bool) -> int:
    """How many persist events ``steps_run`` executed steps triggered.

    Traditional mechanisms persist every ``strategy_interval`` steps;
    ADCC's cadence is algorithm-directed, carried by the profile's
    ``interval_steps`` (e.g. XSBench's selective flush interval). The
    single source for a cell's modeled mechanism overhead — both the
    full-execution path and mode="measure" (which never runs the tail,
    so its overhead must come from this model, not from execution)
    charge ``events * mechanism_step_seconds(...)``.
    """
    interval = strategy_interval * (profile.interval_steps
                                    if wants_adcc else 1)
    return steps_run // max(1, interval)


@dataclasses.dataclass(frozen=True)
class MechanismCase:
    """One column of the paper's 7-mechanism comparison."""

    name: str          # figure row label, e.g. "adcc_nvm_dram"
    strategy: str      # registry key, e.g. "adcc"
    nvm_dram: bool     # heterogeneous NVM/DRAM system vs NVM-only

    def config(self, **overrides) -> NVMConfig:
        return NVMConfig(nvm_same_as_dram=not self.nvm_dram, **overrides)

    def step_seconds(self, profile: StepCostProfile,
                     cfg: Optional[NVMConfig] = None) -> float:
        return mechanism_step_seconds(self.strategy, profile,
                                      cfg or self.config())


MECHANISM_CASES: List[MechanismCase] = [
    MechanismCase("native", "none", nvm_dram=False),
    MechanismCase("ckpt_hdd", "checkpoint_hdd", nvm_dram=False),
    MechanismCase("ckpt_nvm_only", "checkpoint_nvm", nvm_dram=False),
    MechanismCase("ckpt_nvm_dram", "checkpoint_nvm_dram", nvm_dram=True),
    MechanismCase("pmem_undo", "undo_log", nvm_dram=False),
    MechanismCase("adcc_nvm_only", "adcc", nvm_dram=False),
    MechanismCase("adcc_nvm_dram", "adcc", nvm_dram=True),
]


def mechanism_cases() -> List[MechanismCase]:
    """The paper's seven crash-consistence mechanisms (§III.A cases 1-7)."""
    return list(MECHANISM_CASES)


# -- per-workload profiles -----------------------------------------------------

def cg_step_profile(n: int, line_bytes: int = 64) -> StepCostProfile:
    """Per CG iteration: checkpoint copies p/q/r/z, undo-log dirties
    p/r/z, ADCC flushes the one cache line holding the counter."""
    vec = n * 8
    return StepCostProfile(ckpt_bytes=4 * vec, log_bytes=3 * vec,
                           adcc_bytes=line_bytes, adcc_lines=1)


def mm_step_profile(n: int, line_bytes: int = 64) -> StepCostProfile:
    """Per submatrix multiplication: checkpoint/undo-log move the whole
    (n+1)^2 C_f; ADCC flushes one checksum row + one checksum column."""
    cf = (n + 1) * (n + 1) * 8
    cs = 2 * (n + 1) * 8
    return StepCostProfile(ckpt_bytes=cf, log_bytes=cf, adcc_bytes=cs,
                           adcc_lines=max(1, cs // line_bytes))


def kv_step_profile(index_bytes: int, meta_bytes: int, extent_bytes: int,
                    n_extents: int, avg_value_bytes: int,
                    line_bytes: int = 64) -> StepCostProfile:
    """Per KV request: a checkpoint copies the whole store (index + meta
    + every value extent); the undo log dirties the touched slot pair,
    the appended value span, and the meta pair; ADCC-style selective
    persistence flushes exactly the request's value span + slot line +
    meta line; a shadow snapshot copies only the regions dirtied since
    the previous snapshot — in steady state the index, the meta pair,
    and the one extent the append head sits in (COW shares the rest)."""
    footprint = index_bytes + meta_bytes + n_extents * extent_bytes
    touched = 2 * line_bytes + avg_value_bytes + meta_bytes
    adcc = avg_value_bytes + 2 * line_bytes
    shadow = index_bytes + meta_bytes + extent_bytes
    return StepCostProfile(
        ckpt_bytes=footprint, log_bytes=touched, adcc_bytes=adcc,
        adcc_lines=max(1, math.ceil(avg_value_bytes / line_bytes)) + 2,
        shadow_bytes=shadow,
        hdd_latency_s=5e-3)


def xsbench_step_profile(line_bytes: int = 64, interval_steps: int = 1,
                         hdd_latency_s: float = 5e-3) -> StepCostProfile:
    """Per flush interval: the persisted state is macro_xs_vector + five
    counters + the loop index (~13 distinct cache lines; paper Fig. 13)."""
    state_bytes = (5 + 5 + 1) * 8
    nlines = max(1, state_bytes // line_bytes) + 10   # distinct lines
    return StepCostProfile(
        ckpt_bytes=state_bytes, ckpt_lines=nlines,
        log_bytes=nlines * line_bytes, log_lines=nlines,
        adcc_bytes=nlines * line_bytes, adcc_lines=nlines,
        interval_steps=interval_steps, hdd_latency_s=hdd_latency_s)

"""repro_torch.scenarios — the unified scenario layer: every crash-consistence
experiment is one point in Workload × ConsistencyStrategy × CrashPlan.

The paper's comparison matrix (3 algorithms × 7 mechanisms × many crash
points) used to be hand-wired into each algorithm driver and each
benchmark figure; this package factors the three axes apart so a new
mechanism, workload, or crash scenario is one registry entry, not six
file edits.

Module map:

  workloads   Workload protocol + adapters for the paper's algorithms
              (CGWorkload, MMWorkload, XSBenchWorkload) and the
              WORKLOADS registry. Workloads run in "adcc" mode (the
              paper's extended algorithm) or "plain" mode (the
              unmodified baseline the traditional mechanisms protect).
  strategies  ConsistencyStrategy protocol + STRATEGIES registry:
              none / adcc / undo_log / checkpoint_{hdd,nvm,nvm_dram},
              with "@interval" variants; wraps the core TxManager and
              CheckpointBaseline machinery.
  crashplan   Declarative CrashPlan: no_crash / at_step / at_phase /
              at_fraction / seeded random batches; ``torn=True`` crashes
              inside the step boundary (exercises rollback paths), and
              ``torn=TornSpec(fraction, seed, mode, samples)`` makes the
              torn crash a parameterized *line-survival* image: a seeded
              subset of the dirty cache lines persisted before power
              loss (the WITCHER/EasyCrash crash-state space), one cell
              per sample. ``fault=FaultSpec(...)`` arms a fault
              campaign on every crash point: nested crashes that
              re-crash *during recovery* (re-entrancy certification
              against the single-crash golden cell) and/or seeded
              media faults that silently poison the post-crash image
              (detection-coverage certification).
  kv          KVWorkload — the beyond-paper persistent KV-serving
              family: an NVM-backed store (A/B-versioned hash index +
              append-only value-log extents) driven by seeded zipfian
              get/put/delete streams (ETC/UDB profiles), with
              algorithm-directed per-request persistence, durability /
              atomicity auditing against the acknowledged prefix, and
              the shadow_snapshot strategy as its natural baseline.
  costmodel   StepCostProfile + mechanism_step_seconds(): the single
              source for the paper's Figs. 4/8/13 modeled mechanism
              costs, and mechanism_cases() — the canonical 7-mechanism
              comparison axis.
  driver      run_scenario() -> ScenarioResult (uniform overhead /
              recompute / correctness / traffic fields) and sweep(),
              the batched matrix runner that emits BENCH_scenarios.json.
              sweep(engine="fork"|"rerun") selects execution: "fork"
              (default) shares one prefix run per (workload, strategy)
              pair via snapshots, "rerun" re-executes every cell from
              step 0 (the oracle both must match cell-for-cell).
              sweep(mode="measure") computes each crashed cell's
              recompute/restart fields from the recovered state instead
              of executing the tail (O(restore + recover) per cell);
              sweep(workers=N) shards the independent (workload,
              strategy) pairs across N processes with a deterministic
              pair-major merge.
  sweep_engine the prefix-sharing fork engine: snapshot/restore on
              MemoryBackend + Workload + ConsistencyStrategy makes a
              crash-point batch O(tail) instead of O(full re-run),
              so dense plans (CrashPlan.at_every_step()) are tractable.

Ten-line tour::

    from repro_torch.scenarios import CrashPlan, run_scenario, sweep

    res = run_scenario(("cg", {"n": 8192, "iters": 16}), "adcc",
                       CrashPlan.at_step(14))
    print(res.restart_point, res.steps_lost, res.correct)

    cells = sweep(workloads=("cg", "mm", "xsbench"),
                  strategies=("none", "adcc", "undo_log",
                              "checkpoint_nvm"),
                  plans=(CrashPlan.no_crash(), CrashPlan.at_fraction(0.5)),
                  out_json="BENCH_scenarios.json")
"""

from ..core.backends import LineSurvival, MediaFault
from .crashplan import CrashPlan, CrashPoint, FaultSpec, TornSpec
from .costmodel import (
    MECHANISM_CASES,
    MechanismCase,
    StepCostProfile,
    cg_step_profile,
    mechanism_cases,
    mechanism_step_seconds,
    mm_step_profile,
    kv_step_profile,
    xsbench_step_profile,
)
from .workloads import (
    WORKLOADS,
    CGWorkload,
    FinalReport,
    MMWorkload,
    RecoveryResult,
    Workload,
    XSBenchWorkload,
    make_workload,
    register_workload,
)
from .strategies import (
    STRATEGIES,
    AdccStrategy,
    CheckpointStrategy,
    ConsistencyStrategy,
    NativeStrategy,
    ShadowSnapshotStrategy,
    UndoLogStrategy,
    make_strategy,
    register_strategy,
    strategy_names,
)
from .kv import KV_PROFILES, KVProfile, KVWorkload  # registers "kv"
from .driver import (
    AVG_STEP_JITTER_FLOOR,
    DEFAULT_SWEEP_PLANS,
    FORK_ONLY_FIELDS,
    FULL_RUN_FIELDS,
    SWEEP_ENGINES,
    SWEEP_MODES,
    WALL_CLOCK_FIELDS,
    ScenarioResult,
    classify_recovery,
    deterministic_cell_dict,
    measure_divergence_fields,
    run_scenario,
    sweep,
    write_scenarios_json,
)

__all__ = [
    "CrashPlan", "CrashPoint", "TornSpec", "LineSurvival",
    "FaultSpec", "MediaFault",
    "MECHANISM_CASES", "MechanismCase", "StepCostProfile",
    "mechanism_cases", "mechanism_step_seconds",
    "cg_step_profile", "mm_step_profile", "kv_step_profile",
    "xsbench_step_profile",
    "WORKLOADS", "Workload", "CGWorkload", "MMWorkload", "XSBenchWorkload",
    "KVWorkload", "KVProfile", "KV_PROFILES",
    "RecoveryResult", "FinalReport", "make_workload", "register_workload",
    "STRATEGIES", "ConsistencyStrategy", "NativeStrategy", "AdccStrategy",
    "UndoLogStrategy", "CheckpointStrategy", "ShadowSnapshotStrategy",
    "make_strategy", "register_strategy", "strategy_names",
    "AVG_STEP_JITTER_FLOOR", "DEFAULT_SWEEP_PLANS", "SWEEP_ENGINES",
    "SWEEP_MODES", "WALL_CLOCK_FIELDS", "FULL_RUN_FIELDS",
    "FORK_ONLY_FIELDS",
    "ScenarioResult", "classify_recovery", "deterministic_cell_dict",
    "measure_divergence_fields", "run_scenario", "sweep",
    "write_scenarios_json",
]

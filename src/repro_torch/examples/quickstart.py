"""Quickstart: the scenario API on the paper's workloads, then a small
LM trained with algorithm-directed crash consistence (the JAX package's
``examples/quickstart.py``).

Part 1 sweeps a workload × strategy × crash-plan matrix through
``repro_torch.scenarios`` (the paper's comparison, in ten lines). Part 2
runs a reduced llama3 config with the ADCC trainer, simulates a mid-run
crash, resumes, and compares every parameter with an uninterrupted run.

    python -m repro_torch.examples.quickstart [--device cpu] [--small]

``--small`` shrinks both parts (a CPU minute becomes seconds).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from ..configs.base import TrainConfig
from ..device import use_device
from ..launch.train import ADCCTrainer
from ..models.registry import get_config
from ..scenarios import CrashPlan, sweep

SWEEP = (("cg", {"n": 2048, "iters": 10}),
         ("mm", {"n": 96, "k": 24}),
         ("xsbench", {"lookups": 600, "grid_points": 800}))
SWEEP_SMALL = (("cg", {"n": 256, "iters": 10}),
               ("mm", {"n": 32, "k": 8}),
               ("xsbench", {"lookups": 120, "grid_points": 200}))


def scenario_demo(workloads=SWEEP) -> bool:
    print("== scenario sweep: workload x strategy x crash plan")
    cells = sweep(workloads=workloads,
                  strategies=("none", "adcc", "checkpoint_nvm"),
                  plans=(CrashPlan.no_crash(), CrashPlan.at_fraction(0.6)))
    print(f"   {'workload':<9s} {'strategy':<16s} {'crash':<10s} "
          f"{'lost':>4s} {'overhead':>10s}  ok")
    for c in cells:
        print(f"   {c.workload:<9s} {c.strategy:<16s} {c.plan:<10s} "
              f"{c.steps_lost:>4d} {c.overhead_seconds:>9.2e}s  "
              f"{'yes' if c.correct else 'NO'}")
    return all(c.correct for c in cells if c.strategy != "none")


def max_param_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """The largest |difference| over every parameter of two models."""
    return max(float((x.to(torch.float32) - y.to(torch.float32))
                     .abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    steps, crash, batch, seq, every = ((12, 7, 2, 16, 4) if args.small
                                       else (40, 25, 8, 64, 8))
    with use_device(args.device):
        sweep_ok = scenario_demo(SWEEP_SMALL if args.small else SWEEP)
        print()
        cfg = get_config("llama3-8b").reduced()
        tcfg = TrainConfig(remat="none", total_steps=steps, warmup_steps=4)
        workdir = tempfile.mkdtemp(prefix="quickstart_")
        print(f"== training {cfg.name} (reduced: "
              f"{cfg.param_count()/1e6:.1f}M params) with ADCC, "
              f"workdir={workdir}")
        kw = dict(batch=batch, seq=seq, slot_every=every)
        trainer = ADCCTrainer(cfg, tcfg, workdir, **kw)
        res = trainer.run(steps=steps, crash_at_step=crash)
        print(f"\n!! simulated crash at step {res.final_step} "
              f"(async slot writes torn, process state lost)\n")

        resumed = ADCCTrainer(cfg, tcfg, workdir, **kw)
        res2 = resumed.run(steps=steps)
        print(f"\n== recovery: {res2.recovery_report}")
        print(f"== resumed from step {res2.resumed_from}, "
              f"final loss {res2.losses[-1]:.4f}")

        # bitwise equivalence against an uninterrupted run
        ref_dir = tempfile.mkdtemp(prefix="quickstart_ref_")
        ref = ADCCTrainer(cfg, tcfg, ref_dir, **kw)
        ref.run(steps=steps, log_every=0)
        diff = max_param_diff(ref._final_params, resumed._final_params)
    print(f"== max |param diff| vs uninterrupted run: {diff} "
          f"({'BITWISE IDENTICAL' if diff == 0 else 'MISMATCH'})")
    shutil.rmtree(workdir, ignore_errors=True)
    shutil.rmtree(ref_dir, ignore_errors=True)
    return {"sweep_ok": sweep_ok, "bitwise": diff == 0.0,
            "resumed_from": res2.resumed_from,
            "losses": res.losses + res2.losses}


if __name__ == "__main__":
    main()

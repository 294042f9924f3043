"""End-to-end driver: train mamba2-130m for a few hundred steps with the
port's training stack — the train step, the ADCC ledger and async slots,
the straggler monitor, the synthetic pipeline — and report the loss
curve and the step time (the JAX package's ``examples/train_e2e.py``).

The default is mamba2-130m at full width with 6 of its 24 layers
(~90M parameters); ``--full`` takes all 24.

    python -m repro_torch.examples.train_e2e [--device cpu] [--steps 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile

import numpy as np

from ..configs.base import TrainConfig
from ..device import use_device
from ..launch.train import ADCCTrainer
from ..models.registry import get_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=6,
                    help="depth without --full")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir", default=None,
                    help="ledger and slots (default: a new temporary dir)")
    args = ap.parse_args(argv)

    cfg = get_config("mamba2-130m")
    if not args.full:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"== {cfg.name}: {cfg.param_count()/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    # the trainer's deterministic step needs a fixed cuBLAS workspace
    # before the process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    tcfg = TrainConfig(remat="none", total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20),
                       learning_rate=1e-3)
    wd = args.workdir or tempfile.mkdtemp(prefix="train_e2e_")
    with use_device(args.device):
        tr = ADCCTrainer(cfg, tcfg, wd, batch=args.batch, seq=args.seq,
                         slot_every=25)
        res = tr.run(args.steps, log_every=20)

    n = min(10, len(res.losses))
    first = float(np.mean(res.losses[:n]))
    last = float(np.mean(res.losses[-n:]))
    med = float(np.median(res.step_seconds[2:] or res.step_seconds))
    print(f"\n== loss {first:.4f} -> {last:.4f} "
          f"({'LEARNING' if last < first - 0.05 else 'check config'})")
    print(f"== median step {med*1e3:.0f} ms; straggler flags: "
          f"{tr.monitor.flagged_steps}")
    print(f"== ledger + slots in {wd} (delete when done)")
    return {"losses": list(res.losses), "finite": all(
        math.isfinite(x) for x in res.losses), "median_step_s": med}


if __name__ == "__main__":
    main()

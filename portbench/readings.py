#!/usr/bin/env python3
"""The readings that each correctness limit is set from, on the card, at
the cell's own size (not part of a benchmark run):

    python3 portbench/readings.py <cell> --seeds 11 12 ... [--fault-seeds 3]
        [--seconds 2]

For every seed: the program's compared numbers from a whole run of the
cell's driver with a short window (the lower reading is their largest);
and the control, the reference computed with float8 e4m3 products put in
the program's place, compared the same way with the float32 reference
(the upper reading is its smallest). Also the planted faults, each on
the first ``--fault-seeds`` seeds: half of each batch left out
(``half_batch``); a step that returns its state unchanged reads
1 on the change and needs no run. One JSON line a reading, on standard
output and appended to ``--out`` (default
``build/portbench/readings_<cell>.jsonl``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run as RUN  # noqa: E402


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_control(r) -> dict:
    """The training numbers of the float8 reference against the float32
    one, from the seed's weights and batches."""
    import torch
    from portbench import bench, weights
    from portbench.drivers.train import _norms
    from portbench.reference import lm as R
    from portbench.reference import train as RT
    from portbench.traffic import TrainFeed
    m, t, dev = r.model, r.traffic, r.device
    feed = TrainFeed(t, m["vocab_size"], r.seed)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in feed.batch_at(s).items()}
               for s in range(t["check_steps"])]
    p0 = weights.make(m, r.seed, dev)
    out = {}
    for kind in ("f32", "fp8"):
        res = RT.steps(m, p0, batches, t["optimizer"],
                       rows=t["reference_rows"], prec=R.Precision(kind))
        out[kind] = {"losses": res["losses"], "grad1": _norms(res["grad1"]),
                     "change": _norms(res["change"])}
        del res
        _free()
    f, q = out["f32"], out["fp8"]
    return {"grad_gap_median": bench.median_leaf_gap(q["grad1"], f["grad1"]),
            "change_gap_median": bench.median_leaf_gap(q["change"],
                                                       f["change"]),
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(q["losses"], f["losses"])),
            "grad_gap_worst": bench.worst_leaf_gap(q["grad1"], f["grad1"]),
            "change_gap_worst": bench.worst_leaf_gap(q["change"],
                                                     f["change"]),
            "_runs": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    RUN.setup_env()
    import torch
    from portbench import bench
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)          # the allocator, before its stats
    path = a.out or os.path.join(bench.ROOT, "build", "portbench",
                                 f"readings_{a.cell}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")

    for k, seed in enumerate(a.seeds):
        faults = [None] + (["half_batch"] if k < a.fault_seeds else [])
        for fault in faults:
            r = bench.load_run(a.cell, seed, a.seconds, False,
                               time.perf_counter())
            r.device, r.fault = dev, fault
            r.port_cfg = bench.port_config(r)
            torch.cuda.reset_peak_memory_stats(dev)
            res = importlib.import_module(
                f"portbench.drivers.{r.traffic['driver']}").run(r)
            emit({"cell": a.cell, "seed": seed, "reading": fault or "program",
                  "values": {n: c["value"] for n, c in res["checks"].items()},
                  "e2e": res["e2e"], "peak": res["peak"],
                  **{k2: res[k2] for k2 in ("losses", "ref_losses",
                                            "slot_every", "step_s",
                                            "slot_gap_stale", "loss_gap", "grad_gap_worst",
                                            "change_gap_worst", "leaf_norms")
                     if k2 in res}})
            _free()
            if fault is None:
                t0 = time.perf_counter()
                ctl = train_control(r)
                runs = ctl.pop("_runs", None)
                emit({"cell": a.cell, "seed": seed, "reading": "control_fp8",
                      "values": ctl, "seconds": time.perf_counter() - t0,
                      **({"runs": runs} if runs else {})})
                _free()
            del res
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A cell's run on the CPU at a tiny size, for the tests: the program's
configuration cut by its own ``reduced()`` and computed in float32, the
traffic cut to a few short rows, and every driver, reference and reader
as on the card (the harness's look for a card is skipped).

    python3 portbench/rehearse.py <cell> [<cell> ...] [--trace] [--fault NAME]

prints each cell's result line and then the sorted top-level names of
every loaded module.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

# the traffic of a rehearsal: few short rows, a short window
SMALL = {"train": {"batch": 2, "seq": 32, "reference_rows": 1}}


def reduced_run(cell: str, seed: int = 7, seconds: float = 0.3,
                trace: bool = False, fault=None):
    """The rehearsal's ``bench.Run`` of ``cell`` (device and program
    configuration set)."""
    from portbench import bench, run as R
    R.setup_path()
    import torch
    from repro_torch.models.registry import get_config
    r = bench.load_run(cell, seed, seconds, trace, time.perf_counter())
    cfg = dataclasses.replace(get_config(r.config["arch"]).reduced(),
                              compute_dtype="float32")
    got = {"padded_vocab": cfg.padded_vocab}
    r.config = copy.deepcopy(r.config)
    r.config["model"] = {k: got.get(k, getattr(cfg, k, None))
                         for k in r.config["model"]}
    r.traffic = {**r.traffic, **SMALL[r.traffic["driver"]]}
    r.port_cfg = cfg
    r.device = torch.device("cpu")
    r.fault = fault
    return r


def rehearse(cell: str, **kw):
    """(result line, lines for standard error) of the cell's rehearsal on
    the CPU."""
    from portbench import run as R
    r = reduced_run(cell, **kw)
    import torch
    from repro_torch import use_device
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with use_device("cpu"):
            return R.execute(r, "cpu")
    finally:
        torch.set_num_threads(threads)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fault", default=None)
    a = ap.parse_args()
    for cell in a.cells:
        line, err = rehearse(cell, trace=a.trace, fault=a.fault)
        print("\n".join(err), file=sys.stderr)
        print(line, flush=True)
    print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))

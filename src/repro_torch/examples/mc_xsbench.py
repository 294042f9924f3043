"""Paper §III.D end to end: Monte-Carlo XSBench with selective flushing,
as three scenario cells on identical counter-based random streams (the
JAX package's ``examples/mc_xsbench.py``).

The flush policy is the algorithm-directed design choice, so it is a
*workload parameter*: "basic" (index-only flush) loses counts after a
crash+restart — the paper's Fig. 10 surprise — while "selective"
(Fig. 11) restarts bitwise-correct (Fig. 12).

    python -m repro_torch.examples.mc_xsbench [--device cpu] [--lookups N]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.nvm import NVMConfig
from ..device import use_device
from ..scenarios import CrashPlan, run_scenario

PARAMS = dict(lookups=60_000, grid_points=20_000, n_nuclides=34,
              n_materials=12, max_nuclides_per_material=8,
              flush_every_frac=1e-4, seed=7)


def report(params: dict, ok, basic, sel) -> bool:
    """Print the three cells' interaction-type fractions and the restart
    verdicts; returns whether the selective restart's counts are the
    no-crash run's, bit for bit."""
    print("interaction-type fractions (%):")
    print(f"  {'type':>6s} {'no crash':>9s} {'basic':>9s} {'selective':>10s}")
    for t in range(5):
        print(f"  {t+1:>6d} {100*ok.info['fractions'][t]:>9.3f} "
              f"{100*basic.info['fractions'][t]:>9.3f} "
              f"{100*sel.info['fractions'][t]:>10.3f}")
    lookups = params["lookups"]
    same = bool(np.array_equal(sel.info["counts"], ok.info["counts"]))
    print(f"\nbasic restart: lost "
          f"{lookups - int(basic.info['counts'].sum())} counts "
          f"({basic.steps_lost} iterations of stale counters)")
    print(f"selective flush: counts bitwise-identical to no-crash run: "
          f"{same} (loss bound = "
          f"{int(lookups * params['flush_every_frac'])} lookups)")
    return same


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lookups", type=int, default=PARAMS["lookups"])
    ap.add_argument("--grid-points", type=int, default=PARAMS["grid_points"])
    args = ap.parse_args(argv)
    params = dict(PARAMS, lookups=args.lookups, grid_points=args.grid_points)
    nvm = NVMConfig(cache_bytes=2 * 1024 * 1024, replacement="fifo")
    crash = CrashPlan.at_step(params["lookups"] // 10 - 1)  # 10% in
    with use_device(args.device):
        ok = run_scenario(("xsbench", {**params, "policy": "selective"}),
                          "adcc", CrashPlan.no_crash(), cfg=nvm)
        basic = run_scenario(("xsbench", {**params, "policy": "basic"}),
                             "adcc", crash, cfg=nvm)
        sel = run_scenario(("xsbench", {**params, "policy": "selective"}),
                           "adcc", crash, cfg=nvm)
    return {"selective_bitwise": report(params, ok, basic, sel)}


if __name__ == "__main__":
    main()

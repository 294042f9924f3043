"""Paper §III.B end to end: CG with algorithm-directed crash consistence,
driven through the unified scenario API (the JAX package's
``examples/cg_crash_recovery.py``).

Each run is one scenario cell — CG workload × ADCC strategy × a crash at
iteration 14. The driver kills the run, backward-scans the NVM image
with the two algorithm invariants (orthogonality p·q=0 and residual
r=b-Az), resumes, and reports the uniform ScenarioResult — comparing the
large-problem case (loses ~1 iteration) against the small-problem case
(cache holds everything: restart from scratch).

    python -m repro_torch.examples.cg_crash_recovery [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..algorithms.cg import make_spd_system, plain_cg
from ..core.nvm import NVMConfig
from ..device import use_device
from ..scenarios import CrashPlan, run_scenario

SIZES = ((65536, "large problem (paper: lose <= 1 iteration)"),
         (1024, "small problem (paper: everything was cached -> restart)"))


def demo(n: int, label: str) -> float:
    """One cell, printed; returns max |z - z_ref|."""
    print(f"\n== {label}: n={n} "
          f"(working set ≈ {(4 * n * 8 * 16) / 1e6:.1f} MB vs 2 MB cache)")
    res = run_scenario(("cg", {"n": n, "iters": 16, "seed": n}), "adcc",
                       CrashPlan.at_step(14),
                       cfg=NVMConfig(cache_bytes=2 * 1024 * 1024))
    print(f"   crash @ iter {res.crash_step}; invariant scan accepted "
          f"iteration {res.restart_point} "
          f"({res.steps_lost} iteration(s) lost)")
    recovery = res.info.get("recovery")
    if recovery is not None:
        for j, reports in zip(range(res.crash_step, -2, -1),
                              recovery.reports[:3]):
            line = ", ".join(f"{r.name}: {'OK' if r.ok else 'BAD'} "
                             f"({r.detail})" for r in reports)
            print(f"   iter {j}: {line}")
    A, b = make_spd_system(n, nnz_per_row=8, seed=n)
    err = float(np.max(np.abs(res.info["z"] - plain_cg(A, b, 16))))
    print(f"   resumed to completion; |z - z_ref|_max = {err:.2e} "
          f"({'CORRECT' if err < 1e-8 else 'WRONG'})")
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(str(n) for n, _ in SIZES),
                    help="comma-separated problem sizes (large, small)")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    with use_device(args.device):
        errs = [demo(n, label) for n, (_, label) in zip(sizes, SIZES)]
    return {"max_error": errs}


if __name__ == "__main__":
    main()

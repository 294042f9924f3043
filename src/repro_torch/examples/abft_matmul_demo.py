"""Paper §III.C end to end: ABFT matrix multiplication with ADCC (the JAX
package's ``examples/abft_matmul_demo.py``).

1. Runs the two-loop checksum-extended MM (Fig. 6) under the crash
   emulator, crashes mid-loop-1 and mid-loop-2, and recovers via
   checksum verification (+ recomputation of torn chunks).
2. Shows single-element error *correction* from checksums alone.
3. Runs the fused-checksum matmul kernel (B1) and the checksum-verify
   kernel (B2) on the card (their plain versions on the CPU), and
   verifies the checksums and finds a tampered element.

    python -m repro_torch.examples.abft_matmul_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import abft
from ..core.nvm import NVMConfig
from ..device import get_device, use_device
from ..kernels.abft_matmul.ops import abft_matmul_full
from ..kernels.checksum_verify.ops import verify_checksums
from ..scenarios import CrashPlan, run_scenario


def crash_demo(n: int = 512, k: int = 128) -> None:
    for loop in ("loop1", "loop2"):
        res = run_scenario(("mm", {"n": n, "k": k, "seed": 0}), "adcc",
                           CrashPlan.at_phase(loop, 2),
                           cfg=NVMConfig(cache_bytes=2 * 1024 * 1024))
        print(f"== crash in {loop}: {res.info['chunks_lost']} chunk(s) torn, "
              f"{res.info['corrected_elements']} element(s) "
              f"checksum-corrected, "
              f"final |C - A@B|_max = {res.metrics['max_error']:.2e}")


def correction_demo() -> bool:
    rng = np.random.default_rng(1)
    C = rng.uniform(-1, 1, (64, 64))
    Cf = abft.encode_full(C)
    Cf[17, 42] += 3.14159          # single corrupted element
    fixed, nfix = abft.correct_single_error(Cf)
    exact = bool(np.allclose(fixed, abft.encode_full(C)))
    print(f"== single-error correction: fixed {nfix} element, "
          f"recovered exactly: {exact}")
    return exact


def kernel_demo() -> dict:
    """B1 (``abft_matmul_full``, float32) and B2 (``verify_checksums``)
    on ``get_device()``: the checksums of C_f verify, and an element
    tampered at (5, 7) is found there."""
    dev = get_device()
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(size=(192, 256)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.normal(size=(256, 160)), dtype=torch.float32,
                     device=dev)
    cf = abft_matmul_full(a, b)           # fused-epilogue kernel
    ok, _, _ = verify_checksums(cf)       # detection kernel
    print(f"== fused-checksum matmul: C_f {tuple(cf.shape)}, "
          f"checksums verify: {bool(ok)}")
    bad = cf.clone()
    bad[5, 7] += 10.0
    ok2, rres, cres = verify_checksums(bad)
    where = (int(torch.argmax(rres.abs())), int(torch.argmax(cres.abs())))
    print(f"== tampered element detected at row {where[0]}, col {where[1]} "
          f"(truth: 5, 7)")
    return {"verified": bool(ok), "tamper_flagged": not bool(ok2),
            "tamper_at": where}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512,
                    help="crash demo's matrix size (k = n / 4)")
    args = ap.parse_args(argv)
    with use_device(args.device):
        crash_demo(args.n, args.n // 4)
        exact = correction_demo()
        out = kernel_demo()
    return {"corrected_exactly": exact, **out}


if __name__ == "__main__":
    main()

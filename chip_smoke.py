#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, starts and agrees
with itself on the card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases card,build,kernels   # a prefix, to debug

Phases, each printing one JSON line:

  card     the card's name and power limit as nvidia-smi gives them
  build    nvcc-compiles every kernel under src/repro_torch/kernels/csrc
           (one nvcc per source, started together)
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           at the shapes the batched sweep gives it and at ragged ones,
           with the tolerance stated, timed with CUDA events beside the
           plain version, one library call and the card's bound
  sweep    the port's main path, ``sweep(engine="fork", mode="batched")``,
           on four workloads under the torn-crash figure's strategies and
           full plans; every cell must equal the port's ``mode="measure"``
           cell, no adcc cell may fall back, and both kernels must have
           been launched by the sweep itself
  sharded  two of those workloads again with ``workers=2``: the spawned
           children each create their own CUDA context and load the built
           libraries; they must give the serial sweep's cells and report
           launches of both kernels, and a failing shard fails the phase

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA card the script exits at once with code 2.
The last line of a full run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script runs the port on a CUDA card and has no CPU "
                     "mode\n")
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch.core.backends import batched  # noqa: E402
from repro_torch.core.nvm import NVMConfig  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels.abft_matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.abft_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.checksum_verify import kernel as cv_kernel  # noqa: E402
from repro_torch.kernels.checksum_verify import ops as cv_ops  # noqa: E402
from repro_torch.scenarios import (CrashPlan, TornSpec,  # noqa: E402
                                   deterministic_cell_dict, sweep)
from repro_torch.scenarios import batched_engine, driver  # noqa: E402

PHASES = ("card", "build", "kernels", "sweep", "sharded")

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bounds
# below are stated against these whatever the card's power limit is.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12,     # FP64 tensor-core rate, the
              torch.float32: 67e12,     # card's highest for the type
              torch.bfloat16: 989e12}

# the torn-crash figure's sweep axes (benchmarks/fig_torn.py, full size)
TORN_SEED = 23
TORN_FRACTIONS = (0.0, 0.25, 0.5, 0.75, 1.0)
TORN_SAMPLES = 3
STRATEGIES = ("adcc", "undo_log", "checkpoint_nvm@2")
WORKLOADS = (
    ("cg", {"n": 4096, "iters": 12, "seed": 5}),    # largest dense-route system
    ("cg", {"n": 2048, "iters": 12, "seed": 5}),    # the torn-crash figure's
    ("mm", {"n": 1024, "k": 256, "seed": 1024}),    # the recompute figure's largest
    ("mm", {"n": 64, "k": 16, "seed": 2}),          # the torn-crash figure's
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after two warm-up calls. The operands used here exceed the L2 cache,
    so every call finds them in device memory."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs plain "
                             f"{want.shape}/{want.dtype}")
    g, w = got.to(torch.float64), want.to(torch.float64)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_abs_err(got, want)} "
                             f"(rtol {rtol}, atol {atol})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(out.strip().splitlines()[0], flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, info in built.items():
        if info["log"].strip():
            print(f"[nvcc {name}]\n{info['log'].strip()}", flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {name: {"seconds": info["seconds"],
                             "built": info["built"]}
                      for name, info in built.items()}})


def _matmul_checks(dev) -> list:
    """abft_matmul at ragged shapes and every type pair: product and both
    checksums against the plain version. Tolerances: float32 ``1e-4 /
    1e-3`` (order of a float32 accumulation over k terms; checksums add
    another n or m terms, so their atol scales with k like the
    reference's tests); bfloat16 ``2e-2`` (the output rounds at 2^-8)."""
    out = []
    for (m, k, n), dtype, rtol, atol in (
            ((257, 129, 65), torch.float32, 1e-4, 1e-3),
            ((100, 130, 70), torch.float32, 1e-4, 1e-3),
            ((256, 384, 128), torch.bfloat16, 2e-2, 2e-2),
            ((1, 512, 1), torch.float32, 1e-4, 1e-3),
            ((1, 512, 1), torch.bfloat16, 2e-2, 2e-2),
            ((257, 129, 65), torch.float64, 1e-12, 1e-12)):
        rng = np.random.default_rng(m * 7 + k * 3 + n)
        a = torch.from_numpy(rng.normal(size=(m, k))).to(dev, dtype)
        b = torch.from_numpy(rng.normal(size=(k, n))).to(dev, dtype)
        c, row, col = mm_ops.abft_matmul(a, b)
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        cp, rowp, colp = mm_kernel.abft_matmul_plain(a, b, acc_dtype=acc)
        name = f"abft_matmul{(m, k, n)}/{str(dtype)[6:]}"
        errs = [check_close(name + " C", c, cp, rtol, atol),
                check_close(name + " row", row, rowp, rtol, atol * k),
                check_close(name + " col", col, colp, rtol, atol * k)]
        out.append({"case": name, "max_abs_err": max(errs),
                    "rtol": rtol, "atol": atol})
    return out


def _tile_sums_checks(dev) -> list:
    out = []
    for (B, m, n), dtype, rtol, atol in (
            ((3, 257, 127), torch.float32, 1e-4, 1e-3),
            ((2, 100, 70), torch.bfloat16, 1e-4, 1e-3),
            ((5, 9, 5), torch.float64, 1e-12, 1e-12)):
        rng = np.random.default_rng(B * 101 + m * 11 + n)
        full = torch.from_numpy(rng.normal(size=(B, m + 1, n + 1))
                                ).to(dev, dtype)
        x = full[:, :-1, :-1]       # strided, as the sweep passes it
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        row, col = cv_ops.tile_sums_batch(x, acc_dtype=acc)
        rowp, colp = cv_kernel.tile_sums_plain(x, acc_dtype=acc)
        name = f"tile_sums{(B, m, n)}/{str(dtype)[6:]}"
        errs = [check_close(name + " row", row, rowp, rtol, atol),
                check_close(name + " col", col, colp, rtol, atol)]
        out.append({"case": name, "max_abs_err": max(errs),
                    "rtol": rtol, "atol": atol})
    # the verdict built on it: a clean full-checksum matrix verifies, a
    # tampered element is located
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 64))).to(dev, torch.float32)
    b = torch.from_numpy(rng.normal(size=(64, 64))).to(dev, torch.float32)
    cf = mm_ops.abft_matmul_full(a, b)
    ok, _, _ = cv_ops.verify_checksums(cf)
    cf[10, 20] += 50.0
    ok2, rres, cres = cv_ops.verify_checksums(cf)
    if not (bool(ok) and not bool(ok2) and int(rres.abs().argmax()) == 10
            and int(cres.abs().argmax()) == 20):
        raise AssertionError("verify_checksums: wrong verdict on the card")
    out.append({"case": "verify_checksums clean/tampered", "ok": True})
    return out


def phase_kernels() -> list:
    """Returns the contract's per-kernel records, ``launches`` still to be
    filled in by the sweep phase."""
    dev = torch.device("cuda")
    checks = _matmul_checks(dev) + _tile_sums_checks(dev)
    emit({"phase": "kernel_checks", "cases": checks})

    records = []

    # B1 at the sweep's shape: one wave of the CG scan on the largest
    # dense-route system, Z (W, n) @ S (n, n) in float64
    W, n = 256, batched.GEMM_MAX_N
    rng = np.random.default_rng(4096)
    Z = torch.from_numpy(rng.normal(size=(W, n))).to(dev)
    S = torch.from_numpy(rng.normal(size=(n, n))).to(dev)
    S = 0.5 * (S + S.T)
    got = mm_ops.gemm_batch(Z, S, acc_dtype=torch.float64)
    want, _, _ = mm_kernel.abft_matmul_plain(Z, S, acc_dtype=torch.float64)
    # float64, summation order only: k = 4096 terms of magnitude ~1 at
    # 1.1e-16 each stay far below 1e-9 absolute
    err = check_close("gemm_batch f64", got, want, rtol=1e-12, atol=1e-9)
    flops = 2.0 * W * n * n
    nbytes = 8.0 * (W * n + n * n + W * n)
    by_ops = flops / PEAK_FLOPS[torch.float64]
    by_bytes = nbytes / PEAK_BYTES_PER_S
    records.append({
        "name": "abft_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/abft_matmul.cu",
        "replaces": "src/repro/kernels/abft_matmul/kernel.py:99",
        "shape": f"gemm_batch f64 ({W},{n})@({n},{n})",
        "launches": None, "max_abs_err": err,
        "tolerance": "rtol 1e-12, atol 1e-9",
        "ms": time_ms(lambda: mm_ops.gemm_batch(
            Z, S, acc_dtype=torch.float64), 10),
        "launch_only_ms": time_ms(lambda: mm_kernel.abft_matmul_cuda(
            Z, S, acc_dtype=torch.float64), 10),
        "plain_ms": time_ms(lambda: mm_kernel.abft_matmul_plain(
            Z, S, acc_dtype=torch.float64), 10),
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": time_ms(lambda: torch.matmul(Z, S), 10),
        "library_call": "torch.matmul",
    })
    del Z, S, got, want

    # B2 at the sweep's shape: one launch group of the ABFT chunk screen at
    # n = 1024, the data block of (B, n+1, n+1) read through its strides
    m = 1025
    B = batched.mm_slabs_per_launch(m)
    V = torch.from_numpy(np.random.default_rng(1025).normal(
        size=(B, m, m))).to(dev)
    x = V[:, :-1, :-1]
    row, col = cv_ops.tile_sums_batch(x, acc_dtype=torch.float64)
    rowp, colp = cv_kernel.tile_sums_plain(x, acc_dtype=torch.float64)
    # float64, summation order only over 1024 terms of magnitude ~1
    err = max(check_close("tile_sums f64 row", row, rowp, 1e-12, 1e-10),
              check_close("tile_sums f64 col", col, colp, 1e-12, 1e-10))
    nbytes = 8.0 * (B * (m - 1) * (m - 1) + 2 * B * (m - 1))
    flops = 2.0 * B * (m - 1) * (m - 1)
    by_ops = flops / PEAK_FLOPS[torch.float64]
    by_bytes = nbytes / PEAK_BYTES_PER_S
    records.append({
        "name": "tile_sums", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tile_sums.cu",
        "replaces": "src/repro/kernels/checksum_verify/kernel.py:44",
        "shape": f"tile_sums_batch f64 V[:, :-1, :-1] of ({B},{m},{m})",
        "launches": None, "max_abs_err": err,
        "tolerance": "rtol 1e-12, atol 1e-10",
        "ms": time_ms(lambda: cv_ops.tile_sums_batch(
            x, acc_dtype=torch.float64), 10),
        "launch_only_ms": time_ms(lambda: cv_kernel.tile_sums_cuda(
            x, acc_dtype=torch.float64), 10),
        "plain_ms": time_ms(lambda: cv_kernel.tile_sums_plain(
            x, acc_dtype=torch.float64), 10),
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        # no single call gives both sums: the pair of reductions
        "library_ms": time_ms(lambda: (torch.sum(x, dim=2),
                                       torch.sum(x, dim=1)), 10),
        "library_call": "torch.sum(x, 2) and torch.sum(x, 1)",
    })
    return records


def _torn_plans():
    dense = tuple(
        CrashPlan.at_every_step(
            torn=TornSpec(fraction=f, seed=TORN_SEED, mode="random",
                          samples=TORN_SAMPLES))
        for f in TORN_FRACTIONS)
    evict = (CrashPlan.at_every_step(
        torn=TornSpec(fraction=0.5, seed=TORN_SEED, mode="eviction")),)
    return (CrashPlan.no_crash(),) + dense + evict


def _cell(res) -> dict:
    d = deterministic_cell_dict(res)
    d.pop("state_certified", None)      # fork/measure-only by contract
    return d


def phase_sweep(records: list) -> None:
    kw = dict(strategies=STRATEGIES, plans=_torn_plans(),
              cfg=NVMConfig(cache_bytes=1024 * 1024), engine="fork",
              workers=1)
    per_workload = []
    total_launches = {"abft_matmul": 0, "tile_sums": 0}
    for spec in WORKLOADS:
        # counts to zero just before the main path, read just after
        mm_kernel.launches = 0
        cv_kernel.launches = 0
        batched.reset_profile()
        batched_engine.reset_stats()
        t0 = time.perf_counter()
        cells = sweep([spec], mode="batched", **kw)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        launches = {"abft_matmul": mm_kernel.launches,
                    "tile_sums": cv_kernel.launches}
        profile = dict(batched.profile)
        stats = dict(batched_engine.stats)

        t0 = time.perf_counter()
        measured = sweep([spec], mode="measure", **kw)
        t_measure = time.perf_counter() - t0
        after_measure = (mm_kernel.launches, cv_kernel.launches)
        if after_measure != (launches["abft_matmul"], launches["tile_sums"]):
            raise AssertionError("the measure sweep launched a kernel")

        if len(cells) != len(measured) or not cells:
            raise AssertionError(f"{spec}: {len(cells)} batched cells vs "
                                 f"{len(measured)} measure cells")
        for got, want in zip(cells, measured):
            if _cell(got) != _cell(want):
                raise AssertionError(
                    f"{spec}: batched cell differs from measure cell\n"
                    f"batched: {_cell(got)}\nmeasure: {_cell(want)}")
            if got.strategy == "adcc" and "batched_fallback" in got.info:
                raise AssertionError(
                    f"{spec}: adcc cell fell back: "
                    f"{got.info['batched_fallback']} ({got.plan})")
            if got.crash_step is None and got.correct is not True:
                raise AssertionError(f"{spec}: crash-free run of "
                                     f"{got.strategy} finalized incorrect")
        kernel = "abft_matmul" if spec[0] == "cg" else "tile_sums"
        if launches[kernel] == 0:
            raise AssertionError(f"{spec}: the batched sweep never launched "
                                 f"the {kernel} kernel")
        for k, v in launches.items():
            total_launches[k] += v
        transfer = (profile["shared_upload_seconds"]
                    + profile["upload_seconds"]
                    + profile["download_seconds"])
        per_workload.append({
            "workload": [spec[0], spec[1]], "cells": len(cells),
            "adcc_cells": sum(c.strategy == "adcc" for c in cells),
            "batched_seconds": t_batched, "measure_seconds": t_measure,
            "cells_per_second_batched": len(cells) / t_batched,
            "launches": launches,
            "launch_groups": profile["launch_groups"],
            "shared_upload_seconds": profile["shared_upload_seconds"],
            "upload_seconds": profile["upload_seconds"],
            "device_seconds": profile["device_seconds"],
            "download_seconds": profile["download_seconds"],
            "transfer_seconds": transfer,
            "host_seconds": t_batched - transfer - profile["device_seconds"],
            **stats,
        })
        emit({"phase": "sweep", **per_workload[-1]})
    for rec in records:
        rec["launches"] = total_launches[rec["name"]]
        if rec["launches"] <= 0:
            raise AssertionError(f"main path never launched {rec['name']}")
    emit({"phase": "sweep_total",
          "cells": sum(w["cells"] for w in per_workload),
          "batched_seconds": sum(w["batched_seconds"] for w in per_workload),
          "measure_seconds": sum(w["measure_seconds"] for w in per_workload),
          "launches": total_launches})


def phase_sharded() -> None:
    """A sharded batched sweep after CUDA is initialised in this process:
    the workers must be spawned, select the card themselves, build or
    load the kernel libraries, launch both kernels and give the serial
    sweep's cells. A batched shard is never degraded to another mode
    (``driver._degrade_job``), so a worker that fails on the card fails
    this phase; the workers' own launch counts come back with their
    results."""
    kw = dict(strategies=STRATEGIES, plans=_torn_plans(),
              cfg=NVMConfig(cache_bytes=1024 * 1024), engine="fork",
              mode="batched")
    specs = [WORKLOADS[1], WORKLOADS[3]]
    serial = sweep(specs, workers=1, **kw)
    before = launch_counts()
    t0 = time.perf_counter()
    sharded = sweep(specs, workers=2, shard_retries=0, shard_timeout=240.0,
                    **kw)
    seconds = time.perf_counter() - t0
    if launch_counts() != before:
        raise AssertionError("the sharded sweep launched in the parent")
    if [_cell(c) for c in sharded] != [_cell(c) for c in serial]:
        raise AssertionError("sharded batched sweep differs from serial")
    if any("batched_fallback" in c.info for c in sharded
           if c.strategy == "adcc"):
        raise AssertionError("a sharded adcc cell fell back")
    worker_launches = dict(driver.shard_launches)
    for kernel in ("abft_matmul", "tile_sums"):
        if worker_launches.get(kernel, 0) <= 0:
            raise AssertionError(f"the spawned workers never launched the "
                                 f"{kernel} kernel: {worker_launches}")
    emit({"phase": "sharded", "workers": 2, "cells": len(sharded),
          "seconds": seconds, "worker_launches": worker_launches})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated prefix of: " + ",".join(PHASES))
    want = [p for p in ap.parse_args().phases.split(",") if p]
    if want != list(PHASES[:len(want)]):
        ap.error(f"--phases must be a prefix of {','.join(PHASES)}")

    t0 = time.perf_counter()
    phase_card()
    records = []
    if "build" in want:
        phase_build()
    if "kernels" in want:
        records = phase_kernels()
    if "sweep" in want:
        phase_sweep(records)
    if "sharded" in want:
        phase_sharded()
    if want != list(PHASES):
        emit({"partial": True, "kernels": records})
        return
    emit({"kernels": records})
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

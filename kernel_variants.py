#!/usr/bin/env python3
"""Times design variants of two hand-written kernels of the port on one
CUDA card, beside the shipped design, at the shapes of their main paths:

* flash_attention (bf16, the llama3-8b prefill: q (2,4096,32,128), k/v
  (2,4096,8,128), causal): key tiles of 64 or 128 rows, one or two tiles
  loaded ahead, and P rounded once to bf16 instead of split into hi + lo;
* abft_matmul (f64, ``gemm_batch`` (256,4096)@(4096,4096)): the DMMA
  shape, slab depth and ring depth.

    python3 kernel_variants.py

Each variant is the shipped source with a few constants or lines
replaced, compiled by ``nvcc`` with the package's flags into
``build/variants/`` (all at once) and launched through the shipped
wrapper. None of them is selectable by the package. Every variant is
checked against the plain version first; the single-P variant is
expected to miss the bf16 bound, so it only reports its error. One JSON
line per variant: ms (CUDA events, mean of 20 after 2 warm-ups),
registers and spills, max abs error, whether it met the bound.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("kernel_variants: no CUDA card\n")
    sys.exit(2)

import chip_smoke as cs  # noqa: E402  (the smoke run's timing and checks)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.abft_matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

OUT = _build.build_dir().parent / "variants"

_FA_BKV = "constexpr int BKV = 128;          // key rows per tile"
_FA_AHEAD = ("constexpr int AHEAD = 1;          "
             "// key tiles in flight ahead of the one computed")
_FA_LO = "            pv<E, HD>(acc, pl[kc], dv);\n"
_MM_BK = "constexpr int BK = 16;                  // depth of one slab"
_MM_STAGES = "constexpr int STAGES = 4;               // slabs in the ring"
_MM_SHAPE = "constexpr int MMA_M = 16, MMA_K = 4;"

FLASH = {
    "shipped: 128-key tiles, 1 tile ahead (ring of 3)": [],
    "64-key tiles, 1 tile ahead": [(_FA_BKV, _FA_BKV.replace("128;", "64;"))],
    "64-key tiles, 2 tiles ahead (ring of 4)": [
        (_FA_BKV, _FA_BKV.replace("128;", "64;")),
        (_FA_AHEAD, _FA_AHEAD.replace("1;", "2;"))],
    "single bf16 P (not shipped)": [(_FA_LO, "")],
}
MATMUL = {
    "shipped: m16n8k4, 16-deep slabs, 4 stages, 4 warps of 32x32": [],
    "m8n8k4 (the sm_80 shape)": [(_MM_SHAPE, "constexpr int MMA_M = 8, MMA_K = 4;")],
    "m16n8k8": [(_MM_SHAPE, "constexpr int MMA_M = 16, MMA_K = 8;")],
    "m16n8k16": [(_MM_SHAPE, "constexpr int MMA_M = 16, MMA_K = 16;")],
    "32-deep slabs, 3 stages": [(_MM_BK, _MM_BK.replace("16;", "32;")),
                                (_MM_STAGES, _MM_STAGES.replace("4;", "3;"))],
}


def _sources(lib: str, variants: dict) -> dict:
    text = (_build.CSRC / f"{lib}.cu").read_text()
    out = {}
    for i, (label, edits) in enumerate(variants.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise AssertionError(f"{lib} variant {label!r}: {old!r} "
                                     f"is not in the source")
            src = src.replace(old, new)
        out[label] = (OUT / f"{lib}_v{i}.cu", src)
    return out


def _build_all(jobs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (path, src) in jobs.items():
        path.write_text(src)
        so = path.with_suffix(".so")
        procs[key] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        built[key] = (so, log)
    return built


def _resources(log: str, marker: str) -> dict:
    """Registers and spills of the largest instantiation of ``marker``."""
    res = {fn: r for fn, r in cs._ptxas_resources(log).items() if marker in fn}
    if not res:
        return {}
    fn = max(res, key=lambda f: int((re.findall(r"Li(\d+)E", f) or ["0"])[0]))
    return res[fn]


def _use(module, so: str) -> None:
    """Point the shipped wrapper at a variant's library."""
    module._lib = None
    saved = _build.load
    _build.load = lambda name: ctypes.CDLL(so)
    try:
        module._library()
    finally:
        _build.load = saved


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card()
    dev = torch.device("cuda")
    jobs = {("flash_attention", k): v
            for k, v in _sources("flash_attention", FLASH).items()}
    jobs.update({("abft_matmul", k): v
                 for k, v in _sources("abft_matmul", MATMUL).items()})
    built = _build_all(jobs)

    g = torch.Generator(device=dev).manual_seed(cs.SERVE_SEED)
    q, k, v = (torch.randn((2, 4096, n, 128), generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
               for n in (32, 8, 8))
    want = fa_kernel.flash_attention_plain(q, k, v)
    for label in FLASH:
        so, log = built[("flash_attention", label)]
        _use(fa_kernel, str(so))
        got = fa_kernel.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        bad = ((got.double() - want.double()).abs()
               > cs.FLASH_BF16_ATOL + cs.FLASH_BF16_RTOL * want.double().abs())
        cs.emit({"kernel": "flash_attention", "variant": label,
                 "ms": cs.time_ms(lambda: fa_kernel.flash_attention_cuda(
                     q, k, v), 20),
                 "max_abs_err": cs.max_abs_err(got, want),
                 "out_of_bound": int(bad.sum()), "elements": got.numel(),
                 **_resources(log, "flash_fwd_wgmma_kernelI13__nv_bfloat16Li128E")})
    del q, k, v, want, got

    rng = np.random.default_rng(4096)
    Z = torch.from_numpy(rng.normal(size=(256, 4096))).to(dev)
    S = torch.from_numpy(rng.normal(size=(4096, 4096))).to(dev)
    want, _, _ = mm_kernel.abft_matmul_plain(Z, S, acc_dtype=torch.float64)
    for label in MATMUL:
        so, log = built[("abft_matmul", label)]
        _use(mm_kernel, str(so))
        got, _, _ = mm_kernel.abft_matmul_cuda(Z, S, acc_dtype=torch.float64)
        torch.cuda.synchronize()
        bad = (got - want).abs() > 1e-9 + 1e-12 * want.abs()
        cs.emit({"kernel": "abft_matmul", "variant": label,
                 "ms": cs.time_ms(lambda: mm_kernel.abft_matmul_cuda(
                     Z, S, acc_dtype=torch.float64), 20),
                 "max_abs_err": cs.max_abs_err(got, want),
                 "out_of_bound": int(bad.sum()), "elements": got.numel(),
                 **_resources(log, "abft_mm_f64_dmma_kernelILb1")})
    fa_kernel._lib = mm_kernel._lib = None


if __name__ == "__main__":
    main()

"""Port vs reference, the example twins (``repro_torch.examples``) on the
CPU at small sizes.

The scenario examples print what their cells computed: the port's lines
must equal those of ``repro``'s examples (``examples/*.py``, imported
from their files; ``repro``'s ``mc_xsbench`` takes no arguments, so its
three cells are run through ``repro``'s ``run_scenario`` at the same
reduced size and printed by the twin's ``report``). The quickstart twin
must recover bitwise after its crash, the ABFT demo's kernels must
verify and find the tampered element, and the trainer must give finite
losses. No line printed here holds a wall time but the quickstart's
sweep table, which is not compared.
"""

import contextlib
import importlib.util
import io
import math
import os

import numpy as np
import pytest

import repro_torch
from repro.core.nvm import NVMConfig as RefNVMConfig
from repro.scenarios import CrashPlan as RefCrashPlan
from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.examples import (abft_matmul_demo, cg_crash_recovery,
                                  mc_xsbench, quickstart, train_e2e)
from repro_torch.kernels.abft_matmul import kernel as mm_kernel
from repro_torch.kernels.checksum_verify import kernel as cv_kernel

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


@pytest.fixture(autouse=True)
def no_launch():
    yield
    assert mm_kernel.launches == 0 and cv_kernel.launches == 0


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return out.getvalue().splitlines(), result


def test_quickstart_recovers_bitwise():
    lines, res = _printed(quickstart.main, ["--device", "cpu", "--small"])
    assert res["bitwise"] and res["sweep_ok"]
    assert res["resumed_from"] is not None
    assert all(math.isfinite(x) for x in res["losses"])
    assert any("BITWISE IDENTICAL" in line for line in lines)


@pytest.mark.parametrize("n,label", cg_crash_recovery.SIZES)
def test_cg_lines_match_reference(n, label):
    ref = _reference_example("cg_crash_recovery")
    want, _ = _printed(ref.demo, n, label)
    with repro_torch.use_device("cpu"):
        got, err = _printed(cg_crash_recovery.demo, n, label)
    assert got == want
    assert err == 0.0


def test_cg_main_prints_both_cells():
    lines, res = _printed(cg_crash_recovery.main,
                          ["--device", "cpu", "--sizes", "4096,1024"])
    assert len(res["max_error"]) == 2
    assert sum("resumed to completion" in line for line in lines) == 2


def test_abft_crash_and_correction_lines_match_reference():
    ref = _reference_example("abft_matmul_demo")
    want, _ = _printed(lambda: (ref.crash_demo(), ref.correction_demo()))
    with repro_torch.use_device("cpu"):
        got, _ = _printed(lambda: (abft_matmul_demo.crash_demo(),
                                   abft_matmul_demo.correction_demo()))
    assert got == want


def test_abft_kernel_demo_verifies_and_finds_the_tamper():
    """B1 and B2 through their plain versions on the CPU (no launch)."""
    lines, res = _printed(abft_matmul_demo.main,
                          ["--device", "cpu", "--n", "128"])
    assert res == {"corrected_exactly": True, "verified": True,
                   "tamper_flagged": True, "tamper_at": (5, 7)}
    assert lines[-1].startswith("== tampered element detected at row 5, "
                                "col 7")


def test_mc_xsbench_lines_match_reference():
    lookups, grid = 3000, 2000
    got, res = _printed(mc_xsbench.main, ["--device", "cpu", "--lookups",
                                          str(lookups), "--grid-points",
                                          str(grid)])
    params = dict(mc_xsbench.PARAMS, lookups=lookups, grid_points=grid)
    nvm = RefNVMConfig(cache_bytes=2 * 1024 * 1024, replacement="fifo")
    crash = RefCrashPlan.at_step(lookups // 10 - 1)
    cells = [ref_run_scenario(("xsbench", {**params, "policy": policy}),
                              "adcc", plan, cfg=nvm)
             for policy, plan in (("selective", RefCrashPlan.no_crash()),
                                  ("basic", crash), ("selective", crash))]
    want, same = _printed(mc_xsbench.report, params, *cells)
    assert got == want
    assert res["selective_bitwise"] and same


def test_train_e2e_gives_finite_losses(tmp_path):
    lines, res = _printed(train_e2e.main, [
        "--device", "cpu", "--steps", "4", "--layers", "1", "--batch", "2",
        "--seq", "16", "--workdir", str(tmp_path / "wd")])
    assert res["finite"] and len(res["losses"]) == 4
    assert np.isfinite(res["median_step_s"])
    assert (tmp_path / "wd" / "ledger.jsonl").exists()
    assert lines[0].startswith("== mamba2-130m:")

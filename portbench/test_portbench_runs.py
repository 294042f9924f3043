"""Whole runs of the cells on the CPU at a tiny size (``rehearse.py``):
the result line's schema, the modules a run loads, and correctness
coming out false under each planted fault."""

import json
import os
import subprocess
import sys

import pytest

from portbench import bench
from portbench.rehearse import rehearse

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


@pytest.fixture(scope="module")
def rehearsals():
    """Each cell traced, in one fresh process: its result lines and the
    top-level names of every module it loaded."""
    env = dict(os.environ, PYTHONPATH=os.path.join(bench.ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "rehearse.py"), *CELLS,
         "--trace"], capture_output=True, text=True, env=env, timeout=240,
        cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return [json.loads(x) for x in lines[:-1]], set(lines[-1].split())


def test_no_jax_and_no_jax_package(rehearsals):
    _, modules = rehearsals
    assert "repro_torch" in modules
    assert not modules & set(bench.FORBIDDEN)


def test_result_line_schema(rehearsals):
    lines, _ = rehearsals
    bj = bench.benchmark()
    assert len(lines) == len(CELLS)
    for cell, res in zip(CELLS, lines):
        keys = list(res)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"] and keys[-1] == "checks"
        assert res["correct"] is True and res["failed"] == 0
        assert res["attempted"] > 0
        for name, c in res["checks"].items():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
        dev = res["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        units = {m["name"]: m["unit"] for m in bj["per_layer"]}
        for name, v in res["metrics"].items():
            assert v["unit"] == units[name]
            assert isinstance(v["value"], float)


@pytest.mark.parametrize("cell,fault", [
    ("mamba2-130m.train_adcc", "unchanged"),
    ("mamba2-130m.train_adcc", "half_batch"),
    ("mamba2-130m.train_adcc", "slot"),
    ("mamba2-130m.train_plain", "unchanged"),
    ("mamba2-130m.train_plain", "half_batch")])
def test_planted_fault_is_not_correct(cell, fault):
    line, err = rehearse(cell, fault=fault, seconds=0.05)
    res = json.loads(line)
    assert res["correct"] is False, err[-len(res["checks"]):]

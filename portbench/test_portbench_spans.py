"""The readers of the program's spans (``spans.py``, ``metrics/*_share``,
``device_ops_per_step`` and ``device_wait_share``) on made-up traces,
what they give where the program marks no span (a parent without spans),
and a traced rehearsal of each cell on the CPU reading the host-span
metrics."""

import json

import pytest

from portbench import bench
from portbench.rehearse import rehearse
from portbench.trace import WINDOW, Trace

MS = 1_000_000
SHARES = {"forward_share.train": 20.0, "backward_share.train": 30.0,
          "optimizer_share.train": 10.0, "checksum_share.train": 6.0,
          "data_share.train": 2.0}
ON_DEVICE = ["device_ops_per_step.train", "device_wait_share.train"]
NEW = [*SHARES, *ON_DEVICE]


def _trace(spans=True, device=True):
    """Window 0-100 ms, two steps (0-45, 50-95 ms) and their phases; five
    launches inside the steps (ids 1-4, 6) and one after them (id 9);
    blocking calls inside the steps: a synchronisation (id 5, 1 ms) and a
    copy into pageable memory (id 6, 2 ms); not blocking or not inside: a
    device-to-device copy (id 3) and a synchronisation after the steps
    (id 7)."""
    host = [(WINDOW, 0, 100 * MS, 0)]
    if spans:
        for t0 in (0, 50):
            host += [("train.step", t0 * MS, (t0 + 45) * MS, 0),
                     ("train.batch", t0 * MS, (t0 + 1) * MS, 0),
                     ("train.forward", (t0 + 1) * MS, (t0 + 11) * MS, 0),
                     ("train.cast", (t0 + 1) * MS, (t0 + 2) * MS, 0),
                     ("train.backward", (t0 + 11) * MS, (t0 + 26) * MS, 0),
                     ("train.optimizer", (t0 + 26) * MS, (t0 + 31) * MS, 0),
                     ("train.checksums", (t0 + 31) * MS, (t0 + 33) * MS, 0),
                     ("train.loss_sync", (t0 + 33) * MS, (t0 + 35) * MS, 0),
                     ("adcc.record", (t0 + 35) * MS, (t0 + 36) * MS, 0)]
        # a range of the same name outside the window is not read
        host.append(("train.forward", 200 * MS, 300 * MS, 0))
    host += [("cudaLaunchKernel", 2 * MS, 3 * MS, 1),
             ("cudaLaunchKernel", 12 * MS, 13 * MS, 2),
             ("cudaMemcpyAsync", 30 * MS, 31 * MS, 3),
             ("cudaLaunchKernel", 60 * MS, 61 * MS, 4),
             ("cudaStreamSynchronize", 36 * MS, 37 * MS, 5),
             ("cudaMemcpyAsync", 80 * MS, 82 * MS, 6),
             ("cudaStreamSynchronize", 96 * MS, 97 * MS, 7),
             ("cudaLaunchKernel", 97 * MS, 98 * MS, 9),
             ("aten::add", 60 * MS, 62 * MS, 0)]
    dev = [("k", 3 * MS, 5 * MS, 1), ("k", 13 * MS, 20 * MS, 2),
           ("Memcpy DtoD (Device -> Device)", 31 * MS, 32 * MS, 3),
           ("k", 61 * MS, 70 * MS, 4),
           ("Memcpy DtoH (Device -> Pageable)", 81 * MS, 82 * MS, 6),
           ("k", 98 * MS, 99 * MS, 9)] if device else []
    return Trace(dev, host)


def _ctx(trace):
    return {"kind": "train", "window_s": 30.0, "trace": trace,
            "timings": {"ledger_append": [], "host_copy": []}}


def test_span_readers_on_a_made_up_trace():
    ctx = _ctx(_trace())
    for name, want in SHARES.items():
        assert bench.read_metric(name, ctx) == pytest.approx(want), name
    # ids 1-4 and 6 were launched inside the two steps; id 9 after them
    assert bench.read_metric("device_ops_per_step.train", ctx) == 2.5
    # 1 + 2 ms blocked of the 100 ms stretch
    assert bench.read_metric("device_wait_share.train", ctx) \
        == pytest.approx(3.0)


@pytest.mark.parametrize("ctx", [
    _ctx(_trace(spans=False)),       # a program that marks no span
    _ctx(None),                      # no profiled stretch
    dict(_ctx(_trace()), kind=None)], ids=["no_spans", "no_trace", "kind"])
def test_span_readers_find_nothing(ctx):
    for name in NEW:
        assert bench.read_metric(name, ctx) is None, name


def test_device_ops_need_device_operations():
    ctx = _ctx(_trace(device=False))
    for name in ON_DEVICE:
        assert bench.read_metric(name, ctx) is None, name
    assert bench.read_metric("forward_share.train", ctx) \
        == pytest.approx(20.0)


def test_span_metrics_are_declared_for_both_cells():
    bj = bench.benchmark()
    units = {m["name"]: m["unit"] for m in bj["per_layer"]}
    assert units["device_ops_per_step.train"] == "ops"
    assert units["device_wait_share.train"] == "%"
    for w in bj["workloads"]:
        names = {m["name"] for m in bench.metrics_of(bj, w["name"],
                                                     "per_layer")}
        assert set(NEW) <= names
        assert all(units[n] == "%" for n in SHARES)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.benchmark()["workloads"]])
def test_traced_rehearsal_reads_the_host_spans(cell):
    line, _ = rehearse(cell, trace=True, seconds=0.05)
    res = json.loads(line)
    assert res["correct"] is True
    units = {m["name"]: m["unit"] for m in bench.benchmark()["per_layer"]}
    got = res["metrics"]
    for name in SHARES:
        assert got[name]["unit"] == units[name]
        assert 0.0 < got[name]["value"] < 100.0, name
    assert sum(got[n]["value"] for n in SHARES) < 100.0
    # the CPU's trace has no device operations
    assert not set(ON_DEVICE) & set(got)

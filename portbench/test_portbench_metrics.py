"""Each per-layer reader's and the trace's arithmetic on made-up events,
and the helpers the result line is built from."""

import math

import pytest

from portbench import bench
from portbench.trace import WINDOW, Trace

MS = 1_000_000


def _trace():
    # window 0-100 ms; device ops 10-20, 15-30 (overlap), 50-60, 90-110
    device = [("gemm", 10 * MS, 20 * MS, 1), ("gemm", 15 * MS, 30 * MS, 2),
              ("softmax", 50 * MS, 60 * MS, 3), ("copy", 90 * MS, 110 * MS, 4)]
    host = [(WINDOW, 0, 100 * MS, 0),
            ("cudaLaunchKernel", 48 * MS, 49 * MS, 3),
            ("cudaLaunchKernel", 9 * MS, 9 * MS + 1, 1),
            ("aten::item", 30 * MS, 50 * MS, 0),
            ("aten::_local_scalar_dense", 31 * MS, 49 * MS, 0)]
    return device, host


def test_busy_union_and_gaps():
    device, host = _trace()
    tr = Trace(device, host)
    assert tr.window_s == pytest.approx(0.1)
    # union inside the window: 10-30, 50-60, 90-100
    assert tr.busy_s() == pytest.approx(0.040)
    gaps = tr.idle_gaps(10)
    assert [g[1] for g in gaps] == pytest.approx([0.030, 0.020, 0.010])
    # the gap 60-90 has no host event at 75 ms; 30-50 the innermost at 40
    assert gaps[0][0].startswith("host:")
    assert gaps[1][0] == "aten::_local_scalar_dense"
    assert tr.top_ops(2) == [["gemm", pytest.approx(0.025)],
                             ["softmax", pytest.approx(0.010)]]


def test_trace_needs_its_window():
    with pytest.raises(ValueError):
        Trace([], [("aten::mm", 0, 1, 0)])


def test_readers():
    device, host = _trace()
    tr = Trace(device, host)
    peak = bench.peak_of("NVIDIA H100 80GB HBM3")
    train = {"kind": "train", "window_s": 10.0, "flops": 989e12,
             "timings": {"ledger_append": [0.1, 0.2], "host_copy": [0.5, 0.7]},
             "slot_bytes": 3e9, "trace": tr, "peak": peak}
    assert bench.read_metric("adcc_share.train", train) \
        == pytest.approx(15.0)
    assert bench.read_metric("host_copy_gb_per_s.train", train) \
        == pytest.approx(5.0)
    assert bench.read_metric("mfu.train", train) == pytest.approx(10.0)
    assert bench.read_metric("device_idle_share.train", train) \
        == pytest.approx(60.0)
    plain = dict(train, timings={"ledger_append": [], "host_copy": []})
    assert bench.read_metric("adcc_share.train", plain) is None
    assert bench.read_metric("host_copy_gb_per_s.train", plain) is None
    assert bench.read_metric("mfu.train", dict(train, peak=None)) is None
    assert bench.read_metric("device_idle_share.train",
                             dict(train, trace=None)) is None
    assert bench.read_metric("mfu.train", dict(train, kind=None)) is None


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bj = bench.benchmark()
    for m in bj["per_layer"]:
        assert bench.read_metric(m["name"], {"kind": None}) is None
    for w in bj["workloads"]:
        r = bench.load_run(w["name"], 1, 1.0, False, 0.0, bj)
        assert set(r.limits["limits"]) and r.traffic["driver"] == "train"
        assert bench.metrics_of(bj, w["name"], "per_layer")
        e2e = [m["name"] for m in bench.metrics_of(bj, w["name"],
                                                   "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2


def test_leaf_gaps_and_checks():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "tiny": 1e-9}
    assert bench.worst_leaf_gap({"a": 1.0, "b": 2.0, "c": 4.0}, ref) == 0.0
    # a small leaf is measured against the median leaf's norm
    assert bench.worst_leaf_gap({"a": 1.5, "b": 2.0, "c": 4.0}, ref) \
        == pytest.approx(0.5 / 1.5)
    assert bench.worst_leaf_gap({"a": 1.0, "b": 2.0}, ref) == math.inf
    checks = bench.checks_block({"x": 1.0}, {"limits": {"x": 2.0,
                                                        "y": 1.0}})
    assert checks["y"]["value"] == math.inf and not bench.passes(checks)


@pytest.mark.parametrize("change", [
    {"clients": 4},                                    # a key nothing reads
    {"tokens": {"dist": "uniform", "exponent": 1.0, "copy_share": 0.5}},
    {"optimizer": {"name": "lion"}},
    {"mode": "sync"}])
def test_traffic_refuses_what_nothing_reads(change):
    from portbench.drivers import train
    traffic = bench.load_json("traffic", "train_adcc.json")
    train.check(traffic)
    for k, v in change.items():
        traffic[k] = ({**traffic[k], **v}
                      if isinstance(traffic.get(k), dict) else v)
    with pytest.raises(ValueError):
        train.check(traffic)

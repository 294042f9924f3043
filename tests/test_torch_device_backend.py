"""Port vs reference, the ``device`` emulator backend: ``repro_torch``'s
``DeviceBackend`` (cache transitions as torch ops, here on the CPU)
against ``repro``'s ``VectorizedBackend`` — the oracle the reference
holds its own device backend to. Exact equality throughout: NVM image
bytes, every ``TrafficStats`` field including the float
``modeled_seconds``, occupancy, dirty sets, survivor selection.

With ``MIN_DEVICE_ENTRIES`` forced to 1 every eviction-free span op
takes the device path, and the traces' tiny caches keep the
speculative-launch/host-path boundary under constant pressure (twins of
tests/test_backend_equivalence.py's device suite).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.backends as ref_backends
import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro_torch
import repro_torch.core.backends as port_backends
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc
from repro_torch.core.backends import batched
from repro_torch.core.backends.device import DeviceBackend


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


@pytest.fixture
def device_hot(monkeypatch):
    """Every eviction-free span op and validity scan through the device
    math, whatever its size; counts reset."""
    monkeypatch.setattr(DeviceBackend, "MIN_DEVICE_ENTRIES", 1)
    batched.reset_profile()


def _pair(cfg, ref_kind="vectorized"):
    ref = ref_nvm.CrashEmulator(ref_nvm.NVMConfig(backend=ref_kind, **cfg))
    port = port_nvm.CrashEmulator(port_nvm.NVMConfig(backend="device", **cfg))
    assert port.backend.kind == "device"
    return ref, port


def _make_pair(rng, replacement):
    cache_lines = int(rng.integers(1, 10))
    line_bytes = int(rng.choice([32, 64]))
    ref, port = _pair(dict(cache_bytes=cache_lines * line_bytes,
                           line_bytes=line_bytes, replacement=replacement))
    regions = []
    for i in range(int(rng.integers(2, 5))):
        n = int(rng.integers(1, 600))
        dtype = [np.float64, np.int32, np.int64][int(rng.integers(0, 3))]
        sector = int(rng.choice([1, 1, 2, 4]))
        regions.append((f"r{i}", n, dtype,
                        ref.alloc(f"r{i}", (n,), dtype, sector_lines=sector),
                        port.alloc(f"r{i}", (n,), dtype,
                                   sector_lines=sector)))
    return ref, port, regions


def _assert_same(ref, port, regions, ctx):
    for field in dataclasses.fields(ref.stats):
        a, b = getattr(ref.stats, field.name), getattr(port.stats, field.name)
        assert a == b, f"{ctx}: stats.{field.name}: repro={a} port={b}"
    assert ref.backend.occupancy_lines == port.backend.occupancy_lines, ctx
    for name, *_ in regions:
        assert ref.store.image[name].tobytes() \
            == port.store.image[name].tobytes(), f"{ctx}: image {name!r}"
        assert np.array_equal(ref.backend.dirty_entries(name),
                              port.backend.dirty_entries(name)), \
            f"{ctx}: dirty set {name!r}"
    assert ref.backend.dirty_eviction_order() \
        == port.backend.dirty_eviction_order(), ctx


@pytest.mark.parametrize("replacement", ["lru", "fifo"])
@pytest.mark.parametrize("seed", range(12))
def test_randomized_trace_device_equivalence(seed, replacement, device_hot):
    """Every eviction-free op takes the device path, every op under
    pressure the host path; the states never diverge at the boundary."""
    rng = np.random.default_rng(seed)
    ref, port, regions = _make_pair(rng, replacement)
    for step in range(120):
        name, n, dtype, r_ref, r_port = \
            regions[int(rng.integers(0, len(regions)))]
        op = rng.random()
        ctx = f"seed={seed} {replacement} step={step} region={name}"
        if op < 0.45:
            lo = int(rng.integers(0, n))
            hi = int(rng.integers(lo + 1, n + 1))
            val = rng.integers(0, 1000, size=hi - lo).astype(dtype)
            r_ref[lo:hi] = val
            r_port[lo:hi] = val
        elif op < 0.75:
            lo = int(rng.integers(0, n))
            hi = int(rng.integers(lo + 1, n + 1))
            assert np.array_equal(r_ref[lo:hi], r_port[lo:hi]), ctx
        elif op < 0.90:
            if rng.random() < 0.5:
                r_ref.flush()
                r_port.flush()
            else:
                lo = int(rng.integers(0, n))
                hi = int(rng.integers(lo + 1, n + 1))
                r_ref.flush(slice(lo, hi))
                r_port.flush(slice(lo, hi))
        elif op < 0.96:
            assert ref.crash() == port.crash(), ctx
            for nm, _, _, a, b in regions:
                assert np.array_equal(a.view, b.view), f"{ctx}: {nm}"
        else:
            ref.drain()
            port.drain()
        _assert_same(ref, port, regions, ctx)
    ref.drain()
    port.drain()
    _assert_same(ref, port, regions, f"seed={seed} final drain")
    assert batched.profile["cache_op_calls"] > 0
    assert batched.profile["validity_calls"] > 0


@pytest.mark.parametrize("granularity", ["line", "word"])
@pytest.mark.parametrize("seed", range(6))
def test_device_survival_crashes_equivalent(seed, granularity, device_hot):
    """Torn crashes at line and word granularity: survivor selection
    reads the dirty queue and stamps the device path wrote."""
    rng = np.random.default_rng(7000 + seed)
    ref, port, regions = _make_pair(rng, ("lru", "fifo")[seed % 2])
    for step in range(60):
        name, n, dtype, r_ref, r_port = \
            regions[int(rng.integers(0, len(regions)))]
        ctx = f"seed={seed} {granularity} step={step} region={name}"
        op = rng.random()
        if op < 0.6:
            lo = int(rng.integers(0, n))
            hi = int(rng.integers(lo + 1, n + 1))
            val = rng.integers(0, 1000, size=hi - lo).astype(dtype)
            r_ref[lo:hi] = val
            r_port[lo:hi] = val
        elif op < 0.8:
            lo = int(rng.integers(0, n))
            hi = int(rng.integers(lo + 1, n + 1))
            assert np.array_equal(r_ref[lo:hi], r_port[lo:hi]), ctx
        else:
            kw = dict(fraction=float(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0])),
                      seed=int(rng.integers(0, 1 << 16)),
                      mode=str(rng.choice(["random", "eviction"])),
                      granularity=granularity)
            assert ref.crash(ref_backends.LineSurvival(**kw)) \
                == port.crash(port_backends.LineSurvival(**kw)), (ctx, kw)
            for nm, _, _, a, b in regions:
                assert np.array_equal(a.view, b.view), f"{ctx}: {nm}"
        _assert_same(ref, port, regions, ctx)


def test_device_media_fault_byte_identical(device_hot):
    views = []
    for nvm, backends, kind in ((ref_nvm, ref_backends, "vectorized"),
                                (port_nvm, port_backends, "device")):
        emu = nvm.CrashEmulator(nvm.NVMConfig(cache_bytes=256, line_bytes=64,
                                              backend=kind))
        r = emu.alloc("x", (64,))
        r[...] = np.arange(64.0)
        r.flush()
        emu.crash()
        spans = emu.inject_media_fault(backends.MediaFault(words=5, seed=3))
        views.append((spans, np.array(r.view)))
    assert views[0][0] == views[1][0]
    assert np.array_equal(views[0][1], views[1][1])


def test_env_selects_the_device_backend(monkeypatch):
    monkeypatch.setenv("REPRO_NVM_BACKEND", "device")
    emu = port_nvm.CrashEmulator(port_nvm.NVMConfig())
    assert isinstance(emu.backend, DeviceBackend)
    assert port_backends.BACKENDS["device"] is DeviceBackend


# ---------------------------------------------------------------------------
# snapshot/restore (the fork protocol)
# ---------------------------------------------------------------------------

def _make_trace(seed, n_ops=120):
    rng = np.random.default_rng(seed)
    cache_lines = int(rng.integers(1, 10))
    line_bytes = int(rng.choice([32, 64]))
    cfg = dict(cache_bytes=cache_lines * line_bytes, line_bytes=line_bytes,
               replacement=("lru", "fifo")[seed % 2])
    specs = []
    for i in range(int(rng.integers(2, 5))):
        n = int(rng.integers(1, 600))
        dtype = [np.float64, np.int32, np.int64][int(rng.integers(0, 3))]
        specs.append((f"r{i}", n, dtype, int(rng.choice([1, 1, 2, 4]))))
    ops = []
    for _ in range(n_ops):
        name, n, dtype, _ = specs[int(rng.integers(0, len(specs)))]
        p = rng.random()
        lo = int(rng.integers(0, n))
        hi = int(rng.integers(lo + 1, n + 1))
        if p < 0.45:
            ops.append(("write", name, lo, hi,
                        rng.integers(0, 1000, size=hi - lo).astype(dtype)))
        elif p < 0.75:
            ops.append(("read", name, lo, hi, None))
        elif p < 0.90:
            ops.append(("flush", name, 0 if p < 0.82 else lo,
                        n if p < 0.82 else hi, None))
        elif p < 0.96:
            ops.append(("crash", None, 0, 0, None))
        else:
            ops.append(("drain", None, 0, 0, None))
    return cfg, specs, ops


def _build(nvm, backend, cfg, specs):
    emu = nvm.CrashEmulator(nvm.NVMConfig(backend=backend, **cfg))
    regions = {name: emu.alloc(name, (n,), dtype, sector_lines=sector)
               for name, n, dtype, sector in specs}
    return emu, regions


def _apply(emu, regions, ops):
    for kind, name, lo, hi, val in ops:
        if kind == "write":
            regions[name][lo:hi] = val
        elif kind == "read":
            regions[name][lo:hi]
        elif kind == "flush":
            regions[name].flush(slice(lo, hi))
        elif kind == "crash":
            emu.crash()
        else:
            emu.drain()


def _state(emu, specs):
    return (dataclasses.astuple(emu.stats),
            tuple(emu.store.image[name].tobytes() for name, *_ in specs),
            tuple(emu.truth_flat(name).tobytes() for name, *_ in specs),
            tuple(emu.backend.dirty_entries(name).tobytes()
                  for name, *_ in specs),
            emu.backend.occupancy_lines,
            emu.crashed)


@pytest.mark.parametrize("seed", range(10))
def test_snapshot_restore_matches_reference(seed, device_hot):
    """The port's device backend, restored and replayed, lands where
    ``repro``'s vectorized backend lands straight through."""
    cfg, specs, ops = _make_trace(seed)
    cut = len(ops) // 2
    ref, ref_regions = _build(ref_nvm, "vectorized", cfg, specs)
    _apply(ref, ref_regions, ops[:cut])
    mid_state = _state(ref, specs)
    _apply(ref, ref_regions, ops[cut:])
    end_state = _state(ref, specs)

    emu, regions = _build(port_nvm, "device", cfg, specs)
    _apply(emu, regions, ops[:cut])
    snap = emu.snapshot()
    assert _state(emu, specs) == mid_state
    _apply(emu, regions, ops[cut:])
    assert _state(emu, specs) == end_state
    emu.restore(snap)
    assert _state(emu, specs) == mid_state
    _apply(emu, regions, ops[cut:])
    assert _state(emu, specs) == end_state
    emu.restore(snap)
    assert _state(emu, specs) == mid_state


def test_snapshot_capture_does_not_perturb_trace(device_hot):
    cfg, specs, ops = _make_trace(3, n_ops=80)
    ref, ref_regions = _build(ref_nvm, "vectorized", cfg, specs)
    _apply(ref, ref_regions, ops)
    snapped, snapped_regions = _build(port_nvm, "device", cfg, specs)
    for i, op in enumerate(ops):
        _apply(snapped, snapped_regions, [op])
        if i % 7 == 0:
            snapped.snapshot()
    assert _state(snapped, specs) == _state(ref, specs)


@pytest.mark.parametrize("ref_kind", ["reference", "vectorized"])
@pytest.mark.parametrize("replacement", ["lru", "fifo"])
def test_streaming_cyclic_pressure(replacement, ref_kind, device_hot):
    """Cyclic full-range writes over a region 2x the cache: every op
    would evict entries of its own range, so the device path must
    decline its speculative pass each time."""
    ref, port = _pair(dict(cache_bytes=4 * 64, line_bytes=64,
                           replacement=replacement), ref_kind)
    n = 8 * 8
    regions = [("x", n, np.float64, ref.alloc("x", (n,)),
                port.alloc("x", (n,)))]
    for sweep in range(6):
        val = np.arange(n, dtype=np.float64) + 100 * sweep
        regions[0][3][...] = val
        regions[0][4][...] = val
        _assert_same(ref, port, regions, f"sweep={sweep}")
    ref.crash()
    port.crash()
    _assert_same(ref, port, regions, "post-crash")
    assert np.array_equal(regions[0][3].view, regions[0][4].view)


@pytest.mark.parametrize("ref_kind", ["reference", "vectorized"])
@pytest.mark.parametrize("replacement", ["lru", "fifo"])
def test_single_entry_larger_than_cache(replacement, ref_kind, device_hot):
    ref, port = _pair(dict(cache_bytes=2 * 64, line_bytes=64,
                           replacement=replacement), ref_kind)
    n = 8 * 16
    regions = [("big", n, np.float64, ref.alloc("big", (n,), sector_lines=4),
                port.alloc("big", (n,), sector_lines=4))]
    val = np.arange(n, dtype=np.float64)
    regions[0][3][...] = val
    regions[0][4][...] = val
    _assert_same(ref, port, regions, "oversized-entry write")
    ref.crash()
    port.crash()
    _assert_same(ref, port, regions, "oversized-entry post-crash")


def test_streaming_prefix_takes_the_device_path():
    """At the default threshold a large span under a cache that holds
    the region: every op through the device math, none declined, and
    the queue-validity scan on the device too."""
    n = 64 * 1024
    trace = [(op, 0, n) for _ in range(3) for op in ("write", "read",
                                                     "flush")]
    emus = []
    for nvm, kind in ((ref_nvm, "vectorized"), (port_nvm, "device")):
        emu = nvm.CrashEmulator(nvm.NVMConfig(backend=kind,
                                              cache_bytes=n * 8))
        emu.alloc("data", (n,))
        emus.append(emu)
    batched.reset_profile()
    for emu in emus:
        for op, lo, hi in trace:
            getattr(emu, op)("data", lo, hi)
        emu.drain()
    ref, port = emus
    assert port.store.image["data"].tobytes() \
        == ref.store.image["data"].tobytes()
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    # write and read of each pass; the flush is the parent's
    assert batched.profile["cache_op_calls"] == 6
    assert batched.profile["cache_op_entries"] == 6 * n // 8


# ---------------------------------------------------------------------------
# the backend under the scenario driver
# ---------------------------------------------------------------------------

def test_sharded_measure_sweep_spawns_and_equals_serial(monkeypatch):
    """``workers=2`` with the device backend: the shards are spawned (a
    forked child of a process that ran torch math hangs in its first
    parallel reduction) and give the serial sweep's cells, which are
    ``repro``'s vectorized cells."""
    import repro_torch.scenarios.pool as pool
    starts = []
    real = pool.run_sharded

    def recording(*args, **kw):
        starts.append(kw.get("start_method"))
        return real(*args, **kw)

    monkeypatch.setattr(pool, "run_sharded", recording)
    torch.ones(1 << 20).sum()       # torch math in the parent
    wl = ("kv", {"profile": "udb", "n_steps": 10, "seed": 11})

    def cells(sc, nvm, backend, **kw):
        plans = (sc.CrashPlan.no_crash(), sc.CrashPlan.at_every_step(
            torn=sc.TornSpec(0.5, seed=4, samples=2)))
        out = sc.sweep([wl], ("adcc", "undo_log"), plans,
                       cfg=nvm.NVMConfig(cache_bytes=64 * 1024,
                                         backend=backend),
                       mode="measure", **kw)
        return [sc.deterministic_cell_dict(c) for c in out]

    serial = cells(port_sc, port_nvm, "device")
    sharded = cells(port_sc, port_nvm, "device", workers=2,
                    shard_timeout=120.0, shard_retries=0)
    assert starts == ["spawn"]
    assert sharded == serial == cells(ref_sc, ref_nvm, "vectorized")


def test_device_backend_without_a_card_raises():
    """No card and no ``use_device("cpu")``: constructing the backend
    raises; it never stands in the vectorized host path for a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch import device as device_mod
    saved, device_mod._selected = device_mod._selected, None
    try:
        with pytest.raises(RuntimeError, match="use_device"):
            port_nvm.CrashEmulator(port_nvm.NVMConfig(backend="device"))
    finally:
        device_mod._selected = saved

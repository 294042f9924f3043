"""Port vs reference, host substrate: the numpy layers of ``repro_torch``
(crash emulator, backends, the three algorithms, the scenario driver)
were carried over from ``repro`` and must behave identically — exact
equality everywhere in this file: NVM image bytes, every ``TrafficStats``
field including the float ``modeled_seconds``, restart points, results.

Also the state carried across: ``carry.snapshot_from_reference`` lets a
run begun in ``repro`` continue in ``repro_torch``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.backends as ref_backends
import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro_torch.core.backends as port_backends
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc
from repro_torch.scenarios.carry import snapshot_from_reference


def _stats_equal(a, b, ctx):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        assert x == y, f"{ctx}: stats.{field.name}: repro={x} port={y}"
    assert {f.name for f in dataclasses.fields(a)} \
        == {f.name for f in dataclasses.fields(b)}


def _emus_equal(ref, port, names, ctx):
    _stats_equal(ref.stats, port.stats, ctx)
    assert ref.backend.occupancy_lines == port.backend.occupancy_lines, ctx
    for name in names:
        assert ref.store.image[name].tobytes() \
            == port.store.image[name].tobytes(), f"{ctx}: image {name!r}"
        assert np.array_equal(ref.truth_flat(name), port.truth_flat(name)), \
            f"{ctx}: truth {name!r}"
        assert np.array_equal(ref.backend.dirty_entries(name),
                              port.backend.dirty_entries(name)), \
            f"{ctx}: dirty set {name!r}"
    assert ref.backend.dirty_eviction_order() \
        == port.backend.dirty_eviction_order(), ctx


def _make_pair(rng, backend, replacement):
    cache_lines = int(rng.integers(1, 10))
    line_bytes = int(rng.choice([32, 64]))
    cfg = dict(cache_bytes=cache_lines * line_bytes, line_bytes=line_bytes,
               replacement=replacement, backend=backend)
    ref = ref_nvm.CrashEmulator(ref_nvm.NVMConfig(**cfg))
    port = port_nvm.CrashEmulator(port_nvm.NVMConfig(**cfg))
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


@pytest.mark.parametrize("replacement", ["lru", "fifo"])
@pytest.mark.parametrize("backend", ["vectorized", "reference"])
@pytest.mark.parametrize("seed", range(4))
def test_randomized_trace_identical(seed, backend, replacement):
    """Writes, reads, flushes, drains, clean crashes, torn line and word
    crashes, and a snapshot that both sides later restore."""
    rng = np.random.default_rng(1000 + seed)
    ref, port, regions = _make_pair(rng, backend, replacement)
    names = [r[0] for r in regions]
    snaps = None
    for step in range(90):
        name, n, dtype, r_ref, r_port = \
            regions[int(rng.integers(0, len(regions)))]
        op = rng.random()
        ctx = f"seed={seed} {backend} {replacement} step={step} {name}"
        lo = int(rng.integers(0, n))
        hi = int(rng.integers(lo + 1, n + 1))
        if op < 0.42:
            val = rng.integers(0, 1000, size=hi - lo).astype(dtype)
            r_ref[lo:hi] = val
            r_port[lo:hi] = val
        elif op < 0.68:
            assert np.array_equal(r_ref[lo:hi], r_port[lo:hi]), ctx
        elif op < 0.80:
            r_ref.flush(slice(lo, hi))
            r_port.flush(slice(lo, hi))
        elif op < 0.85:
            ref.drain()
            port.drain()
        elif op < 0.90:
            assert ref.crash() == port.crash(), ctx
        elif op < 0.96:
            kw = dict(fraction=float(rng.choice([0.0, 0.3, 0.5, 1.0])),
                      seed=int(rng.integers(0, 99)),
                      mode=str(rng.choice(["random", "eviction"])),
                      granularity=str(rng.choice(["line", "word"])))
            assert ref.crash(ref_backends.LineSurvival(**kw)) \
                == port.crash(port_backends.LineSurvival(**kw)), ctx
        elif snaps is None:
            snaps = (ref.snapshot(), port.snapshot())
        else:
            ref.restore(snaps[0])
            port.restore(snaps[1])
        _emus_equal(ref, port, names, ctx)


def test_unknown_backend_names_the_valid_ones():
    with pytest.raises(ValueError, match="reference.*vectorized"):
        port_nvm.CrashEmulator(port_nvm.NVMConfig(backend="device"))
    assert sorted(port_backends.BACKENDS) == ["reference", "vectorized"]


# ---------------------------------------------------------------------------
# the three algorithms, through the scenario driver
# ---------------------------------------------------------------------------

ALGO_SPECS = [
    ("cg", {"n": 128, "iters": 8, "seed": 5}),
    ("mm", {"n": 32, "k": 8, "seed": 2}),
    ("xsbench", {"lookups": 60, "grid_points": 300, "n_nuclides": 6,
                 "n_materials": 4, "max_nuclides_per_material": 3,
                 "flush_every_frac": 0.1, "seed": 7}),
]


def _cells(sc, spec, strategy, plans, **kw):
    cfg = (ref_nvm if sc is ref_sc else port_nvm).NVMConfig(
        cache_bytes=16 * 1024)
    return [sc.deterministic_cell_dict(r)
            for r in sc.sweep([spec], [strategy], plans(sc), cfg=cfg, **kw)]


def _algo_plans(sc):
    return [sc.CrashPlan.no_crash(),
            sc.CrashPlan.at_fraction(0.5),
            sc.CrashPlan.at_fraction(0.7, torn=True),
            sc.CrashPlan.at_every_step(
                torn=sc.TornSpec(fraction=0.5, seed=23, mode="random",
                                 samples=1))]


@pytest.mark.parametrize("strategy", ["adcc", "undo_log",
                                      "checkpoint_nvm@2"])
@pytest.mark.parametrize("spec", ALGO_SPECS, ids=[s[0] for s in ALGO_SPECS])
def test_algorithms_identical_full_runs(spec, strategy):
    """Full fork-engine cells (recover, replay the tail, finalize):
    restart points, lost/recomputed steps, correctness, result metrics
    and traffic are the same dictionaries."""
    ref = _cells(ref_sc, spec, strategy, _algo_plans, engine="fork",
                 mode="full")
    port = _cells(port_sc, spec, strategy, _algo_plans, engine="fork",
                  mode="full")
    assert len(ref) == len(port) > 3
    for a, b in zip(ref, port):
        assert a == b


@pytest.mark.parametrize("spec", ALGO_SPECS[:2], ids=["cg", "mm"])
def test_rerun_engine_identical(spec):
    plans = lambda sc: [sc.CrashPlan.no_crash(),            # noqa: E731
                        sc.CrashPlan.at_fraction(0.5, torn=True)]
    assert _cells(ref_sc, spec, "adcc", plans, engine="rerun") \
        == _cells(port_sc, spec, "adcc", plans, engine="rerun")


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def _flatten(snap) -> dict:
    """A reference workload snapshot as plain numpy arrays and scalars —
    the form ``carry.snapshot_from_reference`` documents."""
    emu = snap["emu"]
    flat = {"crashed": emu.crashed,
            "truth_desynced": sorted(emu.truth_desynced)}
    for name, arr in emu.truth.items():
        flat[f"truth/{name}"] = np.asarray(arr)
    for name, arr in emu.image.items():
        flat[f"image/{name}"] = np.asarray(arr)
    for field in dataclasses.fields(emu.stats):
        flat[f"stats/{field.name}"] = getattr(emu.stats, field.name)
    for k, v in snap["scalars"].items():
        flat[f"scalars/{k}"] = v
    be = emu.backend
    if isinstance(be, dict):
        flat["backend/kind"] = "vectorized"
        for name, (present, dirty, stamp) in be["regions"].items():
            flat[f"backend/regions/{name}/present"] = present
            flat[f"backend/regions/{name}/dirty"] = dirty
            flat[f"backend/regions/{name}/stamp"] = stamp
        flat["backend/clock"] = be["clock"]
        flat["backend/weight_used"] = be["weight_used"]
        for part, arr in zip(("rid", "entry", "stamp"), be["queue"]):
            flat[f"backend/queue/{part}"] = arr
    else:
        lru, weight = be
        flat["backend/kind"] = "reference"
        flat["backend/lru/name"] = [k[0] for k in lru]
        flat["backend/lru/entry"] = np.array([k[1] for k in lru],
                                             dtype=np.int64)
        flat["backend/lru/dirty"] = np.array(list(lru.values()), dtype=bool)
        flat["backend/weight_used"] = weight
    return flat


def _rec_dict(rec) -> dict:
    # asdict recurses: the RecoveryOutcome that CG's recovery leaves in
    # ``info`` is an instance of each package's own class
    return dataclasses.asdict(rec)


@pytest.mark.parametrize("backend", ["vectorized", "reference"])
@pytest.mark.parametrize("spec", ALGO_SPECS, ids=[s[0] for s in ALGO_SPECS])
def test_carried_snapshot_continues_in_the_port(spec, backend):
    """Golden prefix in ``repro``; the state is carried over; both sides
    take the same torn crash, recover with ADCC and run on. Images,
    stats and RecoveryResults must be equal at every stage."""
    kw = dict(cache_bytes=16 * 1024, backend=backend)
    ref_wl = ref_sc.make_workload(spec)
    ref_wl.setup(ref_nvm.NVMConfig(**kw), "adcc")
    port_wl = port_sc.make_workload(spec)
    port_wl.setup(port_nvm.NVMConfig(**kw), "adcc")
    ref_strat = ref_sc.make_strategy("adcc")
    port_strat = port_sc.make_strategy("adcc")
    ref_strat.attach(ref_wl)
    port_strat.attach(port_wl)

    crash_step = ref_wl.n_steps // 2
    for i in range(crash_step + 1):     # the port's workload stays at step 0
        ref_strat.before_step(i)
        ref_wl.step(i)
        if i < crash_step:
            ref_strat.after_step(i)     # torn: crash before the last hook
    port_wl.restore_snapshot(snapshot_from_reference(
        _flatten(ref_wl.snapshot())))
    names = sorted(ref_wl.emu.store.image)
    assert names == sorted(port_wl.emu.store.image)
    _emus_equal(ref_wl.emu, port_wl.emu, names, "after carry")
    assert ref_wl.scalar_state() == port_wl.scalar_state()

    sv = dict(fraction=0.5, seed=23, mode="random")
    ref_sv = ref_backends.LineSurvival(**sv)
    port_sv = port_backends.LineSurvival(**sv)
    assert ref_wl.emu.crash(ref_sv) == port_wl.emu.crash(port_sv)
    _emus_equal(ref_wl.emu, port_wl.emu, names, "after torn crash")

    ref_rec = ref_strat.recover(crash_step, True, ref_sv)
    port_rec = port_strat.recover(crash_step, True, port_sv)
    assert _rec_dict(ref_rec) == _rec_dict(port_rec)
    _emus_equal(ref_wl.emu, port_wl.emu, names, "after recovery")

    for i in range(ref_rec.resume_step, ref_wl.n_steps):
        for wl, strat in ((ref_wl, ref_strat), (port_wl, port_strat)):
            strat.before_step(i)
            wl.step(i)
            strat.after_step(i)
    _emus_equal(ref_wl.emu, port_wl.emu, names, "after the tail")
    ref_fin, port_fin = ref_wl.finalize(), port_wl.finalize()
    assert ref_fin.correct == port_fin.correct
    assert ref_fin.metrics == port_fin.metrics
    assert sorted(ref_fin.info) == sorted(port_fin.info)
    for key, want in ref_fin.info.items():
        np.testing.assert_array_equal(port_fin.info[key], want)

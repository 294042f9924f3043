"""Port vs reference, snapshot tiering (``scenarios.sweep_engine.
SnapshotTier`` and ``sweep(snapshot_budget_bytes=..., snapshot_policy=
...)``) and crash-point sharding, the twin of
``tests/test_snapshot_tiering.py``.

Under a byte budget the fork engine's snapshot ladder spills its least
recently used payload to disk and reloads it (``"spill"``) or drops it
and replays the golden prefix from the nearest retained boundary
(``"recompute"``). Neither may change a cell: the port's cells under a
budget must equal the reference's (``deterministic_cell_dict``, exact),
in the ``full``, ``measure`` and ``batched`` modes (``batched`` against
the reference's ``measure``, its identity contract), and the tier must
take the same decisions in both packages: the same count of hits,
spills, reloads and recomputes. The unit cases drive both packages'
``SnapshotTier`` alike on snapshots of a live cg + adcc pair.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro.scenarios.sweep_engine as ref_se
import repro_torch
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc
import repro_torch.scenarios.sweep_engine as port_se

WL = ("cg", {"n": 256, "iters": 6, "seed": 3})
STRATEGIES = ("adcc", "undo_log", "checkpoint_nvm")
PACKAGES = {"repro": (ref_sc, ref_nvm, ref_se),
            "port": (port_sc, port_nvm, port_se)}
DECISIONS = ("hits", "spills", "reloads", "recomputes")


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _sweep(pkg, mode="measure", strategies=("adcc",), **kw):
    sc, nvm, _ = PACKAGES[pkg]
    plans = (sc.CrashPlan.no_crash(), sc.CrashPlan.at_every_step())
    return sc.sweep(workloads=(WL,), strategies=strategies, plans=plans,
                    cfg=nvm.NVMConfig(cache_bytes=256 * 1024), mode=mode,
                    **kw)


def _cells(pkg, results, certified=True):
    sc = PACKAGES[pkg][0]
    out = []
    for r in results:
        d = sc.deterministic_cell_dict(r)
        if not certified:
            d.pop("state_certified", None)
        out.append(d)
    return out


def _decisions(results):
    return [{k: r.info["snapshot_tier"][k] for k in DECISIONS}
            for r in results]


_reference = {}


def _ref_cells(mode, strategies, **kw):
    key = (mode, strategies, tuple(sorted(kw.items())))
    if key not in _reference:
        _reference[key] = _sweep("repro", mode, strategies, **kw)
    return _reference[key]


@pytest.mark.parametrize("policy", ["spill", "recompute"])
@pytest.mark.parametrize("mode", ["full", "measure"])
def test_budgeted_cells_equal_reference(mode, policy):
    budget = dict(snapshot_budget_bytes=1, snapshot_policy=policy)
    want = _ref_cells(mode, STRATEGIES, **budget)
    got = _sweep("port", mode, STRATEGIES, **budget)
    assert _cells("port", got) == _cells("repro", want)
    assert _cells("repro", want) == _cells(
        "repro", _ref_cells(mode, STRATEGIES))
    assert _decisions(got) == _decisions(want)
    key = "spills" if policy == "spill" else "recomputes"
    assert all(d[key] > 0 for d in _decisions(got))


@pytest.mark.parametrize("policy", ["spill", "recompute"])
def test_budgeted_batched_equals_reference_measure(policy):
    got = _sweep("port", "batched", STRATEGIES, snapshot_budget_bytes=1,
                 snapshot_policy=policy)
    want = _ref_cells("measure", STRATEGIES)
    assert _cells("port", got, False) == _cells("repro", want, False)
    key = "spills" if policy == "spill" else "recomputes"
    assert all(r.info["snapshot_tier"][key] > 0 for r in got)


def test_zero_budget_recomputes_from_the_pin():
    budget = dict(snapshot_budget_bytes=0, snapshot_policy="recompute")
    got = _sweep("port", **budget)
    want = _ref_cells("measure", ("adcc",), **budget)
    assert _cells("port", got) == _cells("repro", want)
    assert _decisions(got) == _decisions(want)
    assert got[0].info["snapshot_tier"]["recomputes"] > 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_env_knobs_resolve(monkeypatch, pkg):
    monkeypatch.setenv("REPRO_SNAPSHOT_BUDGET", "1")
    monkeypatch.setenv("REPRO_SNAPSHOT_POLICY", "recompute")
    tier = _sweep(pkg)[0].info["snapshot_tier"]
    assert tier["policy"] == "recompute" and tier["recomputes"] > 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_invalid_policy_rejected(pkg):
    _, _, se = PACKAGES[pkg]
    with pytest.raises(ValueError, match="snapshot policy"):
        _sweep(pkg, snapshot_budget_bytes=1, snapshot_policy="teleport")
    with pytest.raises(ValueError):
        se.SnapshotTier(budget_bytes=100, policy="teleport")
    assert set(se.SNAPSHOT_POLICIES) == {"spill", "recompute"}


# ---------------------------------------------------------------------------
# the tier alone, on snapshots of a live pair
# ---------------------------------------------------------------------------

def _snapshot_after(pkg, steps=2):
    sc, nvm, se = PACKAGES[pkg]
    wl = sc.make_workload(("cg", {"n": 128, "iters": 4, "seed": 1}))
    strat = sc.make_strategy("adcc")
    wl.setup(nvm.NVMConfig(cache_bytes=64 * 1024, backend="vectorized"),
             "adcc")
    strat.attach(wl)
    for i in range(steps):
        strat.before_step(i)
        wl.step(i)
        strat.after_step(i)
    return se._CellSnapshot(wl, strat, wall_last=0.1, modeled_last=0.2), \
        wl, strat


def _arrays(obj, out):
    """Every ndarray of a payload, in walk order."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _arrays(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _arrays(v, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _arrays(getattr(obj, f.name), out)
    elif hasattr(obj, "__dict__"):
        _arrays(vars(obj), out)
    return out


def test_spill_reload_gives_the_reference_payload():
    """A spilled and reloaded snapshot of the port holds, array for array,
    the bytes of the reference's snapshot of the same pair, frozen."""
    got = {}
    for pkg in PACKAGES:
        snap, _, _ = _snapshot_after(pkg)
        tier = PACKAGES[pkg][2].SnapshotTier(budget_bytes=1, policy="spill")
        try:
            tier.put((1, False), snap)
            back = tier.get((1, False))
            got[pkg] = (_arrays((back.wl_snap, back.strat_snap), []),
                        {k: getattr(tier.stats, k) for k in DECISIONS},
                        (back.wall_last, back.modeled_last))
        finally:
            tier.close()
    port, ref = got["port"], got["repro"]
    assert port[1:] == ref[1:] and port[1]["spills"] == 1
    assert [(a.dtype, a.shape, a.tobytes()) for a in port[0]] == \
        [(a.dtype, a.shape, a.tobytes()) for a in ref[0]]
    assert port[0] and not any(a.flags.writeable for a in port[0])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_pins_and_nearest_boundary(pkg):
    se = PACKAGES[pkg][2]
    snap, wl, strat = _snapshot_after(pkg)
    tier = se.SnapshotTier(budget_bytes=0, policy="recompute")
    try:
        tier.put((-1, False), snap, pin=True)
        tier.put((2, False), se._CellSnapshot(wl, strat, 0.0, 0.0))
        assert tier.nearest_boundary(4) == (-1, False)
        assert tier.get((-1, False)).wl_snap is snap.wl_snap
        assert (tier.stats.hits, tier.stats.recomputes) == (1, 0)
    finally:
        tier.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_close_removes_spill_dir(pkg):
    snap, _, _ = _snapshot_after(pkg)
    tier = PACKAGES[pkg][2].SnapshotTier(budget_bytes=1, policy="spill")
    tier.put((1, False), snap)
    spill_dir = tier._dir
    assert spill_dir is not None and os.path.isdir(spill_dir)
    tier.close()
    assert not os.path.exists(spill_dir)


def test_snapshot_pickles_alike():
    """The pair's payload survives a pickle round trip in both packages
    with the same arrays (what a spill writes)."""
    out = {}
    for pkg in PACKAGES:
        snap, _, _ = _snapshot_after(pkg)
        back = pickle.loads(pickle.dumps((snap.wl_snap, snap.strat_snap)))
        out[pkg] = [a.tobytes() for a in _arrays(back, [])]
    assert out["port"] == out["repro"]


# ---------------------------------------------------------------------------
# crash-point sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "measure"])
def test_point_sharded_equals_reference_serial(mode):
    got = _sweep("port", mode, workers=3)
    assert _cells("port", got) == _cells(
        "repro", _ref_cells(mode, ("adcc",)))


def test_point_sharding_composes_with_tiering():
    got = _sweep("port", workers=3, snapshot_budget_bytes=1,
                 snapshot_policy="spill")
    assert _cells("port", got) == _cells(
        "repro", _ref_cells("measure", ("adcc",)))


def test_chaos_on_point_shard_heals_via_journal(tmp_path):
    journal = str(tmp_path / "sweep.jsonl")
    got = _sweep("port", workers=3, journal=journal,
                 chaos={0: "kill", 2: "hang"}, shard_timeout=3.0)
    assert _cells("port", got) == _cells(
        "repro", _ref_cells("measure", ("adcc",)))
    assert not os.path.exists(journal)

"""Port vs reference, repeated crashes: crash, recover, run on, crash
again, recover, finish — the twin of ``tests/test_repeated_crashes.py``.

Each case drives one workload and strategy through both packages the
way the scenario sweep does, with the same crash steps, on the
``vectorized`` and the ``reference`` emulation backends. The port's run
must end correct, and equal the reference's run: the final report
(``correct`` and every metric) and each recovery's result (resume step,
restart point, modeled detection cost, redone and lost steps), exactly.
The undo log's double power failure before its rollback is held the
same way.
"""

import dataclasses

import pytest

import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro_torch
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc

# the reference test's workloads
CG = ("cg", {"n": 1024, "iters": 8, "seed": 3})
MM = ("mm", {"n": 64, "k": 16, "seed": 1})
XS = ("xsbench", {"lookups": 600, "grid_points": 800, "n_nuclides": 8,
                  "n_materials": 6, "max_nuclides_per_material": 4,
                  "flush_every_frac": 0.02, "seed": 7})
KV = ("kv", {"profile": "etc", "n_steps": 24, "seed": 11})
PACKAGES = {"repro": (ref_sc, ref_nvm), "port": (port_sc, port_nvm)}
ALL_STRATEGIES = sorted(ref_sc.STRATEGIES)
FOUR = ["adcc", "undo_log", "checkpoint_nvm", "shadow_snapshot"]


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


@pytest.fixture(params=["vectorized", "reference"])
def backend(request):
    return request.param


def _setup(pkg, wl_spec, strategy, backend):
    sc, nvm = PACKAGES[pkg]
    wl = sc.make_workload(wl_spec)
    strat = sc.make_strategy(strategy)
    wl.setup(nvm.NVMConfig(cache_bytes=512 * 1024, backend=backend),
             "adcc" if strat.wants_adcc else "plain")
    strat.attach(wl)
    return wl, strat


def _outcome(report, recs):
    return {"correct": report.correct, "metrics": report.metrics,
            "recoveries": [{k: v for k, v in dataclasses.asdict(r).items()
                            if k != "info"} for r in recs]}


def run_with_crashes(pkg, wl_spec, strategy, crash_steps, backend,
                     torn_last=False):
    """The reference test's loop, in package ``pkg``: a boundary
    crash at each step of ``crash_steps`` (the last one torn mid-step
    where ``torn_last``), recovered in place, and the run finished."""
    wl, strat = _setup(pkg, wl_spec, strategy, backend)
    pending = sorted(crash_steps)
    recs = []
    i = 0
    while i < wl.n_steps:
        strat.before_step(i)
        wl.step(i)
        torn = torn_last and pending == [i]
        if not torn:
            strat.after_step(i)
        if pending and pending[0] == i:
            pending.pop(0)
            wl.emu.crash()
            rec = strat.recover(i, torn)
            recs.append(rec)
            i = rec.resume_step
        else:
            i += 1
    return _outcome(wl.finalize(), recs)


def _twin(wl_spec, strategy, crash_steps, backend, torn_last=False):
    got = run_with_crashes("port", wl_spec, strategy, crash_steps, backend,
                           torn_last)
    want = run_with_crashes("repro", wl_spec, strategy, crash_steps,
                            backend, torn_last)
    assert got["correct"], (strategy, got["metrics"])
    assert got == want
    return got


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_cg_two_crashes(backend, strategy):
    recs = _twin(CG, strategy, [3, 6], backend)["recoveries"]
    assert len(recs) == 2
    if recs[1]["restart_point"] >= 0:
        assert recs[1]["restart_point"] >= recs[0]["restart_point"]


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_cg_immediate_recrash(backend, strategy):
    assert len(_twin(CG, strategy, [4, 5], backend)["recoveries"]) == 2


@pytest.mark.parametrize("strategy", FOUR)
def test_mm_two_crashes(backend, strategy):
    _twin(MM, strategy, [2, 7], backend)


@pytest.mark.parametrize("strategy", FOUR)
def test_xs_two_crashes(backend, strategy):
    _twin(XS, strategy, [3, 9], backend)


@pytest.mark.parametrize("strategy", ["adcc", "shadow_snapshot"])
def test_kv_two_crashes(backend, strategy):
    _twin(KV, strategy, [5, 12], backend)


@pytest.mark.parametrize("strategy", FOUR)
def test_cg_boundary_then_torn_crash(backend, strategy):
    assert len(_twin(CG, strategy, [2, 6], backend,
                     torn_last=True)["recoveries"]) == 2


def test_undo_log_crash_again_before_rollback(backend):
    """Two power failures and one recovery: the undo log rolls the torn
    transaction back from the twice-crashed image, in both packages."""
    out = {}
    for pkg in PACKAGES:
        wl, strat = _setup(pkg, CG, "undo_log", backend)
        for i in range(5):
            strat.before_step(i)
            wl.step(i)
            if i < 4:
                strat.after_step(i)
        wl.emu.crash()
        wl.emu.crash()
        rec = strat.recover(4, True)
        for j in range(rec.resume_step, wl.n_steps):
            strat.before_step(j)
            wl.step(j)
            strat.after_step(j)
        out[pkg] = _outcome(wl.finalize(), [rec])
    assert out["port"]["correct"], out["port"]["metrics"]
    assert out["port"] == out["repro"]

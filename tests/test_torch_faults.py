"""Port vs reference, the fault campaigns: cells with a ``FaultSpec`` —
media poison injected into the crash image before recovery, and nested
crashes during recovery — must equal ``repro``'s cells on every field of
``deterministic_cell_dict``, for the four workload families (twins of
tests/test_fault_injection.py's pinned cases).
"""

import pytest

import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro_torch
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc

SMALL = 512 * 1024

CG = ("cg", {"n": 1024, "iters": 8, "seed": 3})
MM = ("mm", {"n": 64, "k": 16, "seed": 1})
XS = ("xsbench", {"lookups": 600, "grid_points": 800, "n_nuclides": 8,
                  "n_materials": 6, "max_nuclides_per_material": 4,
                  "flush_every_frac": 0.02, "seed": 7})
KV = ("kv", {"profile": "etc", "n_steps": 24, "seed": 11})


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _cell(sc, nvm, wl, strategy, plan_fn):
    res = sc.run_scenario(wl, strategy, plan_fn(sc),
                          cfg=nvm.NVMConfig(cache_bytes=SMALL))
    return res, sc.deterministic_cell_dict(res)


def _both(wl, strategy, plan_fn):
    ref, want = _cell(ref_sc, ref_nvm, wl, strategy, plan_fn)
    port, got = _cell(port_sc, port_nvm, wl, strategy, plan_fn)
    assert repr(got) == repr(want)
    return port


@pytest.mark.parametrize("wl,words,regions", [
    (CG, 2, None),
    (MM, 2, ("C", "C_s*")),
    (XS, 2, ("type_counter_*",)),
    (KV, 8, ("kv.index",)),
], ids=["cg", "mm", "xs", "kv"])
def test_adcc_poison_cells_equal_reference(wl, words, regions):
    res = _both(wl, "adcc", lambda sc: sc.CrashPlan.at_fraction(
        0.5, fault=sc.FaultSpec(poison_words=words, seed=40,
                                poison_regions=regions)))
    assert res.correctness_class == "fault_detected"
    assert res.info["fault_words_injected"] == words


@pytest.mark.parametrize("wl,strategy,torn", [
    (CG, "adcc", True),
    (MM, "adcc", False),
    (KV, "shadow_snapshot@2", False),
    (("kv", {"profile": "etc", "n_steps": 24, "seed": 11,
             "policy": "blind"}), "adcc", False),
], ids=["cg-adcc-torn", "mm-adcc", "kv-shadow", "kv-blind"])
def test_nested_crash_cells_equal_reference(wl, strategy, torn):
    _both(wl, strategy, lambda sc: sc.CrashPlan.at_fraction(
        0.6 if torn else 0.5, torn=torn,
        fault=sc.FaultSpec(nested_after=1, seed=7)))


@pytest.mark.parametrize("mode", ["measure", "batched"])
def test_kv_fault_sweep_equals_reference(mode):
    """A KV matrix with poison and nested-crash plans through the
    port's sweep, against ``repro``'s measure sweep."""
    def plans(sc):
        return (sc.CrashPlan.at_fraction(0.6, torn=True,
                                         fault=sc.FaultSpec(nested_after=1,
                                                            seed=7)),
                sc.CrashPlan.at_fraction(0.5, fault=sc.FaultSpec(
                    poison_words=8, seed=40, poison_regions=("kv.index",))))

    def cells(sc, nvm, m):
        out = sc.sweep([KV], ("adcc", "undo_log", "shadow_snapshot"),
                       plans(sc), cfg=nvm.NVMConfig(cache_bytes=SMALL),
                       mode=m)
        return [repr(sc.deterministic_cell_dict(c)) for c in out]

    assert cells(port_sc, port_nvm, mode) \
        == cells(ref_sc, ref_nvm, "measure")

"""Port vs reference, the KV serving family: ``repro_torch.scenarios.kv``
(carried over from ``repro``), its integer device math in
``repro_torch.core.backends.batched`` and the KV evaluators of the
batched engine.

The integer math is exact on every device, so equality is bit for bit
throughout: the port's torch int64 SplitMix64 against ``repro``'s numpy
oracles (``_np_splitmix``, the scalar ``kv._mix_words`` /
``kv._value_words``, and ``repro``'s own ``kv_row_checksums`` etc.,
which take their numpy branch where jax's x64 switch is missing), and
the port's batched sweep cells against ``repro``'s measure cells on
every field of ``deterministic_cell_dict`` except ``state_certified``
(fork/measure-only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.backends.batched as ref_batched
import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro.scenarios.kv as ref_kv
import repro_torch
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc
import repro_torch.scenarios.kv as port_kv
from repro_torch.core.backends import batched
from repro_torch.scenarios import batched_engine

I64 = np.iinfo(np.int64)
# words at the edges of the 64-bit range: the top bit set, all bits set,
# the largest positive, and keys whose high bits overflow ``<< 21``
EXTREMES = np.array([-1, I64.max, I64.min, 1 << 62, -(1 << 43), (1 << 43) - 1,
                     0x5555555555555555, -0x5555555555555556, 0, 1],
                    dtype=np.int64)


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _words(rng, shape):
    """Seeded int64 words over the full 64-bit range, with the extreme
    words planted in the first rows."""
    w = rng.integers(I64.min, I64.max, size=shape, dtype=np.int64,
                     endpoint=True)
    flat = w.reshape(-1)
    flat[:min(len(flat), len(EXTREMES))] = EXTREMES[:len(flat)]
    return w


# ---------------------------------------------------------------------------
# integer device math, bit for bit
# ---------------------------------------------------------------------------

def test_splitmix_matches_reference_oracle():
    rng = np.random.default_rng(1)
    z = np.concatenate([EXTREMES, _words(rng, 4096)]).astype(np.int64)
    want = ref_batched._np_splitmix(z.view(np.uint64))
    np.testing.assert_array_equal(batched._np_splitmix(z.view(np.uint64)),
                                  want)
    got = batched._t_splitmix(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)
    # the scalar host code of both packages
    for x in EXTREMES.tolist():
        want = ref_batched._np_splitmix(np.array([x]).astype(np.uint64))
        assert port_kv._splitmix(x) == ref_kv._splitmix(x) == int(want[0])


@pytest.mark.parametrize("width", [7, 15])
def test_kv_row_checksums_match_reference(width):
    rng = np.random.default_rng(6 + width)
    rows = _words(rng, (301, width))
    got = batched.kv_row_checksums(rows)
    assert got.dtype == np.int64 and got.shape == (301,)
    np.testing.assert_array_equal(got, ref_batched.kv_row_checksums(rows))
    np.testing.assert_array_equal(
        got, np.array([ref_kv._mix_words(r) for r in rows], dtype=np.int64))
    # uint64 words with the same bits give the same checksums
    np.testing.assert_array_equal(
        batched.kv_row_checksums(rows.view(np.uint64)), got)
    assert (got >= 0).all()
    assert batched.kv_row_checksums(np.empty((0, width), np.int64)).shape \
        == (0,)


def test_kv_row_checksums_chunked_launches(monkeypatch):
    """Stacks beyond the per-launch budget are cut into launch groups
    without changing a bit."""
    rng = np.random.default_rng(3)
    rows = _words(rng, (100, 7))
    want = ref_batched.kv_row_checksums(rows)
    monkeypatch.setattr(batched, "CHUNK_ELEMS", 7 * 16)
    batched.reset_profile()
    np.testing.assert_array_equal(batched.kv_row_checksums(rows), want)
    assert batched.profile["launch_groups"] == 7
    assert batched.profile["kv_checksum_calls"] == 1
    assert batched.profile["kv_checksum_rows"] == 100


@pytest.mark.parametrize("chunk", [None, 8 * 5])
def test_kv_value_match_matches_reference(chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(batched, "CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(7)
    N, W = 64, 8
    keys = _words(rng, N)
    seqs = rng.integers(I64.min, I64.max, size=N, dtype=np.int64)
    nws = rng.integers(0, W + 1, size=N).astype(np.int64)
    got = rng.integers(I64.min, I64.max, size=(N, W), dtype=np.int64)
    for i in range(N):
        got[i, :nws[i]] = ref_kv._value_words(int(keys[i]), int(seqs[i]),
                                              int(nws[i]))
    want = np.ones(N, bool)
    for i in range(0, N, 2):                # one corrupted live word
        if nws[i]:
            got[i, int(rng.integers(0, nws[i]))] ^= 1 << int(
                rng.integers(0, 63))
            want[i] = False
    ok = batched.kv_value_match(keys, seqs, got, nws)
    np.testing.assert_array_equal(ok, want)
    np.testing.assert_array_equal(
        ok, ref_batched.kv_value_match(keys, seqs, got, nws))
    # the same words as uint64
    np.testing.assert_array_equal(
        batched.kv_value_match(keys.view(np.uint64), seqs.view(np.uint64),
                               got.view(np.uint64), nws), want)
    assert batched.kv_value_match(np.empty(0, np.int64), np.empty(0, np.int64),
                                  np.empty((0, 4), np.int64),
                                  np.empty(0, np.int64)).shape == (0,)


@pytest.mark.parametrize("fifo", [False, True])
@pytest.mark.parametrize("is_write", [False, True])
def test_cache_op_update_matches_reference(fifo, is_write):
    rng = np.random.default_rng(8)
    m = 2311
    present = rng.random(m) < 0.6
    dirty = present & (rng.random(m) < 0.5)
    stamp = rng.integers(1, 1 << 40, size=m).astype(np.int64)
    t0 = (1 << 41) + 17
    args = (present.copy(), dirty.copy(), stamp.copy(), t0, is_write, fifo)
    got = batched.cache_op_update(*args)
    want = ref_batched.cache_op_update(*args)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] == int((~present).sum())
    assert type(got[4]) is int
    # the inputs are left as they were
    np.testing.assert_array_equal(args[0], present)
    np.testing.assert_array_equal(args[2], stamp)


def test_queue_validity_matches_reference():
    rng = np.random.default_rng(9)
    n = 4000
    present = rng.random(n) < 0.7
    stamp = rng.integers(1, 30, size=n).astype(np.int64)
    ents = rng.integers(0, n, size=2500).astype(np.int64)
    stamps = np.where(rng.random(2500) < 0.5, stamp[ents],
                      stamp[ents] - 1).astype(np.int64)
    got = batched.queue_validity(present, stamp, ents, stamps, 3)
    want = ref_batched.queue_validity(present, stamp, ents, stamps, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the store (twins of tests/test_kv_scenarios.py::TestKVStore)
# ---------------------------------------------------------------------------

def _run_pair(sc, wl, upto):
    strat = sc.make_strategy("none")
    for i in range(upto):
        strat.before_step(i)
        wl.step(i)
        strat.after_step(i)


@pytest.mark.parametrize("profile", ["etc", "udb"])
def test_request_stream_identical(profile):
    ref = ref_sc.KVWorkload(profile=profile, n_steps=200, n_keys=32)
    port = port_sc.KVWorkload(profile=profile, n_steps=200, n_keys=32)
    assert [port._request(i) for i in range(200)] \
        == [ref._request(i) for i in range(200)]
    assert {k: dataclasses.asdict(v)
            for k, v in port_sc.KV_PROFILES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_sc.KV_PROFILES.items()}
    assert port._oracle()[0] == ref._oracle()[0]


@pytest.mark.parametrize("profile,policy", [("etc", "validate"),
                                            ("udb", "validate"),
                                            ("udb", "blind")])
def test_no_crash_images_identical(profile, policy):
    """Same requests, same NVM bytes in every region, same traffic and
    the same finalize report; a corrupted live value is caught by both."""
    n = 40
    ref = ref_sc.KVWorkload(profile=profile, n_steps=n, policy=policy,
                            extent_words=64)
    port = port_sc.KVWorkload(profile=profile, n_steps=n, policy=policy,
                              extent_words=64)
    ref.setup(ref_nvm.NVMConfig(cache_bytes=8 * 1024), "plain")
    port.setup(port_nvm.NVMConfig(cache_bytes=8 * 1024), "plain")
    _run_pair(ref_sc, ref, n)
    _run_pair(port_sc, port, n)
    assert sorted(port.emu.store.image) == sorted(ref.emu.store.image)
    for name, img in ref.emu.store.image.items():
        assert port.emu.store.image[name].tobytes() == img.tobytes(), name
    assert vars(port.emu.stats) == vars(ref.emu.stats)
    rep_r, rep_p = ref.finalize(), port.finalize()
    assert rep_p.correct and rep_r.correct
    assert rep_p.metrics == rep_r.metrics
    assert port._semantic_map() == ref._semantic_map()
    key, ent = sorted(port._semantic_map().items())[0]
    e, off = divmod(ent["goff"], port.extent_words)
    port._rvlog[e][off] = int(port._rvlog[e].view[off]) ^ 1
    assert not port.finalize().correct


def test_constructor_validation():
    with pytest.raises(KeyError, match="unknown KV profile"):
        port_sc.KVWorkload(profile="nope")
    with pytest.raises(ValueError, match="policy"):
        port_sc.KVWorkload(policy="hope")
    with pytest.raises(ValueError, match="n_slots"):
        port_sc.KVWorkload(n_keys=8, n_slots=4)
    assert "kv" in port_sc.WORKLOADS


# ---------------------------------------------------------------------------
# sweeps (twins of TestKVEngines and TestKVBatchedEqualsMeasure)
# ---------------------------------------------------------------------------

SMALL = 64 * 1024


def _plans(sc):
    """tests/test_batched_sweep.py::TestKVBatchedEqualsMeasure.PLANS"""
    return (
        sc.CrashPlan.no_crash(),
        sc.CrashPlan.at_every_step(torn=sc.TornSpec(0.5, seed=4, samples=2)),
        sc.CrashPlan.at_every_step(
            torn=sc.TornSpec(0.5, seed=6, granularity="word")),
        sc.CrashPlan.at_fraction(0.6, torn=sc.TornSpec(0.25, seed=3,
                                                       mode="eviction")),
    )


KV_STRATS = ("none", "adcc", "shadow_snapshot", "undo_log", "checkpoint_nvm@2")


def _cells(sc, results):
    out = []
    for r in results:
        d = sc.deterministic_cell_dict(r)
        d.pop("state_certified", None)
        out.append(d)
    return out


def _kv_sweep(sc, nvm, params, mode, strategies=KV_STRATS):
    return sc.sweep([("kv", params)], strategies, _plans(sc),
                    cfg=nvm.NVMConfig(cache_bytes=SMALL), engine="fork",
                    mode=mode)


@pytest.mark.parametrize("params", [
    {"profile": "etc", "n_steps": 10, "seed": 11},
    {"profile": "udb", "n_steps": 10, "seed": 11},
    {"profile": "udb", "n_steps": 10, "seed": 11, "policy": "blind"}],
    ids=["etc", "udb", "udb-blind"])
def test_kv_batched_equals_reference_measure(params):
    """Port batched == repro measure == port measure, every cell taking
    the analytic route; the device math ran, and re-confirmation on the
    host overturned none of its verdicts."""
    want = _cells(ref_sc, _kv_sweep(ref_sc, ref_nvm, params, "measure"))
    batched.reset_profile()
    batched_engine.reset_stats()
    results = _kv_sweep(port_sc, port_nvm, params, "batched")
    assert _cells(port_sc, results) == want
    assert len(want) > 100
    assert not any("batched_fallback" in r.info for r in results)
    assert batched.profile["kv_checksum_calls"] > 0
    assert batched.profile["kv_checksum_rows"] > 0
    assert batched_engine.stats["kv_overturned"] == 0
    assert _cells(port_sc, _kv_sweep(port_sc, port_nvm, params,
                                     "measure")) == want


def test_kv_device_verdicts_equal_reference_on_torn_rows(monkeypatch):
    """Every stacked call of the batched KV evaluator gives ``repro``'s
    answer on the same rows, and the torn cells of the matrix hand it
    rows that fail, so the host re-confirms device-flagged rows — and
    finds every one of them bad too."""
    seen = {"rows": 0, "values": 0, "rechecks": 0}
    real_ck, real_vm = batched.kv_row_checksums, batched.kv_value_match
    real_host = batched_engine._KVAdccEvaluator._host_row_ok

    def checksums(words):
        out = real_ck(words)
        np.testing.assert_array_equal(out,
                                      ref_batched.kv_row_checksums(words))
        seen["rows"] += len(out)
        return out

    def value_match(*args):
        out = real_vm(*args)
        np.testing.assert_array_equal(out, ref_batched.kv_value_match(*args))
        seen["values"] += len(out)
        return out

    def host_row_ok(self, row, vlogs):
        seen["rechecks"] += 1
        return real_host(self, row, vlogs)

    monkeypatch.setattr(batched, "kv_row_checksums", checksums)
    monkeypatch.setattr(batched, "kv_value_match", value_match)
    monkeypatch.setattr(batched_engine._KVAdccEvaluator, "_host_row_ok",
                        host_row_ok)
    batched_engine.reset_stats()

    def sweep(sc, nvm, mode):
        return sc.sweep(
            [("kv", {"profile": "udb", "n_steps": 10, "seed": 11})],
            ("adcc",), (sc.CrashPlan.at_every_step(torn=sc.TornSpec(
                0.5, seed=4, samples=2, granularity="word")),),
            cfg=nvm.NVMConfig(cache_bytes=SMALL), mode=mode)

    results = sweep(port_sc, port_nvm, "batched")
    assert _cells(port_sc, results) \
        == _cells(ref_sc, sweep(ref_sc, ref_nvm, "measure"))
    assert seen["rows"] > 0 and seen["values"] > 0, seen
    assert seen["rechecks"] > 0, seen
    assert any(r.info.get("torn_flagged") for r in results)
    assert batched_engine.stats["kv_overturned"] == 0


def test_certification_validate_clean_blind_dirty():
    kw = dict(plans=(port_sc.CrashPlan.at_every_step(
        torn=port_sc.TornSpec(fraction=0.5, seed=5, samples=2)),),
        mode="measure")
    vcells = port_sc.sweep(workloads=(("kv", {"n_steps": 18}),),
                           strategies=("adcc",), **kw)
    assert all(c.state_certified is not False for c in vcells)
    bcells = port_sc.sweep(workloads=(("kv", {"n_steps": 18,
                                              "policy": "blind"}),),
                           strategies=("adcc",), **kw)
    assert any(c.state_certified is False for c in bcells)
    ref_b = ref_sc.sweep(workloads=(("kv", {"n_steps": 18,
                                            "policy": "blind"}),),
                         strategies=("adcc",),
                         plans=(ref_sc.CrashPlan.at_every_step(
                             torn=ref_sc.TornSpec(fraction=0.5, seed=5,
                                                  samples=2)),),
                         mode="measure")
    assert [ref_sc.deterministic_cell_dict(c) for c in ref_b] \
        == [port_sc.deterministic_cell_dict(c) for c in bcells]


def test_kv_batched_without_a_card_raises():
    """No card and no ``use_device("cpu")``: the KV device math asks
    for the card and raises; nothing carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch import device as device_mod
    saved, device_mod._selected = device_mod._selected, None
    try:
        with pytest.raises(RuntimeError, match="use_device"):
            port_sc.sweep([("kv", {"n_steps": 6})], ("adcc",),
                          (port_sc.CrashPlan.at_every_step(),),
                          mode="batched")
    finally:
        device_mod._selected = saved

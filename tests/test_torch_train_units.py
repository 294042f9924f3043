"""Port vs reference, the training substrates: configs, the data
pipeline, the schedule, AdamW / Adafactor, int8 compression, the
checksum ledger, slots, checkpoints, the straggler monitor and the
carrying of parameters and optimizer state between the packages.

The same seeded numpy inputs go to ``repro`` and to ``repro_torch`` on
the CPU. Tolerances, each with its reason:

* the schedule: ``rtol 5e-7`` (a few float32 ulps), and equal at nearly
  every step. Both compute it in float32 from the integer step, the same
  operations in the same order, but XLA's float32 ``cos`` and the C
  library's differ in the last bit at some arguments (cos(0.7778 pi):
  XLA -0.76604462, torch and numpy -0.76604456); ``1 + cos`` cancels
  and makes that up to 2 ulps of ``lr`` (1.4e-7 relative), at 3 of the
  122 steps here.
* optimizer updates and new state: ``rtol 2e-6`` relative to each
  tensor's largest value (``atol`` 2e-6 times that value), a few float32
  ulps: the same expressions, but XLA and PyTorch may use other ``pow``,
  ``sqrt`` and ``cos`` routines and XLA may fuse.
* int8 compression: by property (error feedback converges to
  ``rel < 0.02``, the reference's own bound): the rounding noise comes
  from a ``torch.Generator``, whose stream cannot equal ``jax.random``'s.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import MeshConfig as RefMeshConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import slots as ref_slots
from repro.core.acc_state import flatten_checksums as ref_flatten_checksums
from repro.data.pipeline import SyntheticPipeline as RefPipeline
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.manager import (restore_checkpoint,
                                            restore_elastic, save_checkpoint)
from repro_torch.configs.base import MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.acc_state import (ChecksumLedger, LedgerRecord,
                                        flatten_checksums,
                                        verify_state_against_record)
from repro_torch.core.slots import SlotStore, flatten_state, unflatten_state
from repro_torch.data import PipelineState, SyntheticPipeline
from repro_torch.launch.steps import tree_checksums
from repro_torch.launch.train import StragglerMonitor
from repro_torch.models import get_config
from repro_torch.models.carry import (opt_from_reference, opt_to_reference,
                                      opt_tree, params_from_reference,
                                      params_to_reference, reference_tree)
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress_decompress,
                                           init_error_state)

OPT_TOL = 2e-6
ARCHS = ["llama3-8b", "phi4-mini-3.8b"]


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float = OPT_TOL) -> None:
    want = np.asarray(want, np.float64)
    got = got.to(torch.float64).numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_train_and_mesh_configs_are_the_references():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(RefTrainConfig())
    assert dataclasses.asdict(MeshConfig()) == \
        dataclasses.asdict(RefMeshConfig())
    assert MeshConfig((2, 4)).n_devices == RefMeshConfig((2, 4)).n_devices
    assert TrainConfig().remat == "dots"


# ---------------------------------------------------------------------------
# data pipeline (twins of test_framework_units.py::TestPipeline)
# ---------------------------------------------------------------------------

class TestPipeline:
    CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128)

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("step", [0, 5, 1000])
    def test_batches_byte_identical_to_reference(self, arch, step):
        cfg = get_config(arch).reduced()
        mine = SyntheticPipeline(cfg, 4, 32, seed=7).batch_at(step)
        ref = RefPipeline(cfg, 4, 32, seed=7).batch_at(step)
        assert mine.keys() == ref.keys()
        for k in mine:
            assert mine[k].dtype == ref[k].dtype
            assert mine[k].tobytes() == ref[k].tobytes()

    def test_batch_pure_function_of_step(self):
        p1 = SyntheticPipeline(self.CFG, batch=4, seq=16, seed=3)
        p2 = SyntheticPipeline(self.CFG, batch=4, seq=16, seed=3)
        for _ in range(3):
            next(p2)
        assert np.array_equal(p1.batch_at(7)["tokens"],
                              p2.batch_at(7)["tokens"])

    def test_cursor_resume_replays_stream(self):
        p1 = SyntheticPipeline(self.CFG, batch=4, seq=16, seed=1)
        for _ in range(5):
            next(p1)
        cursor = p1.cursor()
        p2 = SyntheticPipeline(self.CFG, batch=4, seq=16, seed=999)
        p2.restore(cursor)
        nxt = next(p2)
        expect = SyntheticPipeline(self.CFG, batch=4, seq=16,
                                   seed=1).batch_at(5)
        assert np.array_equal(nxt["tokens"], expect["tokens"])
        assert PipelineState.from_array(cursor).step == 5

    def test_labels_are_shifted_tokens(self):
        b = SyntheticPipeline(self.CFG, batch=2, seq=16, seed=0).batch_at(0)
        assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_different_seeds_differ(self):
        a = SyntheticPipeline(self.CFG, batch=2, seq=16, seed=0).batch_at(0)
        b = SyntheticPipeline(self.CFG, batch=2, seq=16, seed=1).batch_at(0)
        assert not np.array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# schedule (twin of test_framework_units.py::TestSchedules)
# ---------------------------------------------------------------------------

class TestSchedules:
    @pytest.mark.parametrize("tcfg", [
        TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100),
        TrainConfig(),
        TrainConfig(warmup_steps=0, total_steps=1)])
    def test_equals_reference_within_float32_rounding(self, tcfg):
        ref_cfg = RefTrainConfig(**dataclasses.asdict(tcfg))
        steps = list(range(0, 120)) + [tcfg.total_steps, 20_000]
        mine = [np.float32(adamw.lr_schedule(
            tcfg, torch.tensor(s, dtype=torch.int32))) for s in steps]
        ref = [np.float32(ref_adamw.lr_schedule(ref_cfg, jnp.int32(s)))
               for s in steps]
        mine, ref = np.array(mine), np.array(ref)
        np.testing.assert_allclose(mine, ref, rtol=5e-7, atol=0)
        assert np.mean(mine == ref) >= 0.95
        assert adamw.lr_schedule(tcfg, torch.tensor(3)).dtype == torch.float32

    def test_warmup_then_decay(self):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10,
                           total_steps=100)
        lrs = [float(adamw.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(100)]
        assert lrs[0] < lrs[5] < lrs[10]
        assert lrs[10] == max(lrs)
        assert lrs[-1] < 0.2 * max(lrs)


# ---------------------------------------------------------------------------
# optimizers against the reference
# ---------------------------------------------------------------------------

SHAPES = {"w2": (16, 8), "w3": (6, 16, 8), "norm": (16,)}


def _opt_inputs(seed: int, tiny: bool = False):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              SHAPES.items()}
    grads = {k: (rng.normal(size=s) * (1e-3 if tiny else 1.0))
             .astype(np.float32) for k, s in SHAPES.items()}
    return params, grads


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(steps):
    tcfg = TrainConfig(warmup_steps=2, total_steps=10)
    ref_cfg = RefTrainConfig(**dataclasses.asdict(tcfg))
    params, _ = _opt_inputs(0)
    p_ref = {k: jnp.asarray(v) for k, v in params.items()}
    p_mine = {k: _t(v) for k, v in params.items()}
    s_ref = ref_adamw.adamw_init(p_ref)
    s_mine = adamw.adamw_init(p_mine)
    for t in range(steps):
        _, grads = _opt_inputs(10 + t)
        u_ref, s_ref = ref_adamw.adamw_update(
            ref_cfg, {k: jnp.asarray(v) for k, v in grads.items()}, s_ref,
            p_ref)
        u_mine, s_mine = adamw.adamw_update(
            tcfg, {k: _t(v) for k, v in grads.items()}, s_mine, p_mine)
        for k in SHAPES:
            _close(u_mine[k], u_ref[k])
            _close(s_mine.m[k], s_ref.m[k])
            _close(s_mine.v[k], s_ref.v[k])
            p_ref[k] = p_ref[k] + u_ref[k]
            p_mine[k] = p_mine[k] + u_mine[k]
        assert int(s_mine.step) == int(s_ref.step) == t + 1
        assert s_mine.step.dtype == torch.int32


@pytest.mark.parametrize("tiny", [False, True])
def test_adafactor_update_matches_reference(tiny):
    """2-D, stacked 3-D and 1-D leaves; ``tiny`` gradients put the RMS
    clip below 1 and the eps terms in play."""
    tcfg = TrainConfig(optimizer="adafactor", warmup_steps=2,
                       total_steps=10)
    ref_cfg = RefTrainConfig(**dataclasses.asdict(tcfg))
    params, _ = _opt_inputs(1)
    p_ref = {k: jnp.asarray(v) for k, v in params.items()}
    p_mine = {k: _t(v) for k, v in params.items()}
    s_ref = ref_adamw.adafactor_init(p_ref)
    s_mine = adamw.adafactor_init(p_mine)
    for t in range(3):
        _, grads = _opt_inputs(20 + t, tiny=tiny)
        u_ref, s_ref = ref_adamw.adafactor_update(
            ref_cfg, {k: jnp.asarray(v) for k, v in grads.items()}, s_ref,
            p_ref)
        u_mine, s_mine = adamw.adafactor_update(
            tcfg, {k: _t(v) for k, v in grads.items()}, s_mine, p_mine)
        for k in SHAPES:
            _close(u_mine[k], u_ref[k])
            assert s_mine.stats[k].keys() == s_ref.stats[k].keys()
            for j in s_ref.stats[k]:
                _close(s_mine.stats[k][j], s_ref.stats[k][j])
    assert s_mine.stats["w3"]["row"].shape == (6, 16)
    assert s_mine.stats["w3"]["col"].shape == (6, 8)


def test_adafactor_3d_params():
    """Twin of the reference's regression: factored stats broadcast over
    stacked (L, D, F) leaves."""
    tcfg = TrainConfig(optimizer="adafactor")
    params = {"w": torch.ones((6, 16, 8))}
    grads = {"w": torch.full((6, 16, 8), 0.1)}
    state = adamw.adafactor_init(params)
    upd, state = adamw.adafactor_update(tcfg, grads, state, params)
    assert upd["w"].shape == (6, 16, 8)
    assert bool(torch.isfinite(upd["w"]).all())


def test_make_optimizer_choices():
    init, _ = adamw.make_optimizer(TrainConfig(optimizer="adafactor"))
    assert init is adamw.adafactor_init
    init, _ = adamw.make_optimizer(TrainConfig())
    assert init is adamw.adamw_init
    with pytest.raises(ValueError, match="optimizer"):
        adamw.make_optimizer(TrainConfig(optimizer="sgd"))


def test_int8_compression_error_feedback():
    """Twin of the reference's test: with error feedback the mean
    compressed signal converges to the truth; each round's values are
    int8 multiples of the scale."""
    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.from_numpy(
        np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))}
    err = init_error_state(g)
    total = torch.zeros((64, 64))
    for _ in range(64):
        gc, err = compress_decompress(g, err, gen)
        total += gc["w"]
    rel = float(torch.linalg.norm(total / 64 - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02, rel
    # one round from zero error: values on the int8 grid, residual bounded
    gc, e1 = compress_decompress(g, init_error_state(g),
                                 torch.Generator().manual_seed(1))
    scale = float(g["w"].abs().max()) / 127.0
    q = gc["w"] / scale
    assert float((q - q.round()).abs().max()) < 1e-3
    assert float(e1["w"].abs().max()) <= scale * (1 + 1e-5)


# ---------------------------------------------------------------------------
# carrying parameters and optimizer state
# ---------------------------------------------------------------------------

def _ref_state(arch: str, optimizer: str, seed: int = 0):
    """repro's params and an optimizer state after one update on random
    grads (so m / v / stats are not zero)."""
    cfg = get_config(arch).reduced()
    api = ref_build_model(cfg)
    params, _ = api.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)
    rcfg = RefTrainConfig(optimizer=optimizer)
    init, update = ref_adamw.make_optimizer(rcfg)
    _, opt = update(grads, init(params), params)
    return cfg, params, opt


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_round_trips_through_reference_layout(arch, optimizer):
    cfg, params, opt = _ref_state(arch, optimizer)
    tree = jax.tree.map(np.asarray, params)
    lm = params_from_reference(cfg, tree)
    back = params_to_reference(cfg, lm)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 tree, back)
    opt_np = jax.tree.map(np.asarray, opt._asdict())
    mine = opt_from_reference(cfg, opt_np)
    assert isinstance(mine, adamw.AdamWState if optimizer == "adamw"
                      else adamw.AdafactorState)
    again = opt_to_reference(cfg, mine)
    assert jax.tree.structure(again) == jax.tree.structure(opt_np)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 opt_np, again)
    assert again["step"].dtype == np.int32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_slot_layout_and_checksums_equal_the_references(tmp_path, arch,
                                                        optimizer):
    """The flat slot keys are the reference's (read from repro's
    flatten_state, not typed here), the checksum lists have its length
    and order, and a slot written by repro restores into the port's
    state and verifies against repro's own sums."""
    cfg, params, opt = _ref_state(arch, optimizer, seed=1)
    ref_flat = ref_slots.flatten_state({"params": params, "opt": opt})
    store = SlotStore(str(tmp_path), n_slots=2)
    ref_slots.SlotStore(str(tmp_path), n_slots=2).write_slot(0, 4, ref_flat)
    flat = store.read_slot(0)
    abstract = get_config(arch).reduced()
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    api = build_model(abstract)
    _, _, opt_init = build_train_step(api, TrainConfig(optimizer=optimizer))
    meta_lm = api.abstract_init()
    state = unflatten_state({"params": meta_lm, "opt": opt_init(meta_lm)},
                            flat)
    mine = flatten_state(state)
    assert sorted(mine) == sorted(ref_flat)
    for k in ref_flat:
        assert mine[k].dtype == ref_flat[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref_flat[k])
    # checksum lists: same order and length as repro's tree_checksums
    rsum = lambda tree: ref_flatten_checksums(jax.tree.map(
        lambda x: jnp.sum(x.astype(jnp.float32)), tree))
    want_p, want_o = rsum(params), rsum(opt)
    cfg_ = state["params"].cfg
    got_p = flatten_checksums(tree_checksums(
        reference_tree(cfg_, dict(state["params"].named_parameters()))))
    got_o = flatten_checksums(tree_checksums(opt_tree(cfg_, state["opt"])))
    assert len(got_p) == len(want_p) and len(got_o) == len(want_o)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-3)
    rec = LedgerRecord(4, 0, [0, 5, 0], want_p, want_o, [0.0] * len(want_p),
                       1.0)
    assert verify_state_against_record(state["params"], state["opt"],
                                       rec) == (True, 0)
    bad = dataclasses.replace(rec, cks_params=[want_p[0] + 10.0]
                              + want_p[1:])
    assert verify_state_against_record(state["params"], state["opt"],
                                       bad) == (False, 1)


# ---------------------------------------------------------------------------
# ledger (twin of test_adcc_training.py::TestLedger)
# ---------------------------------------------------------------------------

class TestLedger:
    def test_constants_are_the_references(self):
        from repro.core.acc_state import ChecksumLedger as Ref
        assert (ChecksumLedger.CHAIN_RTOL, ChecksumLedger.SLOT_RTOL,
                ChecksumLedger.SLOT_ATOL) == (Ref.CHAIN_RTOL, Ref.SLOT_RTOL,
                                              Ref.SLOT_ATOL) == (1e-3, 1e-4,
                                                                 1e-2)

    def test_append_and_read(self, tmp_path):
        led = ChecksumLedger(str(tmp_path / "l.jsonl"))
        for t in range(3):
            led.append(LedgerRecord(step=t, rng_seed=0, cursor=[0, t + 1, 0],
                                    cks_params=[1.0 * t], cks_opt=[2.0 * t],
                                    cks_updates=[1.0 if t else 0.0],
                                    loss=1.0))
        led.close()
        assert len(led.read_all()) == 3
        # the same JSON line the reference writes
        from repro.core.acc_state import LedgerRecord as RefRecord
        rec = led.read_all()[1]
        assert rec.to_json() == RefRecord(**dataclasses.asdict(rec)).to_json()

    def test_torn_tail_line_discarded(self, tmp_path):
        path = str(tmp_path / "l.jsonl")
        led = ChecksumLedger(path)
        led.append(LedgerRecord(0, 0, [0, 1, 0], [1.0], [0.0], [0.0], 1.0))
        led.close()
        with open(path, "a") as fh:
            fh.write('{"step": 1, "rng_seed": 0, "cursor": [0,2,0], "cks_p')
        assert len(ChecksumLedger(path).read_all()) == 1

    def test_linearity_chain_breaks_on_corruption(self, tmp_path):
        led = ChecksumLedger(str(tmp_path / "l.jsonl"))
        cks = 10.0
        for t in range(5):
            upd = 0.5
            cks_rec = cks + upd if t != 3 else cks + 99.0  # corrupt step 3
            led.append(LedgerRecord(t, 0, [0, t + 1, 0], [cks_rec], [0.0],
                                    [upd], 1.0))
            cks = cks + upd
        led.close()
        assert [r.step for r in led.validated_records()] == [0, 1, 2]
        assert led.record_for_step(2).step == 2
        assert led.record_for_step(3) is None

    def test_verify_state_against_record(self):
        cfg = get_config("llama3-8b").reduced()
        cfg = dataclasses.replace(cfg, n_layers=1, vocab_size=256)
        from repro_torch.models.lm import LM
        lm = LM(cfg, device="cpu")
        with torch.no_grad():
            for p in lm.parameters():
                p.fill_(1.0)
        opt = adamw.adamw_init(dict(lm.named_parameters()))
        n = [float(x.numel()) for x in
             (lm.embed, lm.head, lm.layers[0].attn.wk, lm.layers[0].attn.wo,
              lm.layers[0].attn.wq, lm.layers[0].attn.wv,
              lm.layers[0].ffn.w_down, lm.layers[0].ffn.w_gate,
              lm.layers[0].ffn.w_up, lm.layers[0].norm_attn.gamma,
              lm.layers[0].norm_ffn.gamma, lm.norm_f.gamma)]
        zeros = [0.0] * (1 + 2 * len(n))
        rec = LedgerRecord(0, 0, [0, 1, 0], n, zeros, [0.0] * len(n), 1.0)
        assert verify_state_against_record(lm, opt, rec) == (True, 0)
        rec_bad = LedgerRecord(0, 0, [0, 1, 0], [n[0] + 100.0] + n[1:], zeros,
                               [0.0] * len(n), 1.0)
        assert verify_state_against_record(lm, opt, rec_bad) == (False, 1)
        short = LedgerRecord(0, 0, [0, 1, 0], n[:-1], zeros, [], 1.0)
        assert verify_state_against_record(lm, opt, short)[0] is False


# ---------------------------------------------------------------------------
# slots (twin of test_adcc_training.py::TestSlots)
# ---------------------------------------------------------------------------

class TestSlots:
    CFG = dataclasses.replace(get_config("llama3-8b").reduced(), n_layers=2,
                              vocab_size=256)

    def _state(self, seed=0):
        from repro_torch.models.lm import LM
        lm = LM(self.CFG, device="cpu").init_(
            torch.Generator().manual_seed(seed))
        opt = adamw.adamw_init(dict(lm.named_parameters()))
        return {"params": lm, "opt": opt}

    def _sums(self, state):
        return [float(x) for x in flatten_checksums(tree_checksums(
            reference_tree(self.CFG, dict(state["params"].named_parameters()))))]

    def test_roundtrip(self, tmp_path):
        store = SlotStore(str(tmp_path), n_slots=2)
        state = self._state()
        store.write_slot(0, 5, flatten_state(state))
        rebuilt = unflatten_state(state, store.read_slot(0))
        for (n, a), (_, b) in zip(state["params"].named_parameters(),
                                  rebuilt["params"].named_parameters()):
            assert torch.equal(a, b), n
        assert int(rebuilt["opt"].step) == 0

    def test_torn_write_detectable(self, tmp_path):
        store = SlotStore(str(tmp_path), n_slots=2)
        s1, s2 = self._state(seed=1), self._state(seed=2)
        store.write_slot(0, 5, flatten_state(s1))
        store.write_slot(0, 9, flatten_state(s2), tear_after=1)  # torn!
        rebuilt = unflatten_state(s1, store.read_slot(0))
        # mixed generations: checksum verification must reject
        assert not np.allclose(self._sums(rebuilt), self._sums(s2))

    def test_missing_leaf_raises_as_a_torn_slot_does(self, tmp_path):
        store = SlotStore(str(tmp_path), n_slots=1)
        state = self._state()
        flat = flatten_state(state)
        del flat["params/layers/attn/wq"]
        store.write_slot(0, 1, flat)
        with pytest.raises(KeyError):
            unflatten_state(state, store.read_slot(0))
        flat = flatten_state(state)
        flat["opt/m/embed"] = flat["opt/m/embed"][:3]
        store.write_slot(0, 2, flat)
        with pytest.raises(ValueError):
            unflatten_state(state, store.read_slot(0))

    def test_recency_order(self, tmp_path):
        store = SlotStore(str(tmp_path), n_slots=3)
        for k, step in [(0, 3), (1, 7), (2, 5)]:
            store.write_slot(k, step, flatten_state(self._state(step)))
        assert store.slots_by_recency() == [(1, 7), (2, 5), (0, 3)]

    def test_async_writer_writes_and_times_each_slot(self, tmp_path):
        from repro_torch.core.slots import AsyncSlotWriter
        store = SlotStore(str(tmp_path), n_slots=2)
        writer = AsyncSlotWriter(store)
        for step in (1, 3):
            writer.submit(step, flatten_state(self._state(step)))
        writer.drain(timeout=30.0)
        assert store.slots_by_recency() == [(1, 3), (0, 1)]
        assert len(writer.write_seconds) == 2
        assert all(m["complete"] for m in map(store.read_meta, (0, 1)))


# ---------------------------------------------------------------------------
# checkpoints (twin of test_adcc_training.py::TestElasticCheckpoint)
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        state = {"w": torch.ones((8, 16)),
                 "step": torch.tensor(7, dtype=torch.int32)}
        save_checkpoint(str(tmp_path / "ck"), state, step=7)
        restored, meta = restore_checkpoint(str(tmp_path / "ck"), state)
        assert meta["step"] == 7 and meta["n_leaves"] == 2
        assert torch.equal(restored["w"], torch.ones((8, 16)))
        assert restored["step"].dtype == torch.int32
        assert int(restored["step"]) == 7

    def test_reference_reads_the_ports_checkpoint(self, tmp_path):
        from repro.checkpoint.manager import restore_checkpoint as ref_restore
        state = {"w": torch.arange(12.0).reshape(3, 4)}
        save_checkpoint(str(tmp_path / "ck"), state, step=3)
        restored, meta = ref_restore(str(tmp_path / "ck"),
                                     {"w": jnp.zeros((3, 4))})
        np.testing.assert_array_equal(np.asarray(restored["w"]),
                                      state["w"].numpy())
        assert meta["step"] == 3

    def test_elastic_restore_waits_for_sharding(self, tmp_path):
        state = {"w": torch.ones((8, 16))}
        save_checkpoint(str(tmp_path / "ck"), state, step=3)
        with pytest.raises(ValueError, match="partition rules"):
            restore_elastic(str(tmp_path / "ck"), state, None,
                            {"w": ("embed", "mlp")})


# ---------------------------------------------------------------------------
# straggler monitor (twin of test_adcc_training.py::TestStraggler)
# ---------------------------------------------------------------------------

class TestStraggler:
    def test_flags_outliers(self):
        mon = StragglerMonitor(window=16, threshold=2.0)
        for t in range(20):
            flagged = mon.record(t, 1.0 if t != 15 else 5.0)
            if t == 15:
                assert flagged
        assert mon.flagged_steps == [15]

    def test_no_false_positives_on_uniform(self):
        mon = StragglerMonitor()
        for t in range(50):
            assert not mon.record(t, 1.0 + 0.01 * (t % 3))


def test_training_path_runs_with_jax_and_repro_blocked(tmp_path):
    """The training modules import, and a reduced trainer crashes and
    recovers, in a process where jax and repro cannot be imported."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.data, repro_torch.optim\n"
        "import repro_torch.checkpoint, repro_torch.launch\n"
        "import repro_torch.core.acc_state, repro_torch.core.slots\n"
        "from repro_torch.configs.base import TrainConfig\n"
        "from repro_torch.launch.train import ADCCTrainer\n"
        "from repro_torch.models import get_config\n"
        "cfg = get_config('llama3-8b').reduced()\n"
        "kw = dict(batch=2, seq=16, slot_every=2)\n"
        "with repro_torch.use_device('cpu'):\n"
        f"    wd = {str(tmp_path / 'w')!r}\n"
        "    ADCCTrainer(cfg, TrainConfig(), wd, **kw).run(\n"
        "        4, crash_at_step=2, log_every=0)\n"
        "    res = ADCCTrainer(cfg, TrainConfig(), wd, **kw).run(\n"
        "        4, log_every=0)\n"
        "assert res.resumed_from == 1, res\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('trained')\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained"

"""Port vs reference, the training path: ``loss_fn`` and its gradients,
rematerialisation, the train step with its ADCC checksums, slots and
ledgers that cross between the packages, and the ADCC trainer's crash /
restart behaviour (twins of ``tests/test_adcc_training.py``).

Weights come from ``repro``'s ``api.init`` and go into the port through
``repro_torch.models.carry``; batches come from the shared counter-based
pipeline, byte-identical in both packages. Everything runs on the CPU.

Tolerances, each with its reason:

* float32 compute (``compute_dtype="float32"``): loss within ``1e-5``,
  each gradient leaf within ``1e-5`` of its largest value. Readings: loss
  5e-7, gradients at most 2e-6 (summation order of float32 products).
* bfloat16 compute (the configs' own): loss within ``5e-3``, each
  gradient leaf within ``5e-2`` of its largest value. Readings: loss
  1.2e-3, gradients at most 2.2e-2: XLA and PyTorch round bf16 at other
  points (XLA fuses elementwise chains in float32), as for the serving
  logits (tests/test_torch_models.py).
  The cast-once semantics of the step (the embedding's gradient summed
  in bf16, not float32) cannot be told apart from per-use casting by
  this comparison: on these inputs accumulating in float32 instead moves
  the reference's own embedding gradient by 5e-3 of its largest value,
  half the packages' bf16 difference (1e-2). So
  ``test_bf16_gradients_are_taken_once_in_bf16`` shows the mechanism
  within the port: every gradient of a weight of two or more dimensions
  is a bf16 value, and per-use casting would not give that.
* three train steps (float32 compute, AdamW, ``remat="dots"``): loss and
  grad_norm within ``1e-5`` relative (readings at most 5.2e-7); the
  checksums of parameters and optimizer state within ``1e-5`` relative
  plus ``1e-3`` absolute (readings at most 3.7e-4 on sums up to 380: the
  reference sums a stacked leaf at once, the port adds its layers'
  sums); the update checksums within ``1e-4`` of the largest one
  (readings 3.4e-5). The parameters after the steps are held to
  ``2 lr + 1e-6`` elementwise (reading 3.2e-5): AdamW's first step is
  ``lr * g / (|g| + eps)``, so an element whose gradient is as small as
  the packages' float32 difference (2e-6 of the leaf's largest value)
  may flip the sign of its update, a change of ``2 lr``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import acc_state as ref_acc
from repro.core import slots as ref_slots
from repro.launch.mesh import single_device_mesh
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.launch.steps import tree_checksums as ref_tree_checksums
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import init_error_state as ref_init_error_state
from repro.sharding.partition import make_rules
from repro_torch.configs.base import TrainConfig
from torch_parity import assert_step_checksums
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh, single_device_mesh as one_card_mesh
from repro_torch.launch.steps import build_serve_step, build_train_step
from repro_torch.launch.train import ADCCTrainer
from repro_torch.models import build_model, get_config, list_archs
from repro_torch.models.carry import (params_from_reference,
                                      params_to_reference, reference_paths,
                                      reference_tree, tree_items)

ARCHS = ["llama3-8b", "phi4-mini-3.8b"]
B, S = 2, 32


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _cfgs(arch: str, compute: str):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype=compute)
    return cfg, ref_build_model(cfg)


_PARAMS = {}


def _ref_params(arch: str):
    if arch not in _PARAMS:
        cfg = get_config(arch).reduced()
        params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = params
    return _PARAMS[arch]


def _batch(cfg, step: int = 0):
    return SyntheticPipeline(cfg, B, S, seed=3).batch_at(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _to_compute(dt):
    return lambda w: (w.astype(dt) if w.dtype == jnp.float32 and w.ndim >= 2
                      else w)


def _ref_value_and_grad(api, params, batch, compute):
    """The reference train step's own gradient: through the cast-once
    compute copy (``to_compute`` in repro/launch/steps.py)."""
    tc = _to_compute(jnp.dtype(compute))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(
        lambda p: api.loss_fn(jax.tree.map(tc, p), jb, None,
                              remat="none"))(params)


def _grads_as_reference(cfg, grads):
    from repro_torch.models.carry import to_host
    return {p: to_host(x) for p, x in tree_items(reference_tree(cfg, grads))}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-5), ("bfloat16", 5e-3, 5e-2)])
def test_loss_and_gradients_match_reference(arch, compute, loss_tol,
                                            grad_tol):
    cfg, ref_api = _cfgs(arch, compute)
    params = _ref_params(arch)
    batch = _batch(cfg)
    ref_loss, ref_grads = _ref_value_and_grad(ref_api, params, batch,
                                              compute)
    lm = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    api = build_model(cfg)
    _, info, _ = build_train_step(api, TrainConfig(remat="none"))
    loss, grads = info["value_and_grad"](lm, _torch_batch(batch))
    assert abs(float(loss) - float(ref_loss)) <= loss_tol
    # the plain loss_fn on the float32 weights: the same loss at float32
    assert abs(float(api.loss_fn(lm, _torch_batch(batch))) - float(ref_loss)) \
        <= loss_tol
    mine = _grads_as_reference(cfg, grads)
    want = dict(tree_items(jax.tree.map(np.asarray, ref_grads)))
    assert list(mine) == list(want)
    for path, g in want.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(mine[path] - g).max())
        assert err <= grad_tol * scale, (path, err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_are_taken_once_in_bf16(arch):
    """The step differentiates a bf16 copy of every weight of two or more
    dimensions, so their gradients (the embedding's sum over repeated
    tokens, and the tied table's head + gather sum, included) are bf16
    values. (1-D weights stay float32 and are cast where they are used,
    so theirs are bf16 values too.) Differentiating the float32 weights
    with a cast at each use sums the embedding's rows in float32 and
    gives values that bf16 cannot hold."""
    cfg, _ = _cfgs(arch, "bfloat16")
    lm = params_from_reference(cfg, jax.tree.map(np.asarray,
                                                 _ref_params(arch)))
    batch = _torch_batch(_batch(cfg))
    api = build_model(cfg)
    _, info, _ = build_train_step(api, TrainConfig(remat="none"))
    _, grads = info["value_and_grad"](lm, batch)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32)), name
    # per-use casting: the embedding's gradient is no longer bf16
    for p in lm.parameters():
        p.requires_grad_(True)
    g_embed, = torch.autograd.grad(api.loss_fn(lm, batch), [lm.embed])
    assert not torch.equal(g_embed, g_embed.to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    lm = params_from_reference(cfg, jax.tree.map(np.asarray,
                                                 _ref_params(arch)))
    batch = _torch_batch(_batch(cfg))
    api = build_model(cfg)
    out = {}
    for remat in ("none", "full", "dots"):
        _, info, _ = build_train_step(api, TrainConfig(remat=remat))
        out[remat] = info["value_and_grad"](lm, batch)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for n, g in out["none"][1].items():
            assert torch.equal(out[remat][1][n], g), (remat, n)


def test_dots_policy_saves_projections_and_recomputes_the_rest():
    """remat="dots" keeps the outputs of aten.mm (the projections) and
    recomputes attention's batched products and the elementwise work."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import lm as lm_mod
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert lm_mod._save_projections(None, mm) == CheckpointPolicy.MUST_SAVE
    assert lm_mod._save_projections(None, bmm) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    cfg = get_config("llama3-8b").reduced()
    lm = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg))
    with pytest.raises(ValueError, match="remat"):
        lm_mod.forward_train(cfg, lm, batch, remat="some")
    with pytest.raises(NotImplementedError, match="loss_fn"):
        lm_mod.forward(cfg, lm, batch, remat="dots")


def test_cross_entropy_matches_reference_and_masks():
    from repro.models.lm import cross_entropy as ref_ce
    from repro_torch.models.lm import cross_entropy
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -100
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    want = float(ref_ce(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    all_masked = np.full_like(labels, -100)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(all_masked))) == 0.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    cfg, ref_api = _cfgs(arch, "float32")
    params = _ref_params(arch)
    tcfg = TrainConfig(remat="dots", warmup_steps=2, total_steps=20)
    ref_step, _, ref_init = ref_build_train_step(
        ref_api, RefTrainConfig(**dataclasses.asdict(tcfg)),
        make_rules(single_device_mesh(), fsdp=True), donate=False)
    lm = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    step, _, opt_init = build_train_step(build_model(cfg), tcfg)
    r_p, r_o, r_e = params, ref_init(params), ref_init_error_state(params)
    opt = opt_init(lm)
    lr_max = float(tcfg.learning_rate)
    for t in range(3):
        batch = _batch(cfg, t)
        r_p, r_o, r_e, r_m, r_c = ref_step(
            r_p, r_o, r_e, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(t))
        lm, opt, _, m, c = step(lm, opt, {}, _torch_batch(batch),
                                torch.Generator().manual_seed(t))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                       rtol=1e-5)
        assert_step_checksums(c, r_c, tcfg, t + 1)
    mine = params_to_reference(cfg, lm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=2 * lr_max + 1e-6), mine, r_p)


def test_step_without_donation_keeps_its_inputs():
    cfg = get_config("llama3-8b").reduced()
    api = build_model(cfg)
    lm = api.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg))
    before = {n: p.clone() for n, p in lm.named_parameters()}
    step, _, opt_init = build_train_step(api, TrainConfig(remat="none"),
                                         donate=False)
    opt = opt_init(lm)
    new_lm, new_opt, _, m1, _ = step(lm, opt, {}, batch, None)
    assert new_lm is not lm and int(opt.step) == 0 and int(new_opt.step) == 1
    for n, p in lm.named_parameters():
        assert torch.equal(p, before[n])
    step2, _, _ = build_train_step(api, TrainConfig(remat="none"))
    lm2, _, _, m2, _ = step2(lm, opt_init(lm), {}, batch, None)
    assert lm2 is lm and float(m1["loss"]) == float(m2["loss"])
    for (n, a), (_, b) in zip(new_lm.named_parameters(),
                              lm.named_parameters()):
        assert torch.equal(a, b), n


def test_sharding_entry_points_wait_for_their_slice():
    """The training entry points take a mesh; what is none raises
    TypeError, and a layout of several ranks (no process group behind it)
    ValueError naming ``make_mesh``. Training across the ranks of a
    DeviceMesh is ``tests/test_torch_train_ranks.py``'s."""
    api = build_model(get_config("llama3-8b").reduced())
    with pytest.raises(TypeError, match="not a mesh"):
        build_train_step(api, TrainConfig(), rules=object())
    with pytest.raises(ValueError, match="make_mesh"):
        build_train_step(api, TrainConfig(), Mesh(("data", "model"), (2, 2)))
    with pytest.raises(TypeError, match="not a mesh"):
        ADCCTrainer(api.cfg, TrainConfig(), "unused", mesh=object())


def test_one_card_mesh_is_taken_and_larger_ones_raise(tmp_path):
    """A mesh of one card, what the reference's trainer builds when it is
    given none, goes through ``build_train_step``, ``build_serve_step``,
    the trainer and the model. A layout of two ranks raises ValueError
    naming ``make_mesh`` (training and serving across ranks need a
    DeviceMesh bound to a process group)."""
    mesh = one_card_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.size) == \
        (("data", "model"), {"data": 1, "model": 1}, 1)
    api = build_model(get_config("llama3-8b").reduced())
    lm = api.init(torch.Generator().manual_seed(0))
    assert build_train_step(api, TrainConfig(), mesh)[1]["mesh"] is mesh
    assert build_train_step(api, TrainConfig())[1]["mesh"] is None
    tr = ADCCTrainer(api.cfg, TrainConfig(), str(tmp_path / "t"))
    assert tr.mesh == mesh and tr.info["mesh"] == mesh
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    assert torch.equal(api.forward(lm, batch, mesh), api.forward(lm, batch))
    two = Mesh(("data", "model"), (2, 1))
    for call in (lambda: build_train_step(api, TrainConfig(), two),
                 lambda: ADCCTrainer(api.cfg, TrainConfig(), "unused",
                                     mesh=two),
                 lambda: build_serve_step(api, two, batch=1, max_len=4),
                 lambda: api.forward(lm, batch, two)):
        with pytest.raises(ValueError, match="make_mesh"):
            call()


@pytest.mark.parametrize("arch", list_archs())
def test_compute_copy_casts_the_references_leaves(arch):
    """For every arch the port builds, each parameter of the step's
    compute copy has the type the reference's ``to_compute`` gives the
    leaf that holds it: every float32 leaf of two or more dimensions of
    the *stacked* tree in the compute type, so per-layer vectors (norms,
    Mamba2's A_log, dt_bias, D_skip) too, and the final and shared
    norms not."""
    cfg = get_config(arch).reduced()
    shapes, _ = ref_build_model(cfg).abstract_init(jax.random.PRNGKey(0))
    cdt = jnp.dtype(cfg.compute_dtype)
    want = {path: str(cdt if leaf.dtype == jnp.float32 and
                      len(leaf.shape) >= 2 else leaf.dtype)
            for path, leaf in tree_items(shapes)}
    copy_ = steps_mod._compute_copy(build_model(cfg).abstract_init())
    by_name = dict(copy_.named_parameters())
    got = {path: {str(by_name[n].dtype).removeprefix("torch.")
                  for n in names} for path, names in reference_paths(cfg)}
    assert got == {path: {dt} for path, dt in want.items()}
    assert type(copy_) is type(build_model(cfg).abstract_init())
    assert got["norm_f"] == {"float32"}


def test_serve_step_is_the_decode_step():
    cfg = get_config("llama3-8b").reduced()
    api = build_model(cfg)
    lm = api.init(torch.Generator().manual_seed(0))
    serve, info = build_serve_step(api, batch=2, max_len=8)
    assert info["cache_shapes"]["k"] == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                         cfg.resolved_head_dim)
    c1, _ = api.init_cache(2, 8)
    c2, _ = api.init_cache(2, 8)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    a, _ = serve(lm, c1, tok, 0)
    b, _ = api.decode_step(lm, c2, tok, 0)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer (twins of tests/test_adcc_training.py)
# ---------------------------------------------------------------------------

def tiny_trainer(workdir, mode="adcc", slot_every=6, optimizer="adamw",
                 compression="none"):
    cfg = get_config("llama3-8b").reduced()
    tcfg = TrainConfig(remat="none", total_steps=40, warmup_steps=5,
                       optimizer=optimizer, grad_compression=compression)
    return ADCCTrainer(cfg, tcfg, workdir, batch=4, seq=32,
                       slot_every=slot_every, mode=mode)


def _max_diff(lm_a, lm_b) -> float:
    return max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(lm_a.named_parameters(), lm_b.named_parameters()))


class TestCrashRestart:
    def test_bitwise_recovery(self, tmp_path):
        ref = tiny_trainer(str(tmp_path / "ref"))
        r_ref = ref.run(24, log_every=0)
        crash_dir = str(tmp_path / "crash")
        tiny_trainer(crash_dir).run(24, crash_at_step=15, log_every=0)
        tr2 = tiny_trainer(crash_dir)
        r2 = tr2.run(24, log_every=0)
        assert r2.resumed_from is not None and r2.resumed_from >= 5
        assert _max_diff(ref._final_params, tr2._final_params) == 0.0
        assert r2.losses == r_ref.losses[r2.resumed_from + 1:]
        assert [bad for _, _, bad in tr2.recovery_checks][-1] == 0

    def test_recovery_skips_torn_slot(self, tmp_path):
        wd = str(tmp_path / "t")
        tr1 = tiny_trainer(wd, slot_every=4)
        tr1.run(20, crash_at_step=18, log_every=0)
        # corrupt the newest slot's first tensor (simulate torn write)
        store = tr1.store
        newest_slot, newest_step = store.slots_by_recency()[0]
        d = store.slot_dir(newest_slot)
        fn = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
        arr = np.load(os.path.join(d, fn))
        np.save(os.path.join(d, fn), arr + 1000.0)

        tr2 = tiny_trainer(wd, slot_every=4)
        r2 = tr2.run(20, log_every=0)
        assert r2.resumed_from is not None
        assert r2.resumed_from < newest_step
        assert tr2.recovery_checks[0][1] == newest_step
        assert tr2.recovery_checks[0][2] > 0
        assert tr2.recovery_checks[-1][2] == 0

    def test_sync_mode_also_recovers(self, tmp_path):
        wd = str(tmp_path / "s")
        tr1 = tiny_trainer(wd, mode="sync", slot_every=4)
        tr1.run(16, crash_at_step=12, log_every=0)
        assert len(tr1.timings["slot_write"]) == 3
        tr2 = tiny_trainer(wd, mode="sync", slot_every=4)
        r2 = tr2.run(16, log_every=0)
        assert r2.resumed_from is not None

    def test_no_ledger_starts_fresh(self, tmp_path):
        tr = tiny_trainer(str(tmp_path / "n"), mode="none")
        res = tr.run(3, log_every=0)
        assert res.resumed_from is None and res.recovery_report == "no ledger"
        assert not os.path.exists(tr.ledger.path)


class TestCrossPackage:
    def test_reference_reads_the_ports_slot_and_ledger(self, tmp_path):
        """A slot and a ledger written by the port's trainer are read by
        repro's SlotStore / unflatten_state with repro's own template and
        pass repro's ledger chain and verify_state_against_record."""
        wd = str(tmp_path / "x")
        tr = tiny_trainer(wd, slot_every=3)
        tr.run(6, log_every=0)
        recs = ref_acc.ChecksumLedger(
            os.path.join(wd, "ledger.jsonl")).validated_records()
        assert [r.step for r in recs] == list(range(6))
        store = ref_slots.SlotStore(os.path.join(wd, "slots"), 3)
        assert store.slots_by_recency() == [(1, 5), (0, 2)]
        api = ref_build_model(get_config("llama3-8b").reduced())
        shapes, _ = api.abstract_init(jax.random.PRNGKey(0))
        template = {"params": shapes,
                    "opt": jax.eval_shape(ref_adamw.adamw_init, shapes)}
        states = {}
        for slot, step in store.slots_by_recency():
            states[step] = ref_slots.unflatten_state(template,
                                                     store.read_slot(slot))
            rec = {r.step: r for r in recs}[step]
            assert ref_acc.verify_state_against_record(
                states[step]["params"], states[step]["opt"], rec) == (True, 0)
            assert len(rec.cks_opt) == len(jax.tree.leaves(template["opt"]))
        # the newest slot holds the port's final parameters
        final = params_to_reference(tr.cfg, tr._final_params)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     final, states[5]["params"])

    def test_port_recovers_from_the_references_slot(self, tmp_path):
        """repro writes a slot and ledger record for its state at step 2;
        the port's trainer verifies and resumes from it at step 3 with
        repro's exact parameters."""
        cfg = get_config("llama3-8b").reduced()
        api = ref_build_model(cfg)
        params, _ = api.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), params)
        rcfg = RefTrainConfig()
        upd, opt = ref_adamw.adamw_update(rcfg, grads,
                                          ref_adamw.adamw_init(params),
                                          params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        wd = str(tmp_path / "r")
        ref_slots.SlotStore(os.path.join(wd, "slots"), 3).write_slot(
            0, 2, ref_slots.flatten_state({"params": params, "opt": opt}))
        led = ref_acc.ChecksumLedger(os.path.join(wd, "ledger.jsonl"))
        led.append(ref_acc.LedgerRecord(
            step=2, rng_seed=0, cursor=[0, 3, 0],
            cks_params=ref_acc.flatten_checksums(ref_tree_checksums(params)),
            cks_opt=ref_acc.flatten_checksums(ref_tree_checksums(opt)),
            cks_updates=ref_acc.flatten_checksums(ref_tree_checksums(upd)),
            loss=0.0))
        led.close()
        tr = tiny_trainer(wd)
        params_seen = {}
        orig = tr.step_fn

        def spy(lm, *a):
            params_seen.setdefault("p", params_to_reference(cfg, lm))
            return orig(lm, *a)

        tr.step_fn = spy
        res = tr.run(4, log_every=0)
        assert res.resumed_from == 2 and res.recovery_report.endswith(
            "verified")
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, np.asarray(b)), params_seen["p"], params)


class TestTrainerOptions:
    def test_adafactor_trains(self, tmp_path):
        tr = tiny_trainer(str(tmp_path / "af"), optimizer="adafactor")
        res = tr.run(12, log_every=0)
        assert np.isfinite(res.losses).all()
        assert res.losses[-1] < res.losses[0]

    def test_adafactor_slot_recovers_bitwise(self, tmp_path):
        ref = tiny_trainer(str(tmp_path / "a"), optimizer="adafactor",
                           slot_every=3)
        ref.run(7, log_every=0)
        wd = str(tmp_path / "b")
        tiny_trainer(wd, optimizer="adafactor", slot_every=3).run(
            7, crash_at_step=4, log_every=0)
        tr = tiny_trainer(wd, optimizer="adafactor", slot_every=3)
        res = tr.run(7, log_every=0)
        assert res.resumed_from == 2
        assert _max_diff(ref._final_params, tr._final_params) == 0.0

    def test_int8_compression_trains_and_replays(self, tmp_path):
        a = tiny_trainer(str(tmp_path / "c1"), compression="int8")
        b = tiny_trainer(str(tmp_path / "c2"), compression="int8")
        ra, rb = a.run(6, log_every=0), b.run(6, log_every=0)
        assert np.isfinite(ra.losses).all() and ra.losses == rb.losses
        assert _max_diff(a._final_params, b._final_params) == 0.0

    def test_cli_runs_and_resumes(self, tmp_path, capsys, monkeypatch):
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        wd = str(tmp_path / "cli")
        args = ["--arch", "llama3-8b", "--reduced", "--steps", "4",
                "--batch", "2", "--seq", "16", "--workdir", wd,
                "--slot-every", "2", "--remat", "full", "--crash-at", "2"]
        train_mod.main(args)
        train_mod.main(args[:-2])
        out = capsys.readouterr().out
        assert "resumed_from=None" in out and "resumed_from=1" in out
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"

    def test_trainer_defaults_to_the_card(self, tmp_path):
        """Without use_device the trainer asks for the card, and raises on
        a host that has none; nothing carries on on the CPU by itself."""
        from repro_torch import device as device_mod
        saved, device_mod._selected = device_mod._selected, None
        try:
            if torch.cuda.is_available():
                assert repro_torch.get_device().type == "cuda"
            else:
                with pytest.raises(RuntimeError, match="use_device"):
                    tiny_trainer(str(tmp_path / "d"))
        finally:
            device_mod._selected = saved

"""Port vs reference, training across the ranks of a mesh: every leaf's
gradient, three train steps with their ADCC checksums, int8 compression,
and the ADCC trainer's crash / restart with slots that cross between the
packages.

What needs ranks runs once for the file: four spawned gloo ranks
(``torch_ranks.train_body``, joined within ``torch_ranks.TIMEOUT``, then
killed) beside one subprocess that runs ``repro`` on four forced host
devices (``train_mesh_reference.py``, within ``torch_ranks.REF_TIMEOUT``).
The cases (``torch_ranks.TRAIN_CASES``): reduced llama3-8b on 2 x 2 with
AdamW, reduced deepseek-v2-lite-16b on 1 x 4 with AdamW (its MoE layers on
the expert-parallel path, the backward through the all-to-alls, with
capacity drops), reduced mamba2-130m on 2 x 2 with Adafactor; weights from
``repro``'s ``init``, carried across by ``models.carry``; batches from the
shared counter-based pipeline.

Tolerances are the one-card twins' (tests/test_torch_train.py), float32
compute throughout: the loss within 1e-5 and each gradient leaf within
1e-5 of its largest value; per step loss and grad_norm within 1e-5
relative, checksums by ``torch_parity.assert_flat_checksums``, the
parameters after three steps within ``2 lr + 1e-6``. The sums run in
another order across ranks than on one device, which is all these allow
for. Values that move without arithmetic (gathered gradients and
parameters on every rank, the trainer's recovery) are held bit for bit.

The loss is vocab-parallel wherever "model" has more than one rank (every
case here): each rank's cross entropy reads its block of the vocabulary's
columns. Reduced llama3-8b at a vocabulary of 501 (padded to 512) on 2 x 2
and 1 x 4 (``torch_ranks.VOCAB_CASES``) splits it unevenly; no rank may
make a tensor of the padded vocabulary's width in the loss or its
backward, and ``lm.vocab_parallel_nll`` itself is held to the whole
vocabulary's cross entropy on 1 x 4 (1e-6), padded columns and labels of
-100 leaving it bit for bit unchanged.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
import torch_ranks as R
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import acc_state as ref_acc
from repro.core import slots as ref_slots
from repro.launch.steps import tree_checksums as ref_tree_checksums
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.optim import adamw as ref_adamw
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.models import get_config
from repro_torch.models.carry import tree_items
from torch_parity import assert_flat_checksums

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = [arch for arch, _, _ in R.TRAIN_CASES]
GRAD_CASES = ARCHS + [R.vocab_case(*c) for c in R.VOCAB_CASES]


def _inputs():
    flat = {}
    B, S = R.TRAIN_SHAPE
    for arch, _, _ in R.TRAIN_CASES:
        params, _ = ref_build_model(R.train_cfg(ref_get_config, arch)).init(
            jax.random.PRNGKey(0))
        for k, v in tree_items(jax.tree.map(np.asarray, params)):
            flat[f"{arch}/params/{k}"] = v
        pipe = SyntheticPipeline(R.train_cfg(get_config, arch), B, S, seed=3)
        for t in range(R.TRAIN_STEPS):
            for k, v in pipe.batch_at(t).items():
                flat[f"{arch}/batch{t}/{k}"] = v
    rng = np.random.default_rng(7)
    for vocab in sorted({v for _, v in R.VOCAB_CASES}):
        tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        labels[rng.random((B, S)) < 0.2] = -100
        labels[0, 0] = vocab - 1                 # the last true column
        flat[f"v{vocab}/batch0/tokens"] = tokens
        flat[f"v{vocab}/batch0/labels"] = labels
    return flat


def _write_reference_slot(wd):
    """repro's state of reduced llama3-8b after one AdamW update, as its
    slot and ledger record at ``REF_SLOT_STEP`` (the parameters
    returned)."""
    cfg = get_config("llama3-8b").reduced()
    api = ref_build_model(cfg)
    params, _ = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)
    upd, opt = ref_adamw.adamw_update(RefTrainConfig(), grads,
                                      ref_adamw.adamw_init(params), params)
    params = jax.tree.map(lambda p, u: p + u, params, upd)
    step = R.REF_SLOT_STEP
    ref_slots.SlotStore(os.path.join(wd, "slots"), 3).write_slot(
        0, step, ref_slots.flatten_state({"params": params, "opt": opt}))
    led = ref_acc.ChecksumLedger(os.path.join(wd, "ledger.jsonl"))
    led.append(ref_acc.LedgerRecord(
        step=step, rng_seed=0, cursor=[0, step + 1, 0],
        cks_params=ref_acc.flatten_checksums(ref_tree_checksums(params)),
        cks_opt=ref_acc.flatten_checksums(ref_tree_checksums(opt)),
        cks_updates=ref_acc.flatten_checksums(ref_tree_checksums(upd)),
        loss=0.0))
    led.close()
    return dict(tree_items(jax.tree.map(np.asarray, params)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's results, the reference's results, repro's
    slot parameters, the run directory)."""
    d = tmp_path_factory.mktemp("train_ranks")
    flat = _inputs()
    np.savez(d / "inputs.npz", **{k.replace("/", "__"): v
                                  for k, v in flat.items()})
    ref_slot = _write_reference_slot(str(d / "repro"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable,
                            os.path.join(HERE, "train_mesh_reference.py"),
                            str(d)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = R.run_world(R.train_body, str(d))
    finally:
        try:
            _, err = ref.communicate(timeout=R.REF_TIMEOUT)
        except subprocess.TimeoutExpired:
            ref.kill()
            ref.communicate()
            raise
    assert ref.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as z:
        want = {k.replace("__", "/"): z[k] for k in z.files}
    return flat, ranks, want, ref_slot, d


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        for k, v in get(r).items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


# ---------------------------------------------------------------------------
# gradients and train steps against repro on its mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GRAD_CASES)
def test_gradients_across_ranks_match_reference(runs, arch):
    """``info["value_and_grad"]`` across the ranks, every leaf's global
    gradient, against ``jax.grad`` of ``repro``'s ``loss_fn`` on the same
    mesh: a gradient never summed over "data", or summed once too often
    over "model", is off by a factor of 2 or 4. The vocab-parallel loss
    runs in every case; the ``VOCAB_CASES`` split a vocabulary of 501
    over 2 and 4 ranks, with labels of -100."""
    _, ranks, want, _, _ = runs
    got = ranks[0][f"grads/{arch}"]
    assert abs(got["loss"] - float(want[f"grads/{arch}/loss"])) <= 1e-5
    prefix = f"grads/{arch}/"
    paths = sorted(k[len(prefix):] for k in want
                   if k.startswith(prefix) and k != prefix + "loss")
    assert sorted(got["grads"]) == paths
    for path in paths:
        g = want[prefix + path]
        err = float(np.abs(got["grads"][path] - g).max())
        assert err <= 1e-5 * float(np.abs(g).max()), (path, err)
    _same_on_every_rank(ranks, lambda r: r[f"grads/{arch}"]["grads"])


@pytest.mark.parametrize("arch", GRAD_CASES)
def test_no_rank_makes_the_padded_vocabulary_wide(runs, arch):
    """At TP 2 and 4 no local operation of the loss and its backward on
    any rank makes a tensor whose last dim is the padded vocabulary's
    (each rank's logits and their float32 copies hold its block of the
    columns, ``padded_vocab / tp`` wide)."""
    for r in runs[1]:
        assert r[f"grads/{arch}"]["wide"] == []


def test_vocab_parallel_nll_ignores_labels_and_padding(runs):
    """``lm.vocab_parallel_nll`` on 1 x 4, a vocabulary of 501 padded to
    512: the mean and each rank's block of its gradient equal the whole
    vocabulary's cross entropy (``lm._nll_terms``) within 1e-6; padded
    columns of 1e4 instead of 0 change neither bit; the padded columns'
    gradient and every column's gradient in a row labelled -100 are 0
    on every rank (rank 0's column 0 among them)."""
    labels = runs[1][0]["ce/labels"]
    for r in runs[1]:
        assert r["ce/0.0/loss"] == r["ce/10000.0/loss"]
        np.testing.assert_array_equal(r["ce/0.0/grad"], r["ce/10000.0/grad"])
        assert abs(r["ce/0.0/loss"] - r["ce/ref/loss"]) <= 1e-6
        np.testing.assert_allclose(r["ce/0.0/grad"], r["ce/ref/grad"],
                                   rtol=0, atol=1e-6)
        grad = r["ce/0.0/grad"]
        assert not grad[labels == -100].any()
        pad = 501 - r["ce/lo"]
        assert pad >= grad.shape[-1] or not grad[..., max(pad, 0):].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_across_ranks_match_reference(runs, arch):
    """Three steps of ``build_train_step`` across the ranks against
    ``repro``'s on four devices: loss, grad_norm and the ADCC checksums
    of each step, the parameters after them (equal on every rank)."""
    _, ranks, want, _, _ = runs
    got = ranks[0][f"steps/{arch}"]
    optimizer = dict((a, o) for a, _, o in R.TRAIN_CASES)[arch]
    tcfg = R.train_tcfg(TrainConfig, optimizer)
    for t in range(R.TRAIN_STEPS):
        key = f"steps/{arch}/{t}"
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"{t}/{k}"],
                                       float(want[f"{key}/{k}"]), rtol=1e-5)
        assert_flat_checksums(got[f"{t}/checksums"],
                              {k: want[f"{key}/{k}"] for k in
                               ("params", "opt", "updates")}, tcfg, t + 1)
    prefix = f"steps/{arch}/params/"
    assert sorted(got["params"]) == sorted(k[len(prefix):] for k in want
                                           if k.startswith(prefix))
    for path, w in got["params"].items():
        np.testing.assert_allclose(w, want[prefix + path], rtol=0,
                                   atol=2 * tcfg.learning_rate + 1e-6)
    _same_on_every_rank(ranks, lambda r: r[f"steps/{arch}"]["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_is_placed_by_build_opt_shardings(runs, arch):
    """Every leaf of the optimizer state across ranks (AdamW's moments,
    Adafactor's stacked statistics) is placed as ``build_opt_shardings``
    says."""
    got = runs[1][0][f"steps/{arch}"]
    assert got["opt_placements"] == got["opt_want"]


def test_int8_across_ranks_matches_one_card(runs):
    """int8 compression on 2 x 2 against the port's one-card run, which
    draws the same noise (``repro`` draws its own with ``jax.random``):
    the global scale and the noise of the whole tensor, each rank taking
    its shard, give the one-card rounding, held by the same checksum
    tolerances."""
    flat, ranks, _, _, _ = runs
    with repro_torch.use_device("cpu"):
        one = R._steps("llama3-8b", None, "adamw", flat, compression="int8")
    got = ranks[0]["int8"]
    tcfg = R.train_tcfg(TrainConfig, "adamw", grad_compression="int8")
    for t in range(R.TRAIN_STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"{t}/{k}"], one[f"{t}/{k}"],
                                       rtol=1e-5)
        assert_flat_checksums(got[f"{t}/checksums"], one[f"{t}/checksums"],
                              tcfg, t + 1)
    for path, w in got["params"].items():
        np.testing.assert_allclose(w, one["params"][path], rtol=0,
                                   atol=2 * tcfg.learning_rate + 1e-6)


# ---------------------------------------------------------------------------
# the trainer across ranks
# ---------------------------------------------------------------------------

def test_crash_and_restart_across_ranks_is_bitwise(runs):
    """A crash after a slot, the newest slot torn by rank 0, and a restart
    on the same mesh: every rank rejects the torn slot, resumes from an
    older one, replays the losses, and ends with the uninterrupted run's
    parameters bit for bit."""
    ranks = runs[1]
    for r in ranks:
        assert r["crash/resumed_from"] is not None
        assert r["crash/resumed_from"] < r["crash/newest"]
        assert r["crash/checks"] == ranks[0]["crash/checks"]
        assert r["crash/checks"][-1][2] == 0
        assert r["crash/losses"] == \
            r["whole/losses"][r["crash/resumed_from"] + 1:]
        for path, w in r["whole/final"].items():
            np.testing.assert_array_equal(r["crash/final"][path], w)


def test_sync_mode_recovers_across_ranks_as_reference(runs):
    """Sync mode writes ledger records at slot steps only, so its chain
    stops after the first (ROADMAP's note on sync mode): the restart
    resumes from the first slot, in ``repro`` and the port alike."""
    assert {r["sync/resumed_from"] for r in runs[1]} == \
        {R.TRAINER["slot_every"] - 1}


def test_reference_reads_the_ranked_slot_and_ledger(runs):
    """The slots and ledger of the run across ranks (rank 0 wrote them,
    global arrays) pass ``repro``'s chain, ``unflatten_state`` and
    ``verify_state_against_record``; the newest holds the final
    parameters."""
    _, ranks, _, _, d = runs
    wd = str(d / "whole")
    recs = {r.step: r for r in ref_acc.ChecksumLedger(
        os.path.join(wd, "ledger.jsonl")).validated_records()}
    assert sorted(recs) == list(range(R.TRAINER_STEPS))
    store = ref_slots.SlotStore(os.path.join(wd, "slots"), 3)
    api = ref_build_model(get_config("llama3-8b").reduced())
    shapes, _ = api.abstract_init(jax.random.PRNGKey(0))
    template = {"params": shapes,
                "opt": jax.eval_shape(ref_adamw.adamw_init, shapes)}
    slots = store.slots_by_recency()
    assert [s for _, s in slots] == [7, 5, 3]
    for slot, step in slots:
        state = ref_slots.unflatten_state(template, store.read_slot(slot))
        assert ref_acc.verify_state_against_record(
            state["params"], state["opt"], recs[step]) == (True, 0)
        if step == R.TRAINER_STEPS - 1:
            for path, w in tree_items(state["params"]):
                np.testing.assert_array_equal(
                    np.asarray(w), ranks[0]["whole/final"][path])


def test_ranked_trainer_recovers_from_the_references_slot(runs):
    """``repro``'s slot and ledger record: every rank verifies it, places
    repro's exact parameters on the mesh and resumes after its step."""
    _, ranks, _, ref_slot, _ = runs
    for r in ranks:
        assert r["repro/resumed_from"] == R.REF_SLOT_STEP
        assert r["repro/report"].endswith("verified")
        for path, w in ref_slot.items():
            np.testing.assert_array_equal(r["repro/params"][path], w)

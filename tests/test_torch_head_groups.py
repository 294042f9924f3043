"""Port vs reference, attention across the ranks of a mesh whose TP degree
does not tile the query heads: ``g = gcd(H, tp)`` blocks of ``H / g``
heads, each computed by the ``tp / g`` ranks that hold its columns of
``wq`` (``layers.head_blocks``), as XLA splits ``repro``'s attention,
whose ``wq`` columns and ``wo`` rows are placed over "model" whatever the
heads.

What needs ranks runs once for the file: four spawned gloo ranks
(``torch_ranks.head_groups_body``, joined within ``torch_ranks.TIMEOUT``,
then killed) beside two subprocesses that run ``repro``
(``mesh_reference.py``): ``heads`` on four forced host devices, ``pin16``
on sixteen. The cases (``torch_ranks.HEAD_CASES``): reduced phi4-mini-3.8b
with 6 query heads over 2 KV heads (a block of 3 heads reads one KV
group) and reduced qwen2-vl-2b with 6 over 1 (a block is half of the one
group), on 1 x 4 (2 blocks of 3 heads, 2 ranks a block) and 2 x 2 (the
heads tile: each rank is a block); and 6 over 3 on 1 x 4, whose block of
3 heads spans 1.5 KV groups: each query head there reads its own KV head
(``layers.block_kv``). Weights from ``repro``'s ``init``, batches from
its ``make_batch``.

Tolerances are those of the other files across ranks, float32 compute:
forwards and decode steps 1e-4, the loss 1e-5 and each gradient leaf
within 1e-5 of its largest value (a ``wq`` gradient counted on both ranks
of its block would be off by a factor of 2), three AdamW steps by
``torch_parity.assert_flat_checksums`` and their parameters within
``2 lr + 1e-6``. The heads each rank scores are pinned to the heads of
the score ``dot`` in ``repro``'s compiled program per device, at 1 x 4
and at 1 x 16 (phi4-mini-3.8b's 24 over 8 and qwen2-vl-2b's 12 over 2,
one narrow layer; the port's 16 ranks each on a fake process group of
its own, its collectives moving nothing, as in the dry run).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro_torch
import torch_ranks as R
from repro.launch.specs import make_batch as ref_make_batch
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import make_batch
from repro_torch.models import build_model, get_config, layers
from repro_torch.models.carry import tree_items
from torch_parity import assert_flat_checksums

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_TOL = 1e-4
CASES = [(name, m) for name, _, _, _ in R.HEAD_CASES for m in R.MESHES]
IDS = [f"{name}-{m}" for name, m in CASES]


def _inputs():
    flat = {}
    B, S = R.HEAD_SHAPE
    for name, arch, H, KV in R.HEAD_CASES + (R.HEAD_KV3,):
        cfg = R.head_cfg(ref_get_config, arch, H, KV)
        params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
        for k, v in tree_items(jax.tree.map(np.asarray, params)):
            flat[f"{name}/params/{k}"] = v
        for t in range(R.TRAIN_STEPS):
            batch = ref_make_batch(cfg, B, S, jax.random.PRNGKey(10 + t))
            for k, v in batch.items():
                flat[f"{name}/batch{t}/{k}"] = np.asarray(v)
    return flat


def _reference(d, mode):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable,
                             os.path.join(HERE, "mesh_reference.py"), str(d),
                             mode], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(ref):
    try:
        _, err = ref.communicate(timeout=R.REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, err[-3000:]


def _load(d, mode):
    with np.load(d / f"{mode}.npz") as z:
        want = {k.replace("__", "/"): z[k] for k in z.files}
    with open(d / f"{mode}.json") as fh:
        want["meta"] = json.load(fh)
    return want


def _wide_heads():
    """Each of the port's 16 ranks' scored heads in ``HEAD_WIDE``'s
    forwards at 1 x 16, rank by rank on a fake process group of 16."""
    B, S = R.HEAD_SHAPE
    out = {}
    with repro_torch.use_device("cpu"):
        for name, arch, H, KV in R.HEAD_WIDE:
            cfg = R.wide_cfg(get_config, arch, H, KV)
            api = build_model(cfg)
            lm = api.init(torch.Generator().manual_seed(0))
            batch = make_batch(cfg, B, S, torch.Generator().manual_seed(1))
            batch.pop("labels")
            out[name] = []
            for rank in range(R.HEAD_WIDE_TP):
                dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                        world_size=R.HEAD_WIDE_TP)
                try:
                    mesh = make_mesh((1, R.HEAD_WIDE_TP), ("data", "model"))
                    with torch.no_grad(), R.scored_heads() as heads:
                        api.forward(lm, batch, mesh)
                    out[name].append(heads)
                finally:
                    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the reference's on 4 devices, its pin on 16,
    the port's 16 ranks' heads at 1 x 16)."""
    d = tmp_path_factory.mktemp("head_groups")
    flat = _inputs()
    np.savez(d / "inputs.npz", **{k.replace("/", "__"): v
                                  for k, v in flat.items()})
    refs = {mode: _reference(d, mode) for mode in ("heads", "pin16")}
    try:
        ranks = R.run_world(R.head_groups_body, str(d))
        wide = _wide_heads()
    finally:
        for ref in refs.values():
            _wait(ref)
    return ranks, _load(d, "heads"), _load(d, "pin16"), wide


# ---------------------------------------------------------------------------
# the split (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,tp,blocks", [
    (32, 8, 16, 16), (24, 8, 16, 8), (12, 2, 16, 4), (40, 8, 16, 8),
    (48, 8, 16, 16), (6, 2, 4, 2), (6, 1, 4, 2), (6, 3, 4, 2), (10, 2, 4, 2),
    (6, 2, 2, 2)])
def test_head_blocks_are_the_measured_split(H, KV, tp, blocks):
    """``gcd(H, tp)`` blocks of ``H / gcd`` heads: the per-device heads of
    ``repro``'s compiled score ``dot`` measured at 1 x 16 and 1 x 4 (40
    heads over 16 devices: 5 a device, 48: 3). Where the heads tile, each
    rank is a block of its own and nothing of the split changes."""
    g, m = layers.head_blocks(H, tp)
    assert (g, m, H // g) == (blocks, tp // blocks, H // blocks)
    if layers.heads_tile(H, KV, tp):
        assert m == 1


@pytest.mark.parametrize("H,KV", [(6, 2), (6, 1), (6, 3), (12, 3), (8, 2)])
def test_block_kv_gives_each_query_head_its_kv_head(H, KV):
    """Every block's KV heads, repeated to its query heads as ``_sdpa``
    repeats them (or one per query head where the block spans part of a
    KV group), are the KV head each query head reads, ``h // (H / KV)``."""
    k = torch.arange(KV, dtype=torch.float32).reshape(1, 1, KV, 1)
    for g in (1, 2, 3, 6):
        if H % g:
            continue
        for b in range(g):
            got = layers.block_kv(k, H, g, b)
            n = H // g
            got = torch.repeat_interleave(got, n // got.shape[2], dim=2)
            want = [h // (H // KV) for h in range(b * n, (b + 1) * n)]
            assert got.flatten().tolist() == want, (g, b)


@pytest.mark.parametrize("arch", ["llama3-8b", "phi4-mini-3.8b",
                                  "qwen2-vl-2b", "zamba2-1.2b"])
def test_attention_splits_as_reference_places_wq(arch):
    """At the production TP of 16 ``wq`` / ``wo`` split in every forward,
    as ``repro`` places ``"qheads"`` over "model"; the decode step splits
    them only where the heads tile, and keeps them whole otherwise (the
    reference's ``replicate_attn_heads``)."""
    cfg = get_config(arch)
    p = layers.Attention(cfg, device="meta")
    tile = layers.heads_tile(cfg.n_heads, cfg.n_kv_heads, 16)
    assert p.splits(16)
    assert p.splits(16, decode=True) == tile
    assert tile == (arch not in ("phi4-mini-3.8b", "qwen2-vl-2b"))


# ---------------------------------------------------------------------------
# across ranks against repro on its mesh
# ---------------------------------------------------------------------------

def _hold(got, want, key, what):
    for r, g in enumerate(got):
        block = want[f"{key}/{what}/{r}"]
        assert g[key][what].shape == block.shape, (r, what)
        np.testing.assert_allclose(g[key][what], block, rtol=0, atol=FWD_TOL,
                                   err_msg=f"{what}, rank {r}")


@pytest.mark.parametrize("name,mesh", CASES + [("kv3", "1x4")],
                         ids=IDS + ["kv3-1x4"])
def test_forward_and_decode_match_reference(runs, name, mesh):
    """Each rank's logits of the forward and of three decode steps are
    ``repro``'s shard on the device at its mesh coordinate (forward
    jitted with the dry run's ``in_shardings``, decode through
    ``build_serve_step``), within 1e-4."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    _hold(ranks, want, key, "forward")
    _hold(ranks, want, key, "decode")


@pytest.mark.parametrize("name,mesh", CASES + [("kv3", "1x4")],
                         ids=IDS + ["kv3-1x4"])
def test_ranks_score_the_heads_reference_devices_score(runs, name, mesh):
    """Every score of every rank's forward holds the heads of ``repro``'s
    compiled score ``dot`` per device: 3 at 1 x 4 (a block of 3 heads on
    2 ranks, not all 6) and at 2 x 2 (each rank's own 3)."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    ref = set(want["meta"][f"{key}/heads"])
    assert ref == {3}
    n_layers = get_config("phi4-mini-3.8b").reduced().n_layers
    for r in ranks:
        assert r[key]["heads"] == [3] * n_layers


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_training_scores_the_heads_reference_devices_score(runs, name,
                                                           mesh):
    """The scores of the gradient across the ranks hold the heads of every
    score ``dot`` (forward and backward) in ``repro``'s compiled train
    step per device."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    assert set(want["meta"][f"{key}/train_heads"]) == {3}
    for r in ranks:
        assert r[f"{key}/grads"]["heads"]
        assert set(r[f"{key}/grads"]["heads"]) == {3}


@pytest.mark.parametrize("name", [n for n, _, _, _ in R.HEAD_WIDE])
def test_wide_ranks_score_the_heads_reference_devices_score(runs, name):
    """At 1 x 16, phi4-mini-3.8b's 24 heads over 8 KV heads and
    qwen2-vl-2b's 12 over 2: each of the port's 16 ranks scores the heads
    of ``repro``'s compiled score ``dot`` per device, 3 (8 and 4 blocks of
    3 heads, 2 and 4 ranks a block)."""
    _, _, pin, wide = runs
    ref = set(pin["meta"][f"{name}/heads"])
    assert ref == {3}
    assert [set(h) for h in wide[name]] == [ref] * R.HEAD_WIDE_TP


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_gradients_match_reference(runs, name, mesh):
    """``info["value_and_grad"]`` across the ranks, every leaf's global
    gradient, against ``jax.grad`` of ``repro``'s ``loss_fn`` on the same
    mesh, equal on every rank. The weights are DTensors placed by the
    partition rules, and no parameter is read whole
    (``DTensor.full_tensor``): a rank gathers its block's columns of
    ``wq`` from its block's ranks alone. No rank makes a tensor of the
    padded vocabulary's width."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    got = ranks[0][f"{key}/grads"]
    assert abs(got["loss"] - float(want[f"{key}/grads/loss"])) <= 1e-5
    prefix = f"{key}/grads/"
    paths = sorted(k[len(prefix):] for k in want
                   if k.startswith(prefix) and k != prefix + "loss")
    assert sorted(got["grads"]) == paths
    for path in paths:
        g = want[prefix + path]
        err = float(np.abs(got["grads"][path] - g).max())
        assert err <= 1e-5 * float(np.abs(g).max()), (path, err)
    for r in ranks:
        assert r[f"{key}/grads"]["wide"] == []
        assert r[f"{key}/grads"]["whole_reads"] == []
        for path, g in r[f"{key}/grads"]["grads"].items():
            np.testing.assert_array_equal(g, got["grads"][path])


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_three_train_steps_match_reference(runs, name, mesh):
    """Three AdamW steps of ``build_train_step`` across the ranks against
    ``repro``'s on four devices: loss, grad_norm and the ADCC checksums of
    each step, the parameters after them (equal on every rank)."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    got = ranks[0][f"{key}/steps"]
    tcfg = R.train_tcfg(TrainConfig, "adamw")
    for t in range(R.TRAIN_STEPS):
        w = f"{key}/steps/{t}"
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"{t}/{k}"],
                                       float(want[f"{w}/{k}"]), rtol=1e-5)
        assert_flat_checksums(got[f"{t}/checksums"],
                              {k: want[f"{w}/{k}"] for k in
                               ("params", "opt", "updates")}, tcfg, t + 1)
    prefix = f"{key}/steps/params/"
    assert sorted(got["params"]) == sorted(k[len(prefix):] for k in want
                                           if k.startswith(prefix))
    for path, w in got["params"].items():
        np.testing.assert_allclose(w, want[prefix + path], rtol=0,
                                   atol=2 * tcfg.learning_rate + 1e-6)
    for r in ranks[1:]:
        for path, w in r[f"{key}/steps"]["params"].items():
            np.testing.assert_array_equal(w, got["params"][path])

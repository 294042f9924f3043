"""Port vs reference, sharding and serving across ranks: the partition
rules (``repro_torch.sharding.partition``), the parameters' logical-axes
tree (``models.carry.param_axes``), the GPipe schedule
(``sharding.pipeline``), ``layers.shard_act`` / ``gather_weights``, the
grouped GEMM forms, the expert-parallel MoE, tensor-parallel flash
attention, reduced llama3-8b, kimi-k2, mamba2-130m and zamba2-1.2b
forwards and decode steps on 2 x 2 and 1 x 4 (each rank's logits the
block ``repro`` places on the device at its mesh coordinate, with
llama3-8b's vocabulary also at 501 and 504), the optimizer-state
placements and the elastic restore.

What needs ranks runs once per file: four spawned gloo ranks
(``torch_ranks.sharding_body``, joined within ``torch_ranks.TIMEOUT`` =
300 s, then killed) beside one subprocess that runs ``repro`` on four
forced host devices (``mesh_reference.py``). Weights come from
``repro``'s ``init``; tokens and activations from numpy seeds.

Tolerances: float32 throughout. The MoE and TP attention outputs 1e-5
(summation order only: the routing and the drops are the same decisions,
held exactly); the model forwards and decode steps 1e-4, as the
one-card forwards of ``test_torch_models.py`` / ``test_torch_moe.py``.
The GPipe schedule, placed weights and restored checkpoints move values
without arithmetic and are held bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro_torch
import torch_ranks as R
from repro.checkpoint.manager import save_checkpoint as ref_save_checkpoint
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.launch.mesh import single_device_mesh as ref_single_device_mesh
from repro.launch.steps import build_opt_shardings as ref_build_opt_shardings
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.sharding import partition as ref_partition
from repro_torch.checkpoint.manager import save_checkpoint
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.steps import build_opt_shardings
from repro_torch.models import build_model, get_config, layers, list_archs
from repro_torch.models import moe
from repro_torch.models.carry import param_axes, tree_items
from repro_torch.sharding import partition
from repro_torch.sharding.pipeline import stage_params

HERE = os.path.dirname(os.path.abspath(__file__))
MOE_TOL = 1e-5
FWD_TOL = 1e-4
FLAGS = [{}, {"fsdp": False}, {"sp": True}, {"shard_cache_seq": True},
         {"shard_ssm_heads": True}, {"replicate_attn_heads": True},
         {"kv_cache_heads_shardable": True}]
AXES = {"dp-tp": ("data", "model"), "pod": ("pod", "data", "model")}


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _f32(arch):
    return dataclasses.replace(ref_get_config(arch).reduced(),
                               compute_dtype="float32")


def _ref_axes(cfg):
    box = {}

    def params_only(k):
        p, a = ref_build_model(cfg).init(k)
        box["a"] = a
        return p

    jax.eval_shape(params_only, jax.random.PRNGKey(0))
    return box["a"]


def _flash_shape_cfg(H, KV):
    return types.SimpleNamespace(n_heads=H, n_kv_heads=KV)


# ---------------------------------------------------------------------------
# the inputs, both packages' runs across ranks (once for the file)
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    flat = {}
    cfg = _f32("kimi-k2-1t-a32b")
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    for n in sorted({n for _, n in R.MOE_CASES}, reverse=True):
        flat[f"moe/x{n}"] = rng.normal(size=(n, D)).astype(f32)
    router = rng.normal(size=(D, E)).astype(f32) * 0.02
    # most tokens to experts 0 and 1, which one "model" rank owns: the
    # config's capacity then drops
    router[:, :2] += 0.5 * np.sign(flat["moe/x64"].mean(0))[:, None]
    flat["moe/router"] = router
    for k, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)),
                     ("w_down", (E, F, D))):
        flat[f"moe/{k}"] = rng.normal(size=shape).astype(f32) * 0.05
    B, S, hd = R.FLASH_SHAPE
    for name, (shape, axes) in R.MESHES.items():
        for H, KV in R.FLASH_HEADS:
            if not ref_layers.flash_applicable(_flash_shape_cfg(H, KV), H, S,
                                               Mesh(axes, shape)):
                continue
            key = f"flash/{name}/{H}x{KV}"
            flat[f"{key}/q"] = rng.normal(size=(B, S, H, hd)).astype(f32)
            for t in ("k", "v"):
                flat[f"{key}/{t}"] = rng.normal(size=(B, S, KV, hd)).astype(f32)
    B, S = R.FORWARD_SHAPE
    for arch in R.FORWARD_ARCHS:
        cfg = _f32(arch)
        params = ref_build_model(cfg).init(jax.random.PRNGKey(0))[0]
        for k, v in tree_items(jax.tree.map(np.asarray, params)):
            flat[f"{arch}/params/{k}"] = v
        flat[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    L, D, n_micro, mb = R.PIPE_SHAPE
    prng = np.random.default_rng(0)
    flat["pipe/W"] = (prng.normal(size=(L, D, D)) * 0.3).astype(f32)
    flat["pipe/x"] = prng.normal(size=(n_micro, mb, D)).astype(f32)
    return flat


def _write_checkpoints(d, flat):
    state = {k[len("llama3-8b/params/"):]: v for k, v in flat.items()
             if k.startswith("llama3-8b/params/")}
    from repro_torch.models.carry import nest
    save_checkpoint(str(d / "ckpt_port"),
                    nest({k: torch.from_numpy(np.array(v)) for k, v in state.items()}),
                    step=5)
    ref_save_checkpoint(str(d / "ckpt_repro"),
                        nest({k: jnp.asarray(v) for k, v in state.items()}),
                        step=7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's results, the reference's results)."""
    d = tmp_path_factory.mktemp("ranks")
    flat = _inputs()
    np.savez(d / "inputs.npz", **{k.replace("/", "__"): v
                                  for k, v in flat.items()})
    _write_checkpoints(d, flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, os.path.join(HERE,
                                                         "mesh_reference.py"),
                            str(d)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = R.run_world(R.sharding_body, str(d))
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
    with open(d / "ref.json") as fh:
        want["meta"] = json.load(fh)
    return flat, ranks, want


# ---------------------------------------------------------------------------
# partition rules and the logical-axes tree (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_match_reference(arch):
    assert param_axes(get_config(arch).reduced()) == \
        _ref_axes(ref_get_config(arch).reduced())


def _ref_batch(cfg):
    """A batch of ``repro``'s builder: the vlm one holds the (3, B, S)
    ``positions`` leaf."""
    if cfg.family == "vlm":
        from repro.launch import specs as ref_specs
        return ref_specs.make_batch(cfg, 2, 64, jax.random.PRNGKey(1))
    return {"tokens": np.zeros((2, 8), np.int32),
            "labels": np.zeros((2, 8), np.int32)}


def _placements_of(spec, axis_names):
    """The placements a reference spec means, one per mesh axis."""
    out = []
    for a in axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("mesh_axes", sorted(AXES))
@pytest.mark.parametrize("arch", list_archs())
def test_partition_specs_match_reference(arch, mesh_axes):
    """Every leaf of the parameters' and the cache's axes trees, under
    every flag of ``make_rules``, and the batch leaves (the vlm
    ``positions`` leaf (3, B, S) with batch on dim 1)."""
    axes = AXES[mesh_axes]
    layout = Mesh(axes, (2,) * len(axes))
    ref_mesh = ref_single_device_mesh(axes)
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    trees = [param_axes(cfg)]
    api = build_model(cfg)
    if api.init_cache is not None:
        trees.append(api.init_cache(2, 4)[1])
    for flags in FLAGS:
        rules = partition.make_rules(layout, **flags)
        ref_rules = ref_partition.make_rules(ref_mesh, **flags)
        for tree in trees:
            specs = dict(tree_items(partition.logical_to_spec(rules, tree)))
            placed = dict(tree_items(partition.params_shardings(rules, tree)))
            for path, ax in tree_items(tree):
                want = tuple(ref_rules.spec(ax))
                assert specs[path] == want, (path, flags)
                assert placed[path] == _placements_of(want, axes), path
        batch = {k: torch.from_numpy(np.array(v)) for k, v in
                 _ref_batch(ref_cfg).items()}
        ref_sh = ref_partition.batch_shardings(
            ref_rules, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        got = partition.batch_shardings(rules, batch)
        for k in batch:
            assert got[k] == _placements_of(tuple(ref_sh[k].spec), axes), k


def test_production_mesh_layouts():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.size) == (("data", "model"), 256)
    assert (two.axis_names, two.shape) == (("pod", "data", "model"),
                                           {"pod": 2, "data": 16,
                                            "model": 16})


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b"])
def test_opt_shardings_match_reference(arch, optimizer):
    """AdamW moments mirror their parameter; Adafactor's statistics drop
    the reduced dim; the step is replicated."""
    cfg = get_config(arch).reduced()
    axes = AXES["dp-tp"]
    rules = partition.make_rules(Mesh(axes, (2, 2)))
    ref_rules = ref_partition.make_rules(ref_single_device_mesh(axes))
    ax = param_axes(cfg)
    got = build_opt_shardings(TrainConfig(optimizer=optimizer), rules,
                              partition.params_shardings(rules, ax), ax)
    want = ref_build_opt_shardings(
        RefTrainConfig(optimizer=optimizer), ref_rules,
        ref_partition.params_shardings(ref_rules, ax), ax)
    got_items = list(tree_items(got))
    want_items = list(tree_items(jax.tree.map(
        lambda s: _placements_of(tuple(s.spec), axes), want,
        is_leaf=lambda s: hasattr(s, "spec"))))
    assert [p for p, _ in got_items] == [p for p, _ in want_items]
    for (path, g), (_, w) in zip(got_items, want_items):
        assert g == w, path


# ---------------------------------------------------------------------------
# shard_act / gather_weights (twins of TestShardAct)
# ---------------------------------------------------------------------------

def test_shard_act_noop_without_mesh():
    x = torch.ones((4, 8, 16))
    assert layers.shard_act(x, None) is x
    assert layers.shard_act(x, Mesh(("data", "model"), (1, 1))) is x


def test_shard_act_applies_on_named_mesh(runs):
    _, ranks, _ = runs
    r = ranks[0]
    assert r["shard_act/placements"] == ("Shard(dim=0)", "Replicate()")
    assert r["shard_act/local_shape"] == (2, 8, 16)
    np.testing.assert_array_equal(
        r["shard_act/values"], np.arange(4 * 8 * 16.).reshape(4, 8, 16))
    assert r["shard_act/plain_is_same"]


def test_shard_act_skips_unshardable_batch(runs):
    assert runs[1][0]["shard_act/batch1"] == ("Replicate()", "Replicate()")


def test_gather_weights_keeps_tp_only(runs):
    """An FSDP x TP weight ("embed", "mlp") is gathered over "data" and
    stays split over "model", values unchanged."""
    r = runs[1][0]
    assert r["gather/placements"] == ("Replicate()", "Shard(dim=1)")
    np.testing.assert_array_equal(r["gather/values"],
                                  np.arange(8 * 16.).reshape(8, 16))


# ---------------------------------------------------------------------------
# GPipe (twins of tests/test_pipeline.py)
# ---------------------------------------------------------------------------

def _sequential(W, x):
    """Every layer on each microbatch in turn (the stages' own shapes)."""
    out = []
    for h in torch.from_numpy(x):
        for w in torch.from_numpy(W):
            h = torch.tanh(h @ w)
        out.append(h)
    return torch.stack(out).numpy()


def test_stage_params_split():
    W = torch.arange(24.0).reshape(8, 3)
    s = stage_params(W, 4)
    assert s.shape == (4, 2, 3)
    assert torch.equal(s[1, 0], W[2])
    t = stage_params({"a": {"w": W}}, 2)
    assert t["a"]["w"].shape == (2, 4, 3)
    with pytest.raises(ValueError, match="stages"):
        stage_params(W, 3)


def test_single_stage_identity(runs):
    flat, ranks, _ = runs
    want = _sequential(flat["pipe/W"], flat["pipe/x"])
    for r in ranks:
        np.testing.assert_array_equal(r["pipe/one"], want)


def test_four_stage_matches_sequential(runs):
    """Bit for bit against the sequential run on every rank, and against
    ``repro``'s four-stage schedule within float32 rounding of tanh."""
    flat, ranks, want = runs
    seq = _sequential(flat["pipe/W"], flat["pipe/x"])
    for r in ranks:
        np.testing.assert_array_equal(r["pipe/four"], seq)
    np.testing.assert_allclose(ranks[0]["pipe/four"], want["pipe/four"],
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# grouped GEMM (twins of TestGroupedGemm)
# ---------------------------------------------------------------------------

def test_capacity_drop_zeroes_overflow():
    rng = np.random.default_rng(0)
    e, d, f = 2, 8, 8
    gs = torch.tensor([30, 2])
    x = torch.from_numpy(rng.normal(size=(32, d)).astype(np.float32))
    w = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    got = moe._local_expert_ffn(x, gs, w(e, d, f), w(e, d, f), w(e, f, d),
                                block_factor=1.0)
    # cap = 16: rows 16..29 of group 0 are dropped -> exactly zero
    assert bool(torch.all(got[16:30] == 0.0))
    assert bool(torch.any(got[:16] != 0.0))


def _grouped_case(seed):
    rng = np.random.default_rng(seed)
    r, e = int(rng.integers(8, 97)), int(rng.integers(1, 7))
    d, f = int(rng.integers(4, 25)), int(rng.integers(4, 25))
    gs = rng.multinomial(r, np.ones(e) / e).astype(np.int32)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    return gs, arr(r, d), arr(e, d, f), arr(e, d, f), arr(e, f, d)


@pytest.mark.parametrize("seed", range(6))
def test_scan_grouped_matches_ragged(seed):
    """The equal-capacity windows (block factor ``e``: nothing dropped)
    against the ragged form, and the port's ragged form against the
    reference's. Both products sum a row of d, then f, terms of unit
    normal values in another order, so they agree to float32 rounding
    of the output's scale: ``1e-5 * max|out|`` (per-row errors ~1e-6
    relative)."""
    gs, x, wg, wu, wd = _grouped_case(seed)
    t = lambda a: torch.from_numpy(a)
    ragged = moe._local_expert_ffn_ragged(t(x), t(gs), t(wg), t(wu), t(wd))
    scan = moe._local_expert_ffn(t(x), t(gs), t(wg), t(wu), t(wd),
                                 block_factor=float(len(gs)))
    want = np.asarray(ref_moe._local_expert_ffn_ragged(
        jnp.asarray(x), jnp.asarray(gs), wg, wu, wd))
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(scan.numpy(), ragged.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(ragged.numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# expert-parallel MoE across ranks
# ---------------------------------------------------------------------------

def _dense_oracle(flat, n):
    """``repro``'s dense path on the MoE cases' weights and tokens."""
    p = {k: jnp.asarray(flat[f"moe/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    return np.asarray(ref_moe.moe_apply_dense(
        _f32("kimi-k2-1t-a32b"), p, jnp.asarray(flat[f"moe/x{n}"])))


@pytest.mark.parametrize("mesh,n", R.MOE_CASES)
def test_moe_apply_ep_matches_reference_with_drops(runs, mesh, n):
    """At the config's capacity (1.25): equal to ``repro``'s on its mesh
    within 1e-5, with the same tokens dropped whole (exact zeros), placed
    as its input (rows over "data"), and equal on every rank."""
    _, ranks, want = runs
    key = f"moe/{mesh}/{n}/cfg"
    got, ref = ranks[0][key], want[key]
    np.testing.assert_allclose(got, ref, rtol=0, atol=MOE_TOL)
    zero = (ref == 0).all(axis=1)
    np.testing.assert_array_equal((got == 0).all(axis=1), zero)
    assert ranks[0][key + "/placements"] == ("Shard(dim=0)", "Replicate()")
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], got)
    assert sum(r[key + "/dropped"] for r in ranks) > 0
    dense = _dense_oracle(runs[0], n)
    assert np.abs(got - dense).max() > 10 * MOE_TOL     # drops changed it


@pytest.mark.parametrize("mesh,n", R.MOE_CASES)
def test_moe_apply_ep_equals_dense_at_generous_capacity(runs, mesh, n):
    """With room for every assignment: ``repro``'s dense oracle
    (``src/repro/models/moe.py:20-22``) within 1e-5, nothing dropped."""
    flat, ranks, _ = runs
    key = f"moe/{mesh}/{n}/generous"
    assert sum(r[key + "/dropped"] for r in ranks) == 0
    np.testing.assert_allclose(ranks[0][key], _dense_oracle(flat, n),
                               rtol=0, atol=MOE_TOL)


def test_one_card_ep_is_the_body_at_ep_1():
    """On one card ``moe_apply_ep`` is ``ep_body`` with identity
    all-to-alls, bit for bit."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              compute_dtype="float32")
    m = moe.MoE(cfg, device="cpu")
    m.init_(torch.Generator().manual_seed(0))
    x = torch.randn(48, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    got = moe.moe_apply_ep(cfg, m, x, Mesh(("data", "model"), (1, 1)))
    body = moe.ep_body(cfg, m, x, 0, 1, moe.ep_capacity(cfg, 48, 1),
                       lambda t: t)
    assert torch.equal(got, body)


# ---------------------------------------------------------------------------
# tensor-parallel flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("H,KV", [(8, 2), (12, 2), (6, 1), (4, 4), (24, 4)])
def test_flash_applicable_matches_reference(H, KV, tp):
    shape = _flash_shape_cfg(H, KV)
    for S in (16, 12):
        layout = Mesh(("data", "model"), (1, tp))
        assert layers.flash_applicable(shape, H, S, layout) == \
            ref_layers.flash_applicable(shape, H, S, layout)


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("H,KV", R.FLASH_HEADS)
def test_tp_flash_matches_reference(runs, mesh, H, KV):
    """Each rank's query heads through the kernel's plain version on its
    KV slice, gathered: ``repro``'s forward on its mesh (Pallas interpret
    mode) within 1e-5, equal on every rank. Where the heads do not tile
    (6 query heads over 4 ranks) neither package takes the branch."""
    flat, ranks, want = runs
    key = f"flash/{mesh}/{H}x{KV}"
    if key + "/q" not in flat:
        assert key not in ranks[0] and key not in want
        assert not layers.flash_applicable(
            _flash_shape_cfg(H, KV), H, R.FLASH_SHAPE[1],
            Mesh(*reversed(R.MESHES[mesh])))
        return
    np.testing.assert_allclose(ranks[0][key], want[key], rtol=0, atol=MOE_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


# ---------------------------------------------------------------------------
# whole models on the 2 x 2 mesh
# ---------------------------------------------------------------------------

# the 2 x 2 cases at the configs' vocabulary keep the arch as their id
LOGITS_IDS = [a if (m, v) == ("2x2", None) else
              R.logits_key(m, a, v)[len("logits/"):].replace("/", "-")
              for m, a, v in R.LOGITS_CASES]


def _hold_blocks(runs, case, what):
    """Each rank's local logits against the shard ``repro`` places on the
    device at the same mesh coordinate: the same shape, within 1e-4."""
    _, ranks, want = runs
    key = R.logits_key(*case)
    for r, got in enumerate(ranks):
        block = want[f"{key}/{what}/{r}"]
        assert got[f"{key}/{what}"].shape == block.shape, r
        np.testing.assert_allclose(got[f"{key}/{what}"], block, rtol=0,
                                   atol=FWD_TOL, err_msg=f"rank {r}")
    return want["meta"][f"{key}/{what}"], ranks[0]


@pytest.mark.parametrize("case", R.LOGITS_CASES, ids=LOGITS_IDS)
def test_forward_matches_reference_on_2x2(runs, case):
    """Flash prefill (TP heads), EP MoE (kimi-k2), rows over "data", on
    2 x 2 and 1 x 4: each rank's logits are ``repro``'s shard on the
    device at its mesh coordinate (its forward jitted with the dry run's
    ``in_shardings``, XLA's propagated placement): rows split over
    "data", the vocabulary split over "model" where 2 or 4 divides it
    (504: in blocks of 252 or 126, not the padded 256 or 128) and whole
    where it does not (501: ``P('data',)``)."""
    name, arch, vocab = case
    meta, r0 = _hold_blocks(runs, case, "forward")
    dp, tp = R.MESHES[name][0]
    key = R.logits_key(*case)
    if vocab == 501:
        assert meta["spec"] in ("PartitionSpec('data',)", "PartitionSpec()")
        assert r0[f"{key}/forward"].shape == (4 // dp, 16, 501)
    else:
        assert "'model'" in meta["spec"]
        assert r0[f"{key}/forward"].shape[-1] == (vocab or 512) // tp
    assert r0[f"{key}/placements"][1] == (
        "Shard(dim=2)" if vocab != 501 else "Replicate()")


@pytest.mark.parametrize("case", R.LOGITS_CASES, ids=LOGITS_IDS)
def test_decode_matches_reference_on_2x2(runs, case):
    """Three decode steps from an empty cache (kimi-k2: 4 tokens a step
    through the EP MoE on 4 ranks; the recurrent families' states and the
    hybrid's shared-block cache by rows), on 2 x 2 and 1 x 4: each rank's
    logits of every step are the shard of ``repro``'s ``build_serve_step``
    output (``P(dp, None, "model" if vocab % tp == 0 else None)``) on the
    device at its mesh coordinate."""
    name, arch, vocab = case
    meta, r0 = _hold_blocks(runs, case, "decode")
    tp = R.MESHES[name][0][1]
    key = R.logits_key(*case)
    want = "None" if (vocab or 512) % tp else "'model'"
    assert meta["spec"].endswith(f"None, {want})")
    assert r0[f"{key}/decode_placements"][1] == (
        "Shard(dim=2)" if want == "'model'" else "Replicate()")


@pytest.mark.parametrize("arch", R.FORWARD_ARCHS)
def test_serve_step_across_ranks_is_the_decode_step(runs, arch):
    """``build_serve_step`` on the mesh: its step is the decode step (the
    first one, bit for bit, in every rank's block of the placed logits),
    and its info holds the placements of the parameters and the cache."""
    key = R.logits_key("2x2", arch)
    for rank, r in enumerate(runs[1]):
        np.testing.assert_array_equal(r[f"{key}/serve_step"],
                                      r[f"{key}/decode"][0],
                                      err_msg=f"rank {rank}")
        assert r[f"{key}/serve_info"] == ["axes", "cache", "cache_axes",
                                          "cache_shapes", "params"]


@pytest.mark.parametrize("arch", R.FORWARD_ARCHS)
def test_forward_with_placed_weights_is_bitwise(runs, arch):
    """Weights as DTensors placed by the partition rules (FSDP x TP),
    gathered layer by layer: the same logits as plain weights, bit for
    bit, in every rank's block of the placed logits."""
    key = R.logits_key("2x2", arch)
    for rank, r in enumerate(runs[1]):
        np.testing.assert_array_equal(r[f"{key}/forward_dtensor"],
                                      r[f"{key}/forward"],
                                      err_msg=f"rank {rank}")


def test_training_across_ranks_gives_the_reference_loss(runs):
    """On 2 x 2, ``api.loss_fn`` on placed weights and the first step of
    ``build_train_step`` run across the ranks and give the loss of
    ``repro``'s ``loss_fn`` on its mesh within 1e-5, on every rank."""
    _, ranks, want = runs
    for r in ranks:
        for k in ("train/loss_fn", "train/step_loss"):
            assert abs(r[k] - float(want["train/loss_fn"])) <= 1e-5, k
        assert r["train/mesh_is_kept"]


# ---------------------------------------------------------------------------
# what a tensor-parallel layer materialises
# ---------------------------------------------------------------------------

def test_ep_body_receives_the_ranks_experts(runs):
    """Reduced deepseek on 1 x 4: every ``ep_body`` call gets the rank's
    (E / 4, D, F) expert stacks, not all E."""
    E, D, F = runs[1][0]["c1/deepseek_dims"]
    for r in runs[1]:
        assert len(r["c1/ep_stacks"]) == 3          # one per layer
        assert set(r["c1/ep_stacks"]) == {(E // 4, D, F)}


def test_layer_gathers_the_tp_only_placement(runs):
    """The bytes one llama3-8b layer all-gathers on 2 x 2 (FSDP x TP) are
    each weight's FSDP gather to its TP-only placement: a weight split
    over "model" arrives as half of it, and the layer as less than it
    weighs whole."""
    for r in runs[1]:
        assert r["c1/gathered"] == r["c1/expected"] < r["c1/whole"]


def test_no_weight_is_read_whole(runs):
    """No parameter goes through ``DTensor.full_tensor`` in the placed
    forwards (deepseek on 1 x 4, llama3-8b on 2 x 2)."""
    for r in runs[1]:
        assert r["c1/whole_reads"] == []


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,step", [("port", 5), ("repro", 7)])
def test_restore_elastic_is_bitwise(runs, writer, step):
    """A checkpoint of llama3-8b's parameters written by either package,
    restored onto the 2 x 2 mesh with each leaf placed by the rules: the
    global arrays back bit for bit on every rank."""
    flat, ranks, _ = runs
    prefix = "llama3-8b/params/"
    for r in ranks:
        assert r[f"restore/{writer}/step"] == step
        for k, v in flat.items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(
                    r[f"restore/{writer}/{k[len(prefix):]}"], v)


# ---------------------------------------------------------------------------
# batch and cache leaves placed by the partition rules (the dry run's
# arguments), and the dry run's collectives against a real rank's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,B", R.PLACED_CASES)
def test_placed_cache_decode_equals_whole_cache(runs, arch, B):
    """Decode steps of reduced models on a cache placed as the dry run
    places it (each rank holds its rows, its KV heads and SSM heads, and
    for a batch of 1 its chunk of the positions, whose softmax is then
    reduced over "data") against the steps on a cache every rank holds
    whole: 1e-5 in float32 (summation order only), on every rank."""
    _, ranks, _ = runs
    key = f"placed/{arch}/{B}"
    cfg = _f32(arch)
    L, dp, tp = R.DECODE_STEPS + 1, 2, 2
    for r in ranks:
        np.testing.assert_allclose(r[key + "/decode_placed"],
                                   r[key + "/decode_whole"],
                                   rtol=0, atol=MOE_TOL)
    local = ranks[0][key + "/cache_local"]
    k = local["attn/k"] if cfg.family == "hybrid" else local["k"]
    rows, seq = (1, L // dp) if B == 1 else (B // dp, L)
    assert k[1:] == (rows, seq, cfg.n_kv_heads // tp,
                     cfg.resolved_head_dim)
    if cfg.family == "hybrid":
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        assert local["ssm/state"][1:3] == (rows, heads // tp)


@pytest.mark.parametrize("arch", sorted({a for a, B in R.PLACED_CASES
                                         if B == R.FORWARD_SHAPE[0]}))
def test_placed_batch_forward_is_bitwise(runs, arch):
    """A token batch placed by the partition rules (each rank reads its
    rows' shard) gives the forward of the batch every rank holds whole,
    bit for bit."""
    _, ranks, _ = runs
    key = f"placed/{arch}/{R.FORWARD_SHAPE[0]}"
    for r in ranks:
        np.testing.assert_array_equal(r[key + "/forward_placed"],
                                      r[key + "/forward_whole"])


def test_dryrun_collectives_equal_gloo_rank(runs):
    """The dry run of reduced llama3-8b's prefill on a (2, 2) fake group
    (meta tensors, rank 0) records the collectives, counts and result
    bytes by kind, that rank 0 of the real 4-rank gloo run issues, and
    their number is the one ``CommDebugMode`` counts there. Nothing is
    all-gathered: the weights are placed without FSDP, and the logits
    stay split by rows and vocabulary as the reference leaves them."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    _, ranks, _ = runs
    B, S = R.DRYRUN_SHAPE
    with dryrun.fake_group(R.WORLD):
        mesh = make_mesh((2, 2), ("data", "model"))
        rec = dryrun.measure(dryrun.build_cell(
            get_config("llama3-8b").reduced(),
            ShapeConfig("t", S, B, "prefill"), mesh))
    assert rec["collectives"] == ranks[0]["dryrun/collectives"]
    assert sum(rec["collectives"]["counts"].values()) == \
        ranks[0]["dryrun/comm_debug_total"]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["collectives"]["bytes"]["all-gather"] == 0

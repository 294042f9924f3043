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

The K and V projections each rank computes (``torch_ranks.kv_columns``)
are pinned to the columns of the K/V ``dot`` in ``repro``'s compiled
forward and train step per device (``wk`` / ``wv`` are replicated there,
and XLA gives each device the KV heads its query heads read): in the
cases above, at 1 x 16 for those two and a llama3-8b-like 32 over 8 (the
port's ranks on fake process groups), and for reduced llama3-8b on 2 x 2
(``torch_ranks.KV_WIDE`` / ``KV_LLAMA``).

The decode step's K and V projections are pinned under the rules the
reference's dry run decodes with (``make_rules(mesh, fsdp=False,
kv_cache_heads_shardable=KV % tp == 0, replicate_attn_heads=True)``; the
port's ``dryrun.decode_rules``): where the cache is replicated every
device projects every KV head, where it is split by heads each projects
its own. Those cases, and H 32 over 32 at 1 x 16 (zamba2-1.2b's
shared-attention heads, ``torch_ranks.KV_DECODE``), hold each rank's
decode step through ``build_serve_step`` on a cache placed by those rules
to the compiled decode step's K/V ``dot`` per device. Under
``make_rules(mesh, fsdp=False)`` alone the reference projects one KV head
a device, and pays for it with an all-gather of each device's whole K
and V cache every step: both are recorded.
"""

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
from repro_torch.models import get_config, layers
from repro_torch.models.carry import tree_items
from torch_parity import assert_flat_checksums

FWD_TOL = 1e-4
CASES = [(name, m) for name, _, _, _ in R.HEAD_CASES for m in R.MESHES]
IDS = [f"{name}-{m}" for name, m in CASES]
KV_NAMES = ([name for name, _, _, _ in R.KV_WIDE]
            + [f"{R.KV_LLAMA[0]}/{R.KV_LLAMA_MESH}"])
# the columns of each K/V projection dot of repro's compiled programs per
# device, measured on forced host devices (head dim 32): one KV head
# wherever a rank's heads tile KV groups or lie within one, all 3 where a
# block of 3 heads spans 1.5 groups
KV_COLS = 32
KV3_COLS = 96
# the columns of each K/V projection dot of repro's compiled decode step
# per device under its dry run's decode rules, measured on forced host
# devices: every KV head where the cache is replicated (phi4 8, qwen2vl
# 2, llama 8 at 1 x 16), the device's own where it is split by heads
# (reduced llama3-8b's 1 of 2 on 2 x 2, kv32's 2 of 32 at 1 x 16)
DECODE_COLS = {"phi4": 256, "qwen2vl": 64, "llama": 256,
               f"{R.KV_LLAMA[0]}/{R.KV_LLAMA_MESH}": 32, R.KV_DECODE[0]: 64}


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


def _fake_ranks():
    """``torch_ranks.kv_case`` of each of ``KV_WIDE``'s cases at 1 x 16
    for each of the port's 16 ranks, and ``torch_ranks.kv_decode`` of
    ``KV_DECODE``, rank by rank on a fake process group of 16."""
    out = {}
    name, arch, H, KV = R.KV_DECODE
    cases = [(n, a, h, kv, R.kv_case) for n, a, h, kv in R.KV_WIDE]
    cases.append((name, arch, H, KV,
                  lambda cfg, mesh: {"decode_kv": R.kv_decode(cfg, mesh)}))
    with repro_torch.use_device("cpu"):
        for name, arch, H, KV, case in cases:
            cfg = R.wide_cfg(get_config, arch, H, KV)
            out[name] = []
            for rank in range(R.HEAD_WIDE_TP):
                dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                        world_size=R.HEAD_WIDE_TP)
                try:
                    mesh = make_mesh((1, R.HEAD_WIDE_TP), ("data", "model"))
                    out[name].append(case(cfg, mesh))
                finally:
                    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the reference's on 4 devices, its pin on 16,
    the port's ranks on fake process groups)."""
    d = tmp_path_factory.mktemp("head_groups")
    flat = _inputs()
    np.savez(d / "inputs.npz", **{k.replace("/", "__"): v
                                  for k, v in flat.items()})
    refs = {mode: R.start_reference(d, mode) for mode in ("heads", "pin16")}
    try:
        ranks = R.run_world(R.head_groups_body, str(d))
        fake = _fake_ranks()
    finally:
        for ref in refs.values():
            R.wait_reference(ref)
    return (ranks, R.load_reference(d, "heads"), R.load_reference(d, "pin16"),
            fake)


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
    """Every block's projected KV heads (``layers.kv_span``), repeated to
    its query heads as ``_sdpa`` repeats them where the block tiles KV
    groups or lies within one, and otherwise one per query head
    (``layers.block_kv``), are the KV head each query head reads,
    ``h // (H / KV)``; a block that tiles projects only the heads it
    reads."""
    k = torch.arange(KV, dtype=torch.float32).reshape(1, 1, KV, 1)
    for g in (1, 2, 3, 6):
        if H % g:
            continue
        for b in range(g):
            kv0, n_kv = layers.kv_span(H, KV, g, b)
            got = k[:, :, kv0:kv0 + n_kv]
            n = H // g
            want = [h // (H // KV) for h in range(b * n, (b + 1) * n)]
            if layers.heads_tile(H, KV, g):
                assert list(range(kv0, kv0 + n_kv)) == sorted(set(want))
                got = torch.repeat_interleave(got, n // n_kv, dim=2)
            else:
                assert (kv0, n_kv) == (0, KV)
                got = layers.block_kv(got, H, g, b)
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
    _, _, pin, fake = runs
    ref = set(pin["meta"][f"{name}/heads"])
    assert ref == {3}
    assert [set(r["heads"]) for r in fake[name]] == [ref] * R.HEAD_WIDE_TP


@pytest.mark.parametrize("name,mesh", CASES + [("kv3", "1x4")],
                         ids=IDS + ["kv3-1x4"])
def test_ranks_project_the_kv_heads_reference_devices_project(runs, name,
                                                              mesh):
    """Every K and V projection of every rank's forward, and of its
    gradient, has the columns of ``repro``'s compiled K/V ``dot`` per
    device: one KV head where a block's heads lie within one KV group,
    all three of kv3's, whose blocks span one and a half."""
    ranks, want, _, _ = runs
    key = f"{name}/{mesh}"
    cols = KV3_COLS if name == "kv3" else KV_COLS
    n_layers = get_config("phi4-mini-3.8b").reduced().n_layers
    assert set(want["meta"][f"{key}/kv"]) == {cols}
    for r in ranks:
        assert r[key]["kv"] == [(cols, cols)] * n_layers
    if name == "kv3":
        return
    assert set(want["meta"][f"{key}/train_kv"]) == {cols}
    for r in ranks:
        assert r[f"{key}/grads"]["kv"]
        assert set(r[f"{key}/grads"]["kv"]) == {(cols, cols)}


def _kv_case(runs, name):
    """(the reference's compiled meta, each of the port's ranks' results,
    layers) of a K/V pin's case: reduced llama3-8b on the four gloo ranks,
    or a 1 x 16 case on the fake process groups."""
    ranks, heads, pin, fake = runs
    if "/" in name:
        return (heads["meta"], [r[name] for r in ranks],
                get_config("llama3-8b").reduced().n_layers)
    return pin["meta"], fake[name], 1


@pytest.mark.parametrize("name", KV_NAMES)
def test_wide_ranks_project_the_kv_heads_reference_devices_project(runs,
                                                                   name):
    """At 1 x 16 (llama3-8b's 32 heads over 8 KV heads,
    phi4-mini-3.8b's 24 over 8, qwen2-vl-2b's 12 over 2) and for reduced
    llama3-8b on 2 x 2 (4 over 2), each rank's K and V projections in its
    forward and its gradient have the columns of ``repro``'s compiled K/V
    ``dot`` per device in the forward and the train step: one KV head,
    not all of them."""
    meta, got, n_layers = _kv_case(runs, name)
    for what in ("kv", "train_kv"):
        assert set(meta[f"{name}/{what}"]) == {KV_COLS}, what
    for r in got:
        assert r["kv"] == [(KV_COLS, KV_COLS)] * n_layers
        assert r["train_kv"]
        assert set(r["train_kv"]) == {(KV_COLS, KV_COLS)}


@pytest.mark.parametrize("name", KV_NAMES)
def test_reference_decode_projects_one_kv_head_a_device(runs, name):
    """Under ``make_rules(mesh, fsdp=False)`` alone, ``repro``'s compiled
    decode step projects one KV head a device in the same cases. The
    port deliberately does not decode under those rules, nor does
    ``repro``'s dry run: they place the query heads over "model" and
    replicate the cache, so XLA all-gathers each device's whole K and V
    cache every step (``test_decode_rules_gather_no_cache``)."""
    meta, _, _ = _kv_case(runs, name)
    assert set(meta[f"{name}/decode_kv"]) == {KV_COLS}


@pytest.mark.parametrize("name", list(DECODE_COLS))
def test_decode_ranks_project_the_kv_heads_reference_devices_project(
        runs, name):
    """Under the rules ``repro``'s dry run decodes with, each rank's K and
    V projections in a decode step through ``build_serve_step`` (weights
    and cache placed by ``dryrun.decode_rules``) have the columns of
    ``repro``'s compiled decode step's K/V ``dot`` per device: every KV
    head where the cache is replicated (256, 64, 256), only the rank's
    own where it is split by heads (32 of 64 on 2 x 2, 64 of 1024 for
    32 over 32 at 1 x 16), not all of them (ROADMAP Queue C, C7)."""
    meta, got, n_layers = _kv_case(runs, name)
    cols = DECODE_COLS[name]
    assert set(meta[f"{name}/decode_rules_kv"]) == {cols}
    for r in got:
        assert r["decode_kv"] == [(cols, cols)] * n_layers


@pytest.mark.parametrize("name", list(DECODE_COLS))
def test_decode_rules_gather_no_cache(runs, name):
    """``repro``'s compiled decode step all-gathers each device's whole K
    and V cache (two all-gathers) under ``make_rules(mesh, fsdp=False)``,
    which places the query heads over "model", and none under its dry
    run's decode rules, which the port decodes with."""
    meta, _, _ = _kv_case(runs, name)
    assert meta[f"{name}/decode_gathers"] == 2
    assert meta[f"{name}/decode_rules_gathers"] == 0


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

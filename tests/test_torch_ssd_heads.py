"""Port vs reference, the Mamba2 layer across the ranks of a mesh whose
"model" axis splits ``out_proj``'s rows: each rank runs the SSD for the
SSM heads its rows read (``mamba2.ssd_heads``), as XLA splits
``repro``'s, whose ``out_proj`` is placed ``("ssm_inner", "embed")`` and
whose sharding propagation carries that split back through the SSD.

What needs ranks runs once for the file: four spawned gloo ranks
(``torch_ranks.ssd_body``, joined within ``torch_ranks.TIMEOUT``, then
killed) beside two subprocesses that run ``repro``
(``mesh_reference.py``): ``ssd`` on four forced host devices, ``ssd16``
on sixteen. The cases (``torch_ranks.SSD_CASES``), on 1 x 4: reduced
mamba2-130m and zamba2-1.2b with 16 heads (4 a rank), and reduced
mamba2-130m at width 48 with 6 heads, whose 1.5 heads a rank do not tile
``out_proj``'s rows (2 a rank, the head at each seam run by both of its
ranks, each projecting its own columns). Weights from ``repro``'s
``init``, batches from its ``make_batch``.

Tolerances are those of the other files across ranks, float32 compute:
forwards 1e-4, the loss 1e-5 and each gradient leaf within 1e-5 of its
largest value (a ``B`` / ``C`` column of ``in_proj`` not summed over the
ranks, or summed twice, is off by far more). The gradients are held for
mamba2-130m's cases, not for zamba2-1.2b's: its ``A_log`` gradient is a
sum that cancels to a few 1e-6, and ``repro``'s own float32 gradient of
it on one device lies farther from a float64 twin of the port than 1e-5
of its largest value, so no float32 order of the sums is held to that
bound there. The heads each rank runs are
pinned to the heads of the float32 (B, nc, heads, Q, Q) tensors in
``repro``'s compiled forward and train step per device, at 1 x 4 and at
1 x 16 (mamba2-130m's 24 heads and zamba2-1.2b's 64, one layer each; the
port's 16 ranks each on a fake process group of its own, its collectives
moving nothing, as in the dry run).
"""

import types

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
from repro_torch.launch.steps import build_train_step, place_model
from repro_torch.models import build_model, get_config, mamba2
from repro_torch.models.carry import tree_items
from repro_torch.sharding.partition import make_rules

FWD_TOL = 1e-4
# one layer's ranks summed against the whole layer, float32: the same
# products over other column blocks, summed in another order
BODY_TOL = 1e-6
NAMES = [name for name, _, _ in R.SSD_CASES]
GRAD_NAMES = ["mamba2", "h6"]
# the per-device heads of repro's compiled programs, measured on forced
# host devices: 4 of 16 at 1 x 4 (both archs), 2 of 6 at 1 x 4, 2 of 24
# and 4 of 64 at 1 x 16
WANT = {"mamba2": 4, "zamba2": 4, "h6": 2}
WANT_WIDE = {"mamba2": 2, "zamba2": 4}


def _inputs():
    flat = {}
    B, S = R.SSD_SHAPE
    for name, arch, d in R.SSD_CASES:
        cfg = R.ssd_cfg(ref_get_config, arch, d)
        params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
        for k, v in tree_items(jax.tree.map(np.asarray, params)):
            flat[f"{name}/params/{k}"] = v
        batch = ref_make_batch(cfg, B, S, jax.random.PRNGKey(10))
        for k, v in batch.items():
            flat[f"{name}/batch0/{k}"] = np.asarray(v)
    return flat


def _wide_heads():
    """Each of the port's 16 ranks' SSD heads in ``SSD_WIDE``'s forward
    and gradient at 1 x 16, rank by rank on a fake process group of 16."""
    B, S = R.SSD_SHAPE
    out = {}
    with repro_torch.use_device("cpu"):
        for name, arch, d in R.SSD_WIDE:
            cfg = R.ssd_cfg(get_config, arch, d, n_layers=1)
            api = build_model(cfg)
            batch = make_batch(cfg, B, S, torch.Generator().manual_seed(1))
            inputs = {k: v for k, v in batch.items() if k != "labels"}
            out[name] = []
            for rank in range(R.SSD_WIDE_TP):
                dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                        world_size=R.SSD_WIDE_TP)
                try:
                    mesh = make_mesh((1, R.SSD_WIDE_TP), ("data", "model"))
                    lm = api.init(torch.Generator().manual_seed(0))
                    with torch.no_grad(), R.ssd_heads() as fwd:
                        api.forward(lm, inputs, mesh)
                    _, info, _ = build_train_step(
                        api, TrainConfig(remat="none"), mesh)
                    with R.ssd_heads() as train:
                        info["value_and_grad"](
                            place_model(lm, make_rules(mesh)), batch)
                    out[name].append((fwd, train))
                finally:
                    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the reference's on 4 devices, its pin on 16,
    the port's 16 ranks' heads at 1 x 16)."""
    d = tmp_path_factory.mktemp("ssd_heads")
    flat = _inputs()
    np.savez(d / "inputs.npz", **{k.replace("/", "__"): v
                                  for k, v in flat.items()})
    refs = {mode: R.start_reference(d, mode) for mode in ("ssd", "ssd16")}
    try:
        ranks = R.run_world(R.ssd_body, str(d))
        wide = _wide_heads()
    finally:
        for ref in refs.values():
            R.wait_reference(ref)
    return (ranks, R.load_reference(d, "ssd"), R.load_reference(d, "ssd16"),
            wide)


# ---------------------------------------------------------------------------
# the split (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,d_model,tp,heads", [
    ("mamba2-130m", 128, 4, 4), ("zamba2-1.2b", 128, 4, 4),
    ("mamba2-130m", 48, 4, 2), ("mamba2-130m", 192, 16, 2),
    ("zamba2-1.2b", 512, 16, 4), ("mamba2-130m", None, 16, 2),
    ("zamba2-1.2b", None, 16, 4)])
def test_ssd_heads_are_the_measured_split(arch, d_model, tp, heads):
    """Every rank runs the per-device heads of ``repro``'s compiled SSD
    (``ceil(H / tp)``; at the production TP of 16 mamba2-130m's 2 of 24
    and zamba2-1.2b's 4 of 64), and its heads hold every column its rows
    of ``out_proj`` read."""
    cfg = get_config(arch)
    if d_model is not None:
        cfg = R.ssd_cfg(get_config, arch, d_model)
    d_inner, H, _ = mamba2.mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    assert mamba2.Mamba2(cfg, device="meta").splits(tp)
    assert -(-H // tp) == heads
    d_loc = d_inner // tp
    for r in range(tp):
        h0, n = mamba2.ssd_heads(d_inner, hd, tp, r)
        assert n == heads, r
        assert h0 * hd <= r * d_loc and (r + 1) * d_loc <= (h0 + n) * hd


@pytest.mark.parametrize("d_model,tp", [(128, 4), (48, 4), (48, 2),
                                        (56, 4)])
def test_rank_bodies_sum_to_the_whole_layer(d_model, tp):
    """``mamba2_body`` of each of ``tp`` ranks (its rows of ``out_proj``,
    every other weight whole) summed is the whole layer, within 1e-6
    (float32): also at width 56, 7 heads over 4 ranks, where a rank's
    columns start inside a head and end inside another."""
    cfg = R.ssd_cfg(get_config, "mamba2-130m", d_model)
    with repro_torch.use_device("cpu"):
        p = mamba2.Mamba2(cfg, device="cpu")
        p.init_(torch.Generator().manual_seed(0))
        x = torch.randn(2, 32, d_model,
                        generator=torch.Generator().manual_seed(1))
        whole = mamba2.mamba2_body(cfg, p, x)
        total = torch.zeros_like(whole)
        for r, rows in enumerate(p.out_proj.chunk(tp, 0)):
            q = types.SimpleNamespace(**{k: getattr(p, k)
                                         for k in mamba2.Mamba2.AXES})
            q.out_proj = rows
            total += mamba2.mamba2_body(cfg, q, x, rank=r, tp=tp)
    assert float((total - whole).abs().max()) <= BODY_TOL


# ---------------------------------------------------------------------------
# across ranks against repro on its mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name):
    """Each rank's logits of the forward are ``repro``'s shard on the
    device at its mesh coordinate (forward jitted with the dry run's
    ``in_shardings``), within 1e-4."""
    ranks, want, _, _ = runs
    for r, got in enumerate(ranks):
        block = want[f"{name}/forward/{r}"]
        assert got[name]["forward"].shape == block.shape, r
        np.testing.assert_allclose(got[name]["forward"], block, rtol=0,
                                   atol=FWD_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", NAMES)
def test_ranks_run_the_heads_reference_devices_run(runs, name):
    """Every SSD of every rank's forward runs the heads of ``repro``'s
    compiled forward per device: 4 of 16, 2 of 6 (not all of them)."""
    ranks, want, _, _ = runs
    assert set(want["meta"][f"{name}/heads"]) == {WANT[name]}
    arch = {n: a for n, a, _ in R.SSD_CASES}[name]
    n_layers = get_config(arch).reduced().n_layers
    for r in ranks:
        assert r[name]["heads"] == [WANT[name]] * n_layers


@pytest.mark.parametrize("name", NAMES)
def test_training_runs_the_heads_reference_devices_run(runs, name):
    """The SSDs of the gradient across the ranks run the heads of
    ``repro``'s compiled train step per device."""
    ranks, want, _, _ = runs
    assert set(want["meta"][f"{name}/train_heads"]) == {WANT[name]}
    for r in ranks:
        assert r[f"{name}/grads"]["heads"]
        assert set(r[f"{name}/grads"]["heads"]) == {WANT[name]}


@pytest.mark.parametrize("name", [n for n, _, _ in R.SSD_WIDE])
def test_wide_ranks_run_the_heads_reference_devices_run(runs, name):
    """At 1 x 16, mamba2-130m's 24 heads and zamba2-1.2b's 64: each of the
    port's 16 ranks runs the heads of ``repro``'s compiled forward and
    train step per device, 2 and 4, in its forward and its gradient."""
    _, _, pin, wide = runs
    for what in ("heads", "train_heads"):
        assert set(pin["meta"][f"{name}/{what}"]) == {WANT_WIDE[name]}
    assert len(wide[name]) == R.SSD_WIDE_TP
    for fwd, train in wide[name]:
        assert fwd == [WANT_WIDE[name]]
        assert train and set(train) == {WANT_WIDE[name]}


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_gradients_match_reference(runs, name):
    """``info["value_and_grad"]`` across the ranks, every leaf's global
    gradient, against ``jax.grad`` of ``repro``'s ``loss_fn`` on the same
    mesh, equal on every rank: the ``Partial`` gradient of the whole
    weights sums the ranks' disjoint columns and their shares of ``B`` /
    ``C`` once each."""
    ranks, want, _, _ = runs
    got = ranks[0][f"{name}/grads"]
    assert abs(got["loss"] - float(want[f"{name}/grads/loss"])) <= 1e-5
    prefix = f"{name}/grads/"
    paths = sorted(k[len(prefix):] for k in want
                   if k.startswith(prefix) and k != prefix + "loss")
    assert sorted(got["grads"]) == paths
    for path in paths:
        g = want[prefix + path]
        err = float(np.abs(got["grads"][path] - g).max())
        assert err <= 1e-5 * float(np.abs(g).max()), (path, err)
    for r in ranks[1:]:
        for path, g in r[f"{name}/grads"]["grads"].items():
            np.testing.assert_array_equal(g, got["grads"][path])

"""Port vs reference, the recurrent families: mamba2-130m (ssm: an
attention-free Mamba2 stack) and zamba2-1.2b (hybrid: Mamba2 layers with
one shared attention + SwiGLU block before every segment) at their
``reduced()`` sizes. Mamba2's pieces (causal conv, segment sums, the
chunked SSD, the recurrent decode step), both whole models' prefill and
decode, the carried weights and caches, the training path with its
compute copy, and slots and ledgers crossing the packages.

Weights come from ``repro``'s own ``api.init`` and go into the port
through ``repro_torch.models.carry``; tokens and activations are drawn
from numpy seeds and handed to both packages. Everything runs on the CPU;
neither family reaches a Pallas kernel in ``repro`` or a CUDA kernel in
the port.

Tolerances, each with its reason:

* float32 pieces (``_causal_conv``, ``_segsum``, ``mamba2_apply``,
  ``mamba2_decode_step``): ``1e-5`` absolute on outputs of order one,
  summation order of float32 einsums only (``torch.einsum`` contracts
  three operands in another order than XLA).
* whole models in float32 compute: logits within ``F32_ATOL`` = 1e-4
  (readings 9.5e-7 and 2.2e-6); decode steps the same.
* whole models in bfloat16 (the configs' own): logits within
  ``BF16_ATOL`` = 6e-2, as for the dense family
  (tests/test_torch_models.py): XLA and PyTorch round bf16 at other
  points. Readings 0.014 (mamba2, logits up to 1.9) and 0.031 (zamba2,
  logits up to 3.1); decode 0.008 and 0.016.
* teacher-forced decode against the same package's forward: ``5e-2``,
  the reference's own bound (tests/test_arch_smoke.py).
* loss and gradients through the train step's cast-once compute copy:
  float32 loss 1e-5 and each gradient leaf within ``1e-4`` of its
  largest value (readings: loss 9.5e-7; gradients 5.6e-6 and 4.8e-5, the
  largest on ``A_log``, whose gradient sums decay terms of both signs
  over every position); bf16 loss ``5e-3`` (readings 3.9e-4, 8.6e-4) and
  gradients within ``1e-1`` of their largest value (readings 0.026 and
  0.062, again on ``A_log``: its gradient is a bf16 value in both
  packages, and their bf16 activations differ by an ulp).
* three train steps against ``repro``'s own ``build_train_step`` on its
  one-device mesh: the bounds of tests/test_torch_train.py (loss and
  grad_norm 1e-5 relative, checksums 1e-5 relative + 1e-3, updates 1e-4
  of the largest, parameters 2 lr + 1e-6).
"""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import acc_state as ref_acc
from repro.core import slots as ref_slots
from repro.launch.mesh import single_device_mesh as ref_single_device_mesh
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.launch.steps import tree_checksums as ref_tree_checksums
from repro.models import mamba2 as ref_m2
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.optim import adamw as ref_adamw
from repro.optim import init_error_state as ref_init_error_state
from repro.sharding.partition import make_rules
from repro_torch.configs.base import TrainConfig
from torch_parity import assert_step_checksums
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.specs import make_batch
from repro_torch.launch.steps import build_serve_step, build_train_step
from repro_torch.launch.train import ADCCTrainer
from repro_torch.models import build_model, get_config, list_archs
from repro_torch.models import hybrid, mamba2, ssm_lm
from repro_torch.models.carry import (cache_from_reference,
                                      opt_from_reference, opt_to_reference,
                                      params_from_reference,
                                      params_to_reference, reference_paths,
                                      reference_tree, to_host, tree_items)
from repro_torch.models.registry import NOT_PORTED, model_class

ARCHS = ["mamba2-130m", "zamba2-1.2b"]
B, S = 2, 32
F32_ATOL = 1e-4
BF16_ATOL = 6e-2
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield
    assert fa_kernel.launches == 0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _cfg(arch: str, compute: str = "bfloat16"):
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype=compute)


_CASES, _PARAMS = {}, {}


def _case(arch: str, compute: str):
    """(cfg, ref api with jitted forward and decode, ref params (float32),
    port model, tokens (B, S) int32), built once per (arch, compute)."""
    key = (arch, compute)
    if key not in _CASES:
        cfg = _cfg(arch, compute)
        api = ref_build_model(cfg)
        api = dataclasses.replace(
            api, forward=jax.jit(api.forward, static_argnames=("mesh",
                                                               "remat")),
            decode_step=jax.jit(api.decode_step, static_argnames=("mesh",)))
        if arch not in _PARAMS:
            _PARAMS[arch] = api.init(jax.random.PRNGKey(0))[0]
        params = _PARAMS[arch]
        tokens = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        model = params_from_reference(cfg, jax.tree.map(np.asarray, params))
        _CASES[key] = (cfg, api, params, model, tokens)
    return _CASES[key]


def _atol(compute: str) -> float:
    return F32_ATOL if compute == "float32" else BF16_ATOL


def _batch(cfg, step: int = 0, seq: int = S):
    return SyntheticPipeline(cfg, B, seq, seed=3).batch_at(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    mine, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert mine.param_count() == ref.param_count()
    assert arch in list_archs()


@pytest.mark.parametrize("arch,expected_b", [
    ("zamba2-1.2b", 1.2), ("mamba2-130m", 0.13)])
def test_param_counts_match_published(arch, expected_b):
    n = get_config(arch).param_count() / 1e9
    assert 0.7 * expected_b <= n <= 1.35 * expected_b, (arch, n)


def test_registry_builds_the_recurrent_families():
    assert NOT_PORTED == {}
    assert model_class(get_config("mamba2-130m")) is ssm_lm.SSMLM
    assert model_class(get_config("zamba2-1.2b")) is hybrid.HybridLM
    assert hybrid.segments(get_config("zamba2-1.2b")) == \
        [(0, 6), (6, 6), (12, 6), (18, 6), (24, 6), (30, 6), (36, 2)]
    with pytest.raises(ValueError, match="ssm family"):
        ssm_lm.SSMLM(get_config("zamba2-1.2b"), device="meta")
    with pytest.raises(ValueError, match="hybrid family"):
        hybrid.HybridLM(get_config("mamba2-130m"), device="meta")
    api = build_model(get_config("mamba2-130m").reduced())
    lm_ = api.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="remat"):
        api.forward(lm_, {"tokens": torch.zeros((1, 16), dtype=torch.int32)},
                    remat="dots")


def test_make_batch_draws_tokens_for_both_families():
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        a = make_batch(cfg, 2, 16, torch.Generator().manual_seed(5))
        assert a["tokens"].shape == a["labels"].shape == (2, 16)
        assert 0 <= int(a["tokens"].min()) <= int(a["tokens"].max()) \
            < cfg.vocab_size


# ---------------------------------------------------------------------------
# Mamba2's pieces, float32
# ---------------------------------------------------------------------------

def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 12, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(mamba2._causal_conv(_t(u), _t(w), _t(b))),
        _np(ref_m2._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                jnp.asarray(b))), rtol=0, atol=1e-5)
    la = -np.abs(rng.normal(size=(2, 3, 16))).astype(np.float32)
    got, want = _np(mamba2._segsum(_t(la))), _np(ref_m2._segsum(
        jnp.asarray(la)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()
    assert (got[..., 3, 3] == 0.0).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


def test_segsum_mask_comes_before_exp():
    """The upper triangle's differences are large and positive: masked
    before ``exp``, the gradient stays finite (an ``exp`` of the unmasked
    triangle would overflow and give NaN)."""
    la = torch.full((1, 64), -30.0, requires_grad=True)
    y = torch.exp(mamba2._segsum(la)).sum()
    g, = torch.autograd.grad(y, [la])
    assert bool(torch.isfinite(y)) and bool(torch.isfinite(g).all())


def test_softplus_matches_jax_at_large_dt():
    """``F.softplus`` switches to the identity above 20; jax's is
    ``logaddexp(x, 0)``. In float32 their values agree within two ulps
    (reading 2.0) and are equal from 15 up, where ``dt`` is large; their
    gradients, both in [0, 1], within 5e-7 (reading 4.8e-7, four ulps of
    one)."""
    x = np.linspace(-40.0, 80.0, 4001).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    got = torch.nn.functional.softplus(xt)
    g, = torch.autograd.grad(got.sum(), [xt])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    gw = np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(
        jnp.asarray(x)))
    assert (np.abs(_np(got) - want) <= 2 * np.spacing(np.abs(want))).all()
    assert np.array_equal(_np(got)[x >= 15], want[x >= 15])
    np.testing.assert_allclose(_np(g), gw, rtol=0, atol=5e-7)


def _layer(cfg, seed: int):
    """One Mamba2 layer's reference parameters and the port's module."""
    p, _ = ref_m2.mamba2_init(cfg, jax.random.PRNGKey(seed))
    p = dict(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(seed)
    # away from the init's constants, so every parameter matters
    for k in ("dt_bias", "D_skip", "conv_b"):
        p[k] = (p[k] + rng.normal(size=p[k].shape) * 0.3).astype(np.float32)
    mod = mamba2.Mamba2(cfg, device="cpu")
    for k, v in p.items():
        getattr(mod, k).data.copy_(_t(v))
    return {k: jnp.asarray(v) for k, v in p.items()}, mod


def test_mamba2_apply_matches_reference():
    """The chunked SSD over 4 chunks, float32."""
    cfg = _cfg("mamba2-130m", "float32")
    jp, mod = _layer(cfg, 1)
    x = np.random.default_rng(2).normal(size=(2, 64, cfg.d_model)
                                        ).astype(np.float32)
    want = ref_m2.mamba2_apply(cfg, jp, jnp.asarray(x))
    got = mamba2.mamba2_apply(cfg, mod, _t(x))
    assert float(np.abs(_np(want)).max()) > 0.1
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="chunk"):
        mamba2.mamba2_apply(cfg, mod, _t(x[:, :24]))


def test_mamba2_decode_step_matches_reference():
    """Three recurrent steps from a seeded cache, float32."""
    cfg = _cfg("mamba2-130m", "float32")
    jp, mod = _layer(cfg, 3)
    rng = np.random.default_rng(4)
    cache, _ = ref_m2.mamba2_cache_init(cfg, 2)
    cache = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
             for k, v in cache.items()}
    mine = {k: _t(v) for k, v in cache.items()}
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, cache = ref_m2.mamba2_decode_step(cfg, jp, jnp.asarray(x),
                                                cache)
        got, mine = mamba2.mamba2_decode_step(cfg, mod, _t(x), mine)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
        for k in cache:
            np.testing.assert_allclose(_np(mine[k]), _np(cache[k]), rtol=0,
                                       atol=1e-5)
    assert mine["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# whole models: prefill, decode, carried caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, compute):
    cfg, api, params, model, tokens = _case(arch, compute)
    want = api.forward(params, {"tokens": jnp.asarray(tokens)})
    got = build_model(cfg).forward(model, {"tokens": _t(tokens)})
    assert got.shape == (B, S, cfg.vocab_size)
    assert got.dtype == getattr(torch, compute)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_atol(compute))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, compute):
    """Four decode steps from empty caches in both packages; the port's
    cache, written in place, equals the reference's returned one."""
    cfg, api, params, model, tokens = _case(arch, compute)
    port = build_model(cfg)
    ref_cache, _ = api.init_cache(B, 8)
    cache, axes = port.init_cache(B, 8)
    ax = dict(tree_items(axes))
    for path, t in tree_items(cache):
        assert len(ax[path]) == t.ndim, (path, ax[path])
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        want, ref_cache = api.decode_step(params, ref_cache,
                                          jnp.asarray(tok), pos)
        got, cache = port.decode_step(model, cache, _t(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_atol(compute))
    want_c = dict(tree_items(jax.tree.map(np.asarray, ref_cache)))
    for path, t in tree_items(cache):
        np.testing.assert_allclose(_np(t), want_c[path].astype(np.float32),
                                   rtol=0, atol=_atol(compute))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_carried_mid_decode(arch):
    """A decode begun in the reference continues in the port: the cache
    after two steps, carried, and the third step in both."""
    cfg, api, params, model, tokens = _case(arch, "float32")
    ref_cache, _ = api.init_cache(B, 6)
    for pos in range(2):
        _, ref_cache = api.decode_step(params, ref_cache,
                                       jnp.asarray(tokens[:, pos:pos + 1]),
                                       pos)
    host = jax.tree.map(np.asarray, ref_cache)
    cache = cache_from_reference(cfg, host)
    want, _ = api.decode_step(params, ref_cache, jnp.asarray(tokens[:, 2:3]),
                              2)
    got, _ = build_model(cfg).decode_step(model, cache, _t(tokens[:, 2:3]), 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    # the SSM state stays float32 in a bf16 model's cache
    bf = cache_from_reference(_cfg(arch, "bfloat16"), host)
    ssm = bf["ssm"] if arch == "zamba2-1.2b" else bf
    assert ssm["state"].dtype == torch.float32
    assert ssm["conv"].dtype == torch.bfloat16
    bad = copy.deepcopy(host)
    part = bad["ssm"] if arch == "zamba2-1.2b" else bad
    part["state"] = part["state"][..., :-1]
    with pytest.raises(ValueError, match="state"):
        cache_from_reference(cfg, bad)
    with pytest.raises(ValueError, match="expected"):
        cache_from_reference(cfg, {"k": ssm["conv"].float().numpy()})


def _teacher_forced(arch, seq):
    """The twin of tests/test_arch_smoke.py's test_decode_matches_forward_
    ssm / _hybrid: reduced config (bf16), weights from a seeded generator,
    teacher-forced decode against the forward."""
    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, B, seq, torch.Generator().manual_seed(1))
    ref = api.forward(model, batch)
    cache, _ = api.init_cache(B, seq)
    outs = []
    for t in range(seq):
        lg, cache = api.decode_step(model, cache,
                                    batch["tokens"][:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec.float() - ref.float()).abs().max()) < 5e-2


def test_decode_matches_forward_ssm():
    _teacher_forced("mamba2-130m", 16)


def test_decode_matches_forward_hybrid():
    _teacher_forced("zamba2-1.2b", 8)


def test_serve_step_is_the_decode_step_with_the_hybrid_cache():
    cfg = get_config("zamba2-1.2b").reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    serve, info = build_serve_step(api, single_device_mesh(), batch=2,
                                   max_len=8)
    assert info["cache_shapes"]["attn/k"] == (
        len(hybrid.segments(cfg)), 2, 8, cfg.n_kv_heads,
        cfg.resolved_head_dim)
    assert info["cache_shapes"]["ssm/state"][0] == cfg.n_layers
    c1, _ = api.init_cache(2, 8)
    c2, _ = api.init_cache(2, 8)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    a, c1 = serve(model, c1, tok, 0)
    b, c2 = api.decode_step(model, c2, tok, 0)
    assert torch.equal(a, b)
    # each application of the shared block wrote its own slot
    k = c1["attn"]["k"][:, :, 0]
    assert all(float(k[i].abs().max()) > 0 for i in range(k.shape[0]))
    assert not torch.equal(k[0], k[1])


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py::TestArchSmoke
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
class TestArchSmoke:
    def test_forward_and_train_step(self, arch):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        model = api.init(torch.Generator().manual_seed(0))
        batch = make_batch(cfg, B, S, torch.Generator().manual_seed(1))
        logits = api.forward(model, batch)
        assert logits.shape == (B, S, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        for p in model.parameters():
            p.requires_grad_(True)
        loss = api.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads):
                p.sub_(1e-3 * g)
        assert bool(torch.isfinite(api.loss_fn(model, batch)))

    def test_param_axes_cover_params(self, arch):
        """The port keeps no parameter axes: its twin holds every leaf of
        the reference's abstract parameters to one port parameter per
        layer of the same shape and type, nothing left over."""
        cfg = get_config(arch).reduced()
        shapes, axes = ref_build_model(cfg).abstract_init(
            jax.random.PRNGKey(0))
        want = {p: (tuple(s.shape), str(s.dtype))
                for p, s in tree_items(shapes)}
        meta = build_model(cfg).abstract_init()
        by_name = dict(meta.named_parameters())
        got = {}
        for path, names in reference_paths(cfg):
            p = by_name[names[0]]
            shape = tuple(p.shape)
            if path.startswith("layers/"):
                shape = (len(names),) + shape
            got[path] = (shape, str(p.dtype).removeprefix("torch."))
        assert got == want
        assert list(got) == [p for p, _ in tree_items(shapes)]

    def test_decode_step(self, arch):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        model = api.init(torch.Generator().manual_seed(0))
        cache, _ = api.init_cache(B, 16)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        for pos in range(3):
            logits, cache = api.decode_step(model, cache, tok, pos)
            assert logits.shape == (B, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits.float()).all())
            tok = logits.argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _to_compute(dt):
    return lambda w: (w.astype(dt) if w.dtype == jnp.float32 and w.ndim >= 2
                      else w)


@pytest.mark.parametrize("compute,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-4), ("bfloat16", 5e-3, 1e-1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, compute, loss_tol,
                                            grad_tol):
    """Through the reference's cast-once step (``to_compute`` on the
    stacked tree) and the port's compute copy; remat "dots"."""
    cfg, api, params, model, _ = _case(arch, compute)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tc = _to_compute(jnp.dtype(compute))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_fn(jax.tree.map(tc, p), jb, None,
                              remat="dots")))(params)
    _, info, _ = build_train_step(build_model(cfg), TrainConfig(remat="dots"))
    loss, grads = info["value_and_grad"](model, _torch_batch(batch))
    assert abs(float(loss) - float(ref_loss)) <= loss_tol
    mine = {p: to_host(x) for p, x in tree_items(reference_tree(cfg, grads))}
    want = dict(tree_items(jax.tree.map(np.asarray, ref_grads)))
    assert list(mine) == list(want)
    for path, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, path
        err = float(np.abs(mine[path] - g).max())
        assert err <= grad_tol * scale, (path, err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    cfg, _, _, model, _ = _case(arch, "bfloat16")
    batch = _torch_batch(_batch(cfg))
    out = {}
    for remat in ("none", "full", "dots"):
        _, info, _ = build_train_step(build_model(cfg),
                                      TrainConfig(remat=remat))
        out[remat] = info["value_and_grad"](model, batch)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for n, g in out["none"][1].items():
            assert torch.equal(out[remat][1][n], g), (remat, n)


def test_compute_copy_casts_the_ssm_vectors_as_the_reference():
    """The reference casts each float32 leaf of two or more dimensions of
    its *stacked* tree, so a layer's ``A_log``, ``dt_bias`` and ``D_skip``
    ((L, H) leaves) enter its bf16 step in bf16, ``A_log`` through a bf16
    ``exp``. The port's compute copy does the same: with ``A_log`` off
    bf16's grid, its step's loss differs from the loss of a copy that
    keeps the 1-D parameters in float32 (the rule before), and its
    ``A_log`` gradient is a bf16 value, as the reference's is."""
    cfg, api, params, _, _ = _case("mamba2-130m", "bfloat16")
    tree = jax.tree.map(np.asarray, params)
    a_log = tree["layers"]["mamba"]["A_log"]
    tree["layers"]["mamba"]["A_log"] = (a_log + 1e-3 * np.arange(
        a_log.size).reshape(a_log.shape)).astype(np.float32)
    off = tree["layers"]["mamba"]["A_log"]
    assert not np.array_equal(np.asarray(jnp.asarray(off, jnp.bfloat16)
                                         .astype(jnp.float32)), off)
    model = params_from_reference(cfg, tree)
    batch = _batch(cfg)
    port = build_model(cfg)
    _, info, _ = build_train_step(port, TrainConfig(remat="none"))
    loss, grads = info["value_and_grad"](model, _torch_batch(batch))
    for i in range(cfg.n_layers):
        g = grads[f"layers.{i}.mamba.A_log"]
        assert torch.equal(g, g.to(torch.bfloat16).float())
    # the rule before: only parameters of two or more dimensions in bf16
    before = copy.deepcopy(model)
    with torch.no_grad():
        for p in before.parameters():
            if p.ndim >= 2:
                p.data = p.data.to(torch.bfloat16)
    assert float(port.loss_fn(before, _torch_batch(batch))) != float(loss)
    # and the reference's own step, within the bf16 bound above
    tc = _to_compute(jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss = api.loss_fn(jax.tree.map(tc, jax.tree.map(jnp.asarray, tree)),
                           jb)
    assert abs(float(ref_loss) - float(loss)) <= 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """float32 compute, AdamW, remat "dots", against repro's own
    ``build_train_step`` on its one-device mesh, which the port's trainer
    path matches with its own one-card mesh."""
    cfg, api, params, _, _ = _case(arch, "float32")
    tcfg = TrainConfig(remat="dots", warmup_steps=2, total_steps=20)
    ref_step, _, ref_init = ref_build_train_step(
        ref_build_model(cfg), RefTrainConfig(**dataclasses.asdict(tcfg)),
        make_rules(ref_single_device_mesh(), fsdp=True), donate=False)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    step, info, opt_init = build_train_step(build_model(cfg), tcfg,
                                            single_device_mesh())
    assert info["mesh"].size == 1
    r_p, r_o, r_e = params, ref_init(params), ref_init_error_state(params)
    opt = opt_init(model)
    for t in range(3):
        batch = _batch(cfg, t)
        r_p, r_o, r_e, r_m, r_c = ref_step(
            r_p, r_o, r_e, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(t))
        model, opt, _, m, c = step(model, opt, {}, _torch_batch(batch),
                                   torch.Generator().manual_seed(t))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                       rtol=1e-5)
        assert_step_checksums(c, r_c, tcfg, t + 1)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=2 * tcfg.learning_rate + 1e-6),
        params_to_reference(cfg, model), r_p)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_round_trips_through_reference_layout(arch, optimizer):
    cfg, _, params, model, _ = _case(arch, "float32")
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    rng = np.random.default_rng(8)
    init, _ = ref_adamw.make_optimizer(RefTrainConfig(optimizer=optimizer))
    opt_np = jax.tree.map(
        lambda a: (rng.normal(size=a.shape).astype(np.float32)
                   if a.ndim else np.asarray(3, np.int32)),
        init(params)._asdict())
    again = opt_to_reference(cfg, opt_from_reference(cfg, opt_np))
    assert jax.tree.structure(again) == jax.tree.structure(opt_np)
    jax.tree.map(np.testing.assert_array_equal, opt_np, again)


def _trainer(workdir, arch="mamba2-130m", optimizer="adamw"):
    """A reduced trainer, AdamW, a slot every 2 steps, sequence 16 (one
    SSD chunk of the reduced config)."""
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(remat="none", total_steps=40, warmup_steps=5,
                       optimizer=optimizer)
    return ADCCTrainer(cfg, tcfg, workdir, batch=2, seq=16, slot_every=2)


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(a.named_parameters(), b.named_parameters()))


class TestTrainer:
    @pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
    def test_crash_restart_is_bitwise(self, tmp_path, optimizer):
        ref = _trainer(str(tmp_path / "ref"), "zamba2-1.2b", optimizer)
        r_ref = ref.run(5, log_every=0)
        wd = str(tmp_path / "crash")
        _trainer(wd, "zamba2-1.2b", optimizer).run(5, crash_at_step=3,
                                                    log_every=0)
        tr = _trainer(wd, "zamba2-1.2b", optimizer)
        res = tr.run(5, log_every=0)
        assert tr.mesh.size == 1
        assert res.resumed_from == 1
        assert res.losses == r_ref.losses[2:]
        assert _max_diff(ref._final_params, tr._final_params) == 0.0

    @pytest.mark.parametrize("arch", ARCHS)
    def test_reference_reads_the_ports_slot_and_ledger(self, tmp_path, arch):
        wd = str(tmp_path / "x")
        tr = _trainer(wd, arch)
        tr.run(4, log_every=0)
        recs = ref_acc.ChecksumLedger(
            os.path.join(wd, "ledger.jsonl")).validated_records()
        assert [r.step for r in recs] == list(range(4))
        store = ref_slots.SlotStore(os.path.join(wd, "slots"), 3)
        assert store.slots_by_recency() == [(1, 3), (0, 1)]
        shapes, _ = ref_build_model(tr.cfg).abstract_init(
            jax.random.PRNGKey(0))
        template = {"params": shapes,
                    "opt": jax.eval_shape(ref_adamw.adamw_init, shapes)}
        state = ref_slots.unflatten_state(template, store.read_slot(1))
        rec = {r.step: r for r in recs}[3]
        assert ref_acc.verify_state_against_record(
            state["params"], state["opt"], rec) == (True, 0)
        assert len(rec.cks_params) == len(jax.tree.leaves(shapes))
        final = params_to_reference(tr.cfg, tr._final_params)
        jax.tree.map(np.testing.assert_array_equal, final, state["params"])

    @pytest.mark.parametrize("arch", ARCHS)
    def test_port_recovers_from_the_references_slot(self, tmp_path, arch):
        cfg = get_config(arch).reduced()
        params = jax.tree.map(np.asarray, _case(arch, "bfloat16")[2])
        rng = np.random.default_rng(9)
        draw = lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-3
        upd = jax.tree.map(draw, params)
        opt = ref_adamw.AdamWState(
            step=np.asarray(2, np.int32), m=jax.tree.map(draw, params),
            v=jax.tree.map(lambda p: np.abs(draw(p)), params))
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
        tr = _trainer(wd, arch)
        seen = {}
        real = tr.step_fn

        def spy(model, *a):
            seen.setdefault("p", params_to_reference(cfg, model))
            return real(model, *a)

        tr.step_fn = spy
        res = tr.run(4, log_every=0)
        assert res.resumed_from == 2
        assert res.recovery_report.endswith("verified")
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, np.asarray(b)), seen["p"], params)


def test_cli_trains_mamba2(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as train_mod
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    train_mod.main(["--arch", "mamba2-130m", "--reduced", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--workdir",
                    str(tmp_path / "cli"), "--mode", "none"])
    assert "done: final step 1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_recurrent_modules_import_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "import repro_torch\n"
        "from repro_torch.models import build_model, get_config\n"
        "from repro_torch.models import hybrid, mamba2, ssm_lm\n"
        "with repro_torch.use_device('cpu'):\n"
        "    for arch in ('mamba2-130m', 'zamba2-1.2b'):\n"
        "        cfg = get_config(arch).reduced()\n"
        "        api = build_model(cfg)\n"
        "        m = api.init(torch.Generator().manual_seed(0))\n"
        "        cache, _ = api.init_cache(1, 4)\n"
        "        out, _ = api.decode_step(m, cache, torch.zeros((1, 1),"
        " dtype=torch.int32), 0)\n"
        "        assert out.shape == (1, 1, cfg.vocab_size)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " or m == 'repro' or m.startswith('repro.')"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"

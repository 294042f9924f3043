"""Port vs reference, the vlm and audio families: qwen2-vl-2b (vlm: GQA
with M-RoPE over a sequence of patch embeddings followed by text) and
hubert-xlarge (audio: a bidirectional encoder over frame embeddings, no
rotary embedding, an untied head and no embedding table) at their
``reduced()`` sizes. M-RoPE, the batch builders, both models' prefill,
qwen2-vl's decode and cache, the carried weights, and the training path
against ``repro``'s own ``build_train_step``.

Weights come from ``repro``'s own ``api.init`` and go into the port
through ``repro_torch.models.carry``; batches come from ``repro``'s
``make_batch`` (or numpy seeds) and are handed to both packages. The
port's ``make_batch`` draws from a ``torch.Generator``, so its values
differ from ``jax.random``'s; its shapes, types and M-RoPE positions are
held to the reference's. Everything runs on the CPU: qwen2-vl's flash
branch runs ``repro``'s Pallas kernel in interpret mode and the port's
kernel's plain version; hubert never reaches either (not causal).

Tolerances, each with its reason:

* ``apply_mrope``: float32 ``1e-6`` (the same float32 angles; cos and sin
  of two libraries differ in the last bit); bfloat16 one rounding step
  (``2e-2``). With three equal streams it is ``apply_rope`` bit for bit.
* whole models in float32 compute: logits within ``F32_ATOL`` = 1e-4
  (readings 8.9e-7 and 1.4e-6), as for the dense family
  (tests/test_torch_models.py); decode steps and caches the same.
* whole models in bfloat16 (the configs' own): ``BF16_ATOL`` = 6e-2, as
  for the dense family: XLA and PyTorch round bf16 at other points
  (readings 0.011 for qwen2-vl, logits up to 1.1, and 0.031 for hubert,
  logits up to 2.9).
* teacher-forced decode against the same package's zero-patch prefill:
  ``1e-4``, the reference's bound for the dense family
  (tests/test_arch_smoke.py).
* loss and gradients through the train step's compute copy, and three
  train steps against ``repro``'s ``build_train_step``: the bounds of
  tests/test_torch_ssm.py (float32 loss 1e-5 and each gradient leaf
  within 1e-4 of its largest value; bf16 loss 5e-3 and gradients within
  1e-1 of their largest value; steps: loss and grad_norm 1e-5 relative,
  checksums 1e-5 relative + 1e-3, updates 1e-4 of the largest,
  parameters 2 lr + 1e-6).
"""

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
from repro.launch import specs as ref_specs
from repro.launch.mesh import single_device_mesh as ref_single_device_mesh
from repro.launch.steps import build_serve_step as ref_build_serve_step
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.optim import adamw as ref_adamw
from repro.optim import init_error_state as ref_init_error_state
from repro.sharding.partition import make_rules
from repro_torch.configs.base import TrainConfig
from torch_parity import assert_step_checksums
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.steps import build_serve_step, build_train_step
from repro_torch.models import build_model, get_config, layers, list_archs
from repro_torch.models import lm as lm_mod
from repro_torch.models.carry import (cache_from_reference,
                                      opt_from_reference, opt_to_reference,
                                      params_from_reference,
                                      params_to_reference, reference_paths,
                                      reference_tree, to_host, tree_items)

VLM, AUDIO = "qwen2-vl-2b", "hubert-xlarge"
ARCHS = [VLM, AUDIO]
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


def _ref_batch(cfg, seed: int = 1, seq: int = S) -> dict:
    """``repro``'s make_batch as numpy arrays."""
    return {k: np.asarray(v) for k, v in ref_specs.make_batch(
        cfg, B, seq, jax.random.PRNGKey(seed)).items()}


def _jb(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch) -> dict:
    return {k: _t(v) for k, v in batch.items()}


_CASES, _PARAMS = {}, {}


def _case(arch: str, compute: str):
    """(cfg, ref api with jitted forward and decode, ref params (float32),
    port model, numpy batch), built once per (arch, compute)."""
    key = (arch, compute)
    if key not in _CASES:
        cfg = _cfg(arch, compute)
        api = ref_build_model(cfg)
        api = dataclasses.replace(
            api, forward=jax.jit(api.forward, static_argnames=(
                "mesh", "remat", "flash")),
            decode_step=(None if api.decode_step is None else jax.jit(
                api.decode_step, static_argnames=("mesh",))))
        if arch not in _PARAMS:
            _PARAMS[arch] = api.init(jax.random.PRNGKey(0))[0]
        params = _PARAMS[arch]
        model = params_from_reference(cfg, jax.tree.map(np.asarray, params))
        _CASES[key] = (cfg, api, params, model, _ref_batch(cfg))
    return _CASES[key]


def _atol(compute: str) -> float:
    return F32_ATOL if compute == "float32" else BF16_ATOL


def _zero_patch(cfg, tokens: np.ndarray) -> dict:
    """A text-only vlm prompt: no patches, three equal M-RoPE streams."""
    b, n = tokens.shape
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (3, b, n))
    return {"tokens": tokens,
            "patches": np.zeros((b, 0, cfg.d_model), np.float32),
            "positions": np.ascontiguousarray(pos)}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype, hd, sections):
    rng = np.random.default_rng(hd)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xj = jnp.asarray(rng.normal(size=(2, 6, 3, hd)), jdt)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype))
    # temporal, height and width streams that differ, up to the serving
    # prompt's length
    pos = rng.integers(0, 4096, size=(3, 2, 6)).astype(np.int32)
    want = ref_layers.apply_mrope(xj, jnp.asarray(pos), 1e6, sections)
    got = layers.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # three equal streams: RoPE, bit for bit
    same = np.broadcast_to(pos[:1], pos.shape)
    assert torch.equal(
        layers.apply_mrope(xt, torch.from_numpy(np.array(same)), 1e6,
                           sections),
        layers.apply_rope(xt, torch.from_numpy(pos[0]), 1e6))
    with pytest.raises(ValueError, match="sum to"):
        layers.apply_mrope(xt, torch.from_numpy(pos), 1e6, (4, 4, 4))


# ---------------------------------------------------------------------------
# configs, registry, batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    mine, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert mine.padded_vocab == ref.padded_vocab
    assert mine.param_count() == ref.param_count()
    assert arch in list_archs()


@pytest.mark.parametrize("arch,expected_b", [(VLM, 1.5), (AUDIO, 1.0)])
def test_param_counts_match_published(arch, expected_b):
    n = get_config(arch).param_count() / 1e9
    assert 0.7 * expected_b <= n <= 1.35 * expected_b, (arch, n)


def test_registry_gives_an_encoder_no_decode_step():
    api = build_model(get_config(AUDIO).reduced())
    assert api.decode_step is None and api.init_cache is None
    ref = ref_build_model(ref_get_config(AUDIO).reduced())
    assert ref.decode_step is None and ref.init_cache is None
    vlm = build_model(get_config(VLM).reduced())
    assert vlm.decode_step is not None and vlm.init_cache is not None
    # the audio head is its own table, the vlm head the embedding
    audio_lm, vlm_lm = api.abstract_init(), vlm.abstract_init()
    assert audio_lm.embed is None and audio_lm.head.shape == (128, 512)
    assert vlm_lm.head is None and vlm_lm.embed.shape == (512, 128)
    full = build_model(AUDIO).abstract_init()
    assert full.head.shape == (1280, 512)          # vocab 504, padded


@pytest.mark.parametrize("seq", [32, 40, 4096])
def test_vlm_split_and_positions_match_reference(seq):
    for cfg in (get_config(VLM), get_config(VLM).reduced()):
        assert specs.vlm_split(cfg, seq) == ref_specs.vlm_split(cfg, seq)
        got = specs._vlm_positions(cfg, 2, seq)
        want = ref_specs._vlm_positions(cfg, 2, seq)
        assert got.dtype == np.int32 and got.shape == (3, 2, seq)
        np.testing.assert_array_equal(got, want)
    # full width: 1024 patches on a 32 x 32 grid, text from 32 on
    pos = specs._vlm_positions(get_config(VLM), 1, 4096)
    assert pos[:, 0, 1023].tolist() == [0, 31, 31]
    assert pos[:, 0, 1024].tolist() == [32, 32, 32]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_reference_shapes(arch):
    cfg = get_config(arch).reduced()
    a = specs.make_batch(cfg, B, S, torch.Generator().manual_seed(5))
    b = specs.make_batch(cfg, B, S, torch.Generator().manual_seed(5))
    c = specs.make_batch(cfg, B, S, torch.Generator().manual_seed(6))
    want = _ref_batch(cfg)
    assert sorted(a) == sorted(want)
    for k, v in want.items():
        assert tuple(a[k].shape) == v.shape, k
        assert str(a[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert torch.equal(a[k], b[k]), k
    lab = a["labels"]
    if arch == VLM:
        P = specs.vlm_split(cfg, S)[0]
        assert P == cfg.n_patches == 16
        assert a["tokens"].shape == (B, S - P)
        assert bool((lab[:, :P] == -100).all())
        np.testing.assert_array_equal(a["positions"].numpy(),
                                      want["positions"])
        assert not torch.equal(a["patches"], c["patches"])
        assert 0 <= int(a["tokens"].min()) <= int(a["tokens"].max()) \
            < cfg.vocab_size
        lab = lab[:, P:]
    else:
        assert not torch.equal(a["frames"], c["frames"])
        assert abs(float(a["frames"].std()) - 1.0) < 0.1
    assert 0 <= int(lab.min()) <= int(lab.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py::TestArchSmoke
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
class TestArchSmoke:
    def test_forward_and_train_step(self, arch):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        model = api.init(torch.Generator().manual_seed(0))
        batch = specs.make_batch(cfg, B, S, torch.Generator().manual_seed(1))
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
        """Every leaf of the reference's abstract parameters has one port
        parameter per layer of its shape and type, nothing left over."""
        cfg = get_config(arch).reduced()
        shapes, _ = ref_build_model(cfg).abstract_init(jax.random.PRNGKey(0))
        want = {p: (tuple(s.shape), str(s.dtype))
                for p, s in tree_items(shapes)}
        by_name = dict(build_model(cfg).abstract_init().named_parameters())
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
        if not cfg.is_decoder:
            assert api.decode_step is None and api.init_cache is None
            return
        model = api.init(torch.Generator().manual_seed(0))
        cache, _ = api.init_cache(B, 16)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        for pos in range(3):
            logits, cache = api.decode_step(model, cache, tok, pos)
            assert logits.shape == (B, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits.float()).all())
            tok = logits.argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# prefill, decode, carried weights and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, compute, flash):
    cfg, api, params, model, batch = _case(arch, compute)
    want = api.forward(params, _jb(batch), flash=flash)
    got = build_model(cfg).forward(model, _tb(batch), flash=flash)
    assert got.shape == (B, S, cfg.vocab_size)
    assert got.dtype == getattr(torch, compute)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_atol(compute))


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_branch_where_the_reference_takes_it(arch, monkeypatch):
    """qwen2-vl (causal, 12 % 6 == 0 at full width) reaches the flash
    wrapper once per layer; hubert (not causal) never does."""
    cfg, _, _, model, batch = _case(arch, "float32")
    calls = []
    real = fa_ops.flash_attention_plain
    monkeypatch.setattr(fa_ops, "flash_attention_plain",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or real(*a, **kw))
    build_model(cfg).forward(model, _tb(batch), flash=True)
    want = cfg.n_layers if arch == VLM else 0
    assert len(calls) == want
    assert all(s == (B, S, cfg.n_heads, cfg.resolved_head_dim)
               for s in calls)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_vlm_decode_matches_reference(compute):
    """Three decode steps in both packages: logits at every step, and the
    caches after the last."""
    cfg, api, params, model, batch = _case(VLM, compute)
    port = build_model(cfg)
    ref_cache, _ = api.init_cache(B, 8)
    cache, axes = port.init_cache(B, 8)
    assert cache["k"].shape == (cfg.n_layers, B, 8, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    assert axes["k"][0] == "layers"
    tokens = batch["tokens"]
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        want, ref_cache = api.decode_step(params, ref_cache,
                                          jnp.asarray(tok), pos)
        got, cache = port.decode_step(model, cache, _t(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_atol(compute))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]),
                                   rtol=0, atol=_atol(compute))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_vlm_teacher_forced_decode_equals_zero_patch_prefill(compute):
    """A vlm decode step embeds text only and turns all three M-RoPE
    streams by the cache index (the reference's design), so feeding a
    prompt one token at a time reproduces the prefill of that prompt with
    no patches and equal streams, in both packages. A make_batch prompt
    (patches first, text positions from the grid's side on) does not."""
    cfg, api, params, model, batch = _case(VLM, compute)
    port = build_model(cfg)
    n = 8
    tokens = batch["tokens"][:, :n]
    prompt = _zero_patch(cfg, tokens)
    fwd = port.forward(model, _tb(prompt))
    ref_fwd = api.forward(params, _jb(prompt))
    np.testing.assert_allclose(_np(fwd), _np(ref_fwd), rtol=0,
                               atol=_atol(compute))
    cache, _ = port.init_cache(B, n)
    outs = []
    for t in range(n):
        lg, cache = port.decode_step(model, cache, _t(tokens[:, t:t + 1]), t)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(fwd), rtol=0, atol=1e-4)
    # the patches and grid positions of a make_batch prompt move the text
    P = specs.vlm_split(cfg, S)[0]
    with_patches = port.forward(model, _tb(batch))[:, P:P + n]
    assert float((with_patches.float() - dec.float()).abs().max()) > 1e-2


def test_vlm_cache_carried_mid_decode():
    """A decode begun in the reference continues in the port."""
    cfg, api, params, model, batch = _case(VLM, "float32")
    tokens = batch["tokens"]
    ref_cache, _ = api.init_cache(B, 6)
    for pos in range(2):
        _, ref_cache = api.decode_step(params, ref_cache,
                                       jnp.asarray(tokens[:, pos:pos + 1]),
                                       pos)
    cache = cache_from_reference(cfg, jax.tree.map(np.asarray, ref_cache))
    want, _ = api.decode_step(params, ref_cache, jnp.asarray(tokens[:, 2:3]),
                              2)
    got, _ = build_model(cfg).decode_step(model, cache, _t(tokens[:, 2:3]), 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


def test_audio_has_no_decode_step_in_either_package():
    cfg, _, params, model, _ = _case(AUDIO, "float32")
    tok = np.zeros((B, 1), np.int32)
    with pytest.raises(ValueError, match="encoder-only"):
        ref_lm.decode_step(cfg, params, {}, jnp.asarray(tok), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        lm_mod.decode_step(cfg, model, {}, _t(tok), 0)
    with pytest.raises(AssertionError, match="no decode step"):
        ref_build_serve_step(ref_build_model(cfg),
                             make_rules(ref_single_device_mesh()),
                             batch=B, max_len=8)
    with pytest.raises(ValueError, match="no decode step"):
        build_serve_step(build_model(cfg), single_device_mesh(), batch=B,
                         max_len=8)


def test_vlm_serve_step_is_the_decode_step():
    cfg, _, _, model, _ = _case(VLM, "bfloat16")
    api = build_model(cfg)
    serve, info = build_serve_step(api, single_device_mesh(), batch=B,
                                   max_len=8)
    assert info["cache_shapes"]["k"] == (cfg.n_layers, B, 8, cfg.n_kv_heads,
                                         cfg.resolved_head_dim)
    c1, _ = api.init_cache(B, 8)
    c2, _ = api.init_cache(B, 8)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    a, _ = serve(model, c1, tok, 0)
    b, _ = api.decode_step(model, c2, tok, 0)
    assert torch.equal(a, b)


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
    stacked tree) and the port's compute copy; remat "dots". The vlm
    labels are -100 over the patches, so their loss is the text's."""
    cfg, api, params, model, batch = _case(arch, compute)
    tc = _to_compute(jnp.dtype(compute))
    jb = _jb(batch)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_fn(jax.tree.map(tc, p), jb, None,
                              remat="dots")))(params)
    _, info, _ = build_train_step(build_model(cfg), TrainConfig(remat="dots"))
    loss, grads = info["value_and_grad"](model, _tb(batch))
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
def test_three_train_steps_match_reference(arch):
    """float32 compute, AdamW, remat "dots", a new batch each step,
    against repro's own ``build_train_step`` on its one-device mesh."""
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
        batch = _ref_batch(cfg, seed=10 + t)
        r_p, r_o, r_e, r_m, r_c = ref_step(r_p, r_o, r_e, _jb(batch),
                                           jax.random.PRNGKey(t))
        model, opt, _, m, c = step(model, opt, {}, _tb(batch),
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
    """hubert's tree (head, layers, norm_f; no embed) and qwen2-vl's
    (embed and no head) carry both ways, with their optimizer state."""
    cfg, _, params, model, _ = _case(arch, "float32")
    tree = jax.tree.map(np.asarray, params)
    assert ("embed" in tree, "head" in tree) == \
        ((True, False) if arch == VLM else (False, True))
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


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_vlm_audio_modules_import_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "import repro_torch\n"
        "from repro_torch.launch.specs import make_batch\n"
        "from repro_torch.models import build_model, get_config\n"
        "with repro_torch.use_device('cpu'):\n"
        "    for arch in ('qwen2-vl-2b', 'hubert-xlarge'):\n"
        "        cfg = get_config(arch).reduced()\n"
        "        api = build_model(cfg)\n"
        "        m = api.init(torch.Generator().manual_seed(0))\n"
        "        b = make_batch(cfg, 1, 8, torch.Generator().manual_seed(1))\n"
        "        out = api.forward(m, b, flash=True)\n"
        "        assert out.shape == (1, 8, cfg.vocab_size)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " or m == 'repro' or m.startswith('repro.')"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"

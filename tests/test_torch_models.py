"""Port vs reference, dense-LM serving: layers, prefill forward (plain and
flash attention), KV-cache decode, and the weights carried across.

Weights come from ``repro``'s own ``api.init`` and go into the port
through ``repro_torch.models.carry``; tokens come from ``repro``'s
``make_batch``. Both packages then run the same reduced configurations
on the CPU (``repro``'s flash branch in Pallas interpret mode, the
port's through the kernel's plain version).

Tolerances, each with its reason:

* float32 compute (``dataclasses.replace(cfg, compute_dtype="float32")``):
  logits within ``1e-4`` absolute — summation order of float32 matmuls
  and softmax only; shows the algorithm is the same.
* bfloat16 compute (the configs' own): logits within ``BF16_ATOL`` =
  ``6e-2`` absolute. XLA and PyTorch round bf16 at different points (XLA
  fuses elementwise chains such as rmsnorm's ``cast * gamma`` and silu
  in float32); one rounding step of a logit near 2.7, the largest here,
  is 2^-7, and the largest difference seen on these inputs is 0.031
  (float32 compute: 2.9e-6), so the bound is twice that.
* teacher-forced decode against the port's own forward: ``1e-4``, the
  reference's bound for the same check (tests/test_arch_smoke.py).
* layers: float32 ``1e-6`` (RoPE and SwiGLU ``1e-5``); bfloat16 one
  rounding step (``2e-2``).
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
from repro.launch.specs import make_batch as ref_make_batch
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.models.registry import list_archs as ref_list_archs
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.specs import make_batch
from repro_torch.models import build_model, get_config, layers, list_archs
from repro_torch.models.carry import (cache_from_reference,
                                      params_from_reference)
from repro_torch.models.registry import NOT_PORTED

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src")

DENSE = ["granite-3-8b", "granite-8b", "llama3-8b", "phi4-mini-3.8b"]
# untied 128k-vocab and tied padded-vocab (200 064 -> 200 192 in full size)
ARCHS = ["llama3-8b", "phi4-mini-3.8b"]
F32_ATOL = 1e-4
BF16_ATOL = 6e-2
B, S = 2, 32


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield
    assert fa_kernel.launches == 0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfg(arch: str, compute: str):
    cfg = ref_get_config(arch).reduced()
    return dataclasses.replace(cfg, compute_dtype=compute)


_CASES = {}


def _case(arch: str, compute: str):
    """(cfg, ref api, ref params, port LM, ref batch, port batch), built
    once per (arch, compute) for the whole file."""
    key = (arch, compute)
    if key not in _CASES:
        cfg = _cfg(arch, compute)
        api = ref_build_model(cfg)
        params, _ = api.init(jax.random.PRNGKey(0))
        batch = ref_make_batch(cfg, B, S, jax.random.PRNGKey(1))
        tree = jax.tree.map(np.asarray, params)
        port_cfg = dataclasses.replace(get_config(arch).reduced(),
                                       compute_dtype=compute)
        with repro_torch.use_device("cpu"):
            lm = params_from_reference(port_cfg, tree)
        tokens = torch.from_numpy(np.array(batch["tokens"]))
        _CASES[key] = (port_cfg, api, params, lm, batch, {"tokens": tokens})
    return _CASES[key]


def _atol(compute: str) -> float:
    return F32_ATOL if compute == "float32" else BF16_ATOL


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_references(arch):
    mine, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert mine.padded_vocab == ref.padded_vocab
    assert mine.param_count() == ref.param_count()
    assert mine.param_count(active_only=True) == \
        ref.param_count(active_only=True)


def test_shapes_and_llama_width():
    from repro.configs.base import SHAPES as REF_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    cfg = get_config("llama3-8b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.rope_theta) == \
        (4096, 32, 8, 128, 14336, 128_256, 500_000.0)
    assert get_config("phi4-mini-3.8b").padded_vocab == 200_192
    assert list_archs() == ref_list_archs()
    assert len(list_archs()) == 10 and NOT_PORTED == {}


@pytest.mark.parametrize("arch", ref_list_archs())
def test_every_reference_arch_builds(arch):
    """Each of the reference's archs: the port's config equals the
    reference's field for field, and its model builds on ``meta`` with
    one parameter per leaf of the reference's abstract parameters."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(arch))
    api = build_model(arch)
    meta = api.abstract_init()
    assert all(p.device.type == "meta" for p in meta.parameters())
    n = sum(p.numel() for p in meta.parameters())
    assert n > 0.5 * cfg.param_count(), (arch, n, cfg.param_count())
    assert (api.decode_step is None) == (not cfg.is_decoder)


def test_registry_unknown_arch_and_remat():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    cfg = get_config("llama3-8b").reduced()
    api = build_model(cfg)
    lm = api.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 1, 8, torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="remat"):
        api.forward(lm, batch, remat="dots")


def test_entry_points_default_to_the_card():
    """Without use_device the model API asks for the card, and raises on
    a host that has none; nothing carries on on the CPU by itself."""
    from repro_torch import device as device_mod
    api = build_model(get_config("llama3-8b").reduced())
    saved, device_mod._selected = device_mod._selected, None
    try:
        if torch.cuda.is_available():
            assert repro_torch.get_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="use_device"):
                api.init(torch.Generator().manual_seed(0))
            with pytest.raises(RuntimeError, match="use_device"):
                api.init_cache(1, 8)
    finally:
        device_mod._selected = saved


def test_make_batch_is_seeded_and_in_range():
    cfg = get_config("phi4-mini-3.8b").reduced()
    a = make_batch(cfg, 3, 10, torch.Generator().manual_seed(5))
    b = make_batch(cfg, 3, 10, torch.Generator().manual_seed(5))
    assert a["tokens"].shape == a["labels"].shape == (3, 10)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab_size
    audio = make_batch(get_config("hubert-xlarge"), 1, 4,
                       torch.Generator().manual_seed(0))
    assert sorted(audio) == ["frames", "labels"]
    assert audio["frames"].shape == (1, 4, 1280)
    assert audio["frames"].dtype == torch.float32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)

    def pair(shape, scale=1.0):
        xj = jnp.asarray(rng.normal(size=shape) * scale, jdt)
        return xj, torch.from_numpy(np.array(xj, np.float32)).to(tdt)

    xj, xt = pair((2, 5, 64), 3.0)
    gj = jnp.asarray(rng.normal(size=(64,)), jnp.float32)
    gt = torch.from_numpy(np.array(gj))
    got = layers.rmsnorm(xt, gt, 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(ref_layers.rmsnorm(xj, gj, 1e-5)),
                               **tol)

    # RoPE at llama3's theta and positions up to the serving prompt length
    qj, qt = pair((2, 6, 3, 32))
    pos = np.array([[0, 1, 2, 3, 4, 5], [4090, 4091, 4092, 4093, 4094, 4095]],
                   np.int32)
    want = ref_layers.apply_rope(qj, jnp.asarray(pos), 500_000.0)
    got = layers.apply_rope(qt, torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == "float32" else tol))
    np.testing.assert_allclose(
        _np(layers.rope_freqs(128, 500_000.0)),
        _np(ref_layers.rope_freqs(128, 500_000.0)), rtol=1e-7, atol=0)

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), d_ff=96)
    ffn = layers.SwiGLU(cfg)
    ffn.init_(torch.Generator().manual_seed(2))
    pj = {n: jnp.asarray(getattr(ffn, n).numpy())
          for n in ("w_gate", "w_up", "w_down")}
    hj, ht = pair((2, 4, cfg.d_model))
    np.testing.assert_allclose(_np(layers.swiglu_apply(ffn, ht)),
                               _np(ref_layers.swiglu_apply(pj, hj)),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == "float32" else tol))


# ---------------------------------------------------------------------------
# the model: forward, decode, carried weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, compute, flash):
    cfg, api, params, lm, batch, tbatch = _case(arch, compute)
    want = api.forward(params, batch, flash=flash)
    got = build_model(cfg).forward(lm, tbatch, flash=flash)
    assert got.shape == (B, S, cfg.vocab_size)
    assert got.dtype == getattr(torch, compute)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_atol(compute))


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_branch_where_the_reference_takes_it(arch, monkeypatch):
    """forward(flash=True) reaches the flash wrapper once per layer when
    S % 8 == 0, never otherwise (the reference's flash_applicable), and
    the ragged prompt still matches the reference's forward."""
    cfg, api, params, lm, batch, _ = _case(arch, "float32")
    calls = []
    real = fa_ops.flash_attention_plain
    monkeypatch.setattr(fa_ops, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    port = build_model(cfg)
    tokens = np.array(batch["tokens"])
    port.forward(lm, {"tokens": torch.from_numpy(tokens)}, flash=True)
    assert len(calls) == cfg.n_layers
    calls.clear()
    ragged = tokens[:, :S - 3]
    got = port.forward(lm, {"tokens": torch.from_numpy(ragged)}, flash=True)
    assert calls == []
    want = api.forward(params, {"tokens": jnp.asarray(ragged)}, flash=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    port.forward(lm, {"tokens": torch.from_numpy(tokens)}, flash=False)
    assert calls == []


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, compute):
    """Three decode steps on the same tokens in both packages: logits at
    every step and the caches after the last."""
    cfg, api, params, lm, batch, _ = _case(arch, compute)
    port = build_model(cfg)
    max_len = 8
    ref_cache, _ = api.init_cache(B, max_len)
    cache, axes = port.init_cache(B, max_len)
    assert cache["k"].shape == (cfg.n_layers, B, max_len, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    assert cache["k"].dtype == getattr(torch, compute)
    assert axes["k"][0] == "layers"
    tokens = np.array(batch["tokens"])
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        want, ref_cache = api.decode_step(params, ref_cache,
                                          jnp.asarray(tok), pos)
        got, cache = port.decode_step(lm, cache, torch.from_numpy(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_atol(compute))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]),
                                   rtol=0, atol=_atol(compute))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_equals_forward(arch, compute):
    """Feeding the prompt one token at a time reproduces the plain
    forward's logits at every position (tests/test_arch_smoke.py's
    check, in the port)."""
    cfg, _, _, lm, _, tbatch = _case(arch, compute)
    port = build_model(cfg)
    n = 8
    ref = port.forward(lm, {"tokens": tbatch["tokens"][:, :n]})
    cache, _ = port.init_cache(B, n)
    outs = []
    for t in range(n):
        lg, cache = port.decode_step(lm, cache,
                                     tbatch["tokens"][:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(ref), rtol=0, atol=1e-4)


def test_cache_carried_mid_decode():
    """A decode begun in the reference continues in the port: carry the
    reference's params and its cache after two steps, take the third
    step in both."""
    cfg, api, params, lm, batch, _ = _case("llama3-8b", "float32")
    ref_cache, _ = api.init_cache(B, 6)
    tokens = np.array(batch["tokens"])
    for pos in range(2):
        _, ref_cache = api.decode_step(params, ref_cache,
                                       jnp.asarray(tokens[:, pos:pos + 1]),
                                       pos)
    cache = cache_from_reference(cfg, jax.tree.map(np.asarray, ref_cache))
    want, _ = api.decode_step(params, ref_cache, jnp.asarray(tokens[:, 2:3]),
                              2)
    got, _ = build_model(cfg).decode_step(lm, cache,
                                          torch.from_numpy(tokens[:, 2:3]), 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    bf = _cfg("llama3-8b", "bfloat16")
    ref_bf, _ = ref_build_model(bf).init_cache(1, 4)
    carried = cache_from_reference(bf, jax.tree.map(np.asarray, ref_bf))
    assert carried["v"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cache k"):
        cache_from_reference(cfg, {"k": np.zeros((1, 2, 3)), "v": None})


def test_carry_rejects_a_tree_that_does_not_fit():
    cfg, _, params, _, _, _ = _case("phi4-mini-3.8b", "float32")
    tree = jax.tree.map(np.asarray, params)
    assert "head" not in tree          # tied: the embedding is the head
    with pytest.raises(ValueError, match="expected"):
        params_from_reference(cfg, dict(tree, head=np.zeros((1, 1))))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(cfg, bad)
    lm = params_from_reference(cfg, tree)
    assert lm.embed.shape == (cfg.padded_vocab, cfg.d_model)
    assert lm.head is None
    np.testing.assert_array_equal(
        lm.layers[1].attn.wk.numpy(), tree["layers"]["attn"]["wk"][1])


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_model_slice_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.launch\n"
        "import repro_torch.models.lm, repro_torch.models.layers\n"
        "import repro_torch.models.carry, repro_torch.launch.specs\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.flash_attention.ref\n"
        "from repro_torch.models import get_config, list_archs\n"
        "[get_config(a) for a in list_archs()]\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " or m == 'repro' or m.startswith('repro.')"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


def test_model_slice_sources_name_neither_jax_nor_repro():
    """Source text of every module this slice added: no import of jax or
    repro, and the configs import nothing of the reference's either."""
    import re
    forbidden = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)
    base = os.path.join(SRC, "repro_torch")
    files = []
    for sub in ("configs", "models", "launch",
                os.path.join("kernels", "flash_attention")):
        for name in sorted(os.listdir(os.path.join(base, sub))):
            if name.endswith(".py"):
                files.append(os.path.join(base, sub, name))
    files.append(os.path.join(base, "kernels", "csrc", "flash_attention.cu"))
    names = [os.path.basename(f) for f in files]
    assert {"moe.py", "mla.py", "deepseek_v2_lite_16b.py",
            "kimi_k2_1t_a32b.py"} <= set(names)
    assert len(files) >= 21
    for path in files:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        hit = forbidden.search(text)
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"
        assert "repro.configs" not in text, path
    assert isinstance(get_config("granite-8b"), ModelConfig)

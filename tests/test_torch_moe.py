"""Port vs reference, the moe family: deepseek-v2-lite-16b (mixture of
experts with latent attention, MLA) and kimi-k2-1t-a32b (mixture of
experts with GQA attention) at their ``reduced()`` sizes. The router, the
dense expert path, the one-card expert-parallel path (the trainer's),
MLA's prefill and absorbed decode, the whole model's forward and decode,
the carried weights and caches, and the training path with its slots and
ledgers.

Weights come from ``repro``'s own ``api.init`` and go into the port
through ``repro_torch.models.carry``; tokens and activations are drawn
from numpy seeds and handed to both packages. Everything runs on the CPU
(the port's flash branch through the kernel's plain version, ``repro``'s
in Pallas interpret mode).

Top-k routing makes the bf16 comparison of a whole MoE model depend on
its inputs: after the first layer the two packages' bf16 hidden states
differ by about an ulp (they round at other points), and a token whose
K-th and (K+1)-th router probabilities are that close may pick another
expert in each package, which moves its logits far beyond a rounding
bound (readings: 0.28-0.70 on logits near 2.9). So the port is held to
the reference in two ways, neither of which rests on a choice of seed:

* float32 compute (``compute_dtype="float32"``), the whole model: the
  routing ids equal at every layer, logits within ``F32_ATOL`` = 1e-4
  (summation order only; readings 3.5e-6 and 4.6e-6), for three seeds.
* bfloat16 compute, layer by layer: each port layer takes the reference
  layer's own input (and, in decode, its cache). The routing ids must be
  equal on every token whose reference probability margin (K-th minus
  (K+1)-th) exceeds ``MARGIN`` = 1e-2; the tokens below it that flip are
  counted, printed, and must stay under ``FLIP_SHARE`` = 5 % (readings:
  none flipped). Outputs of the tokens routed alike are held to two bf16
  ulps of the layer's largest output (``2**-6 * max|out|``; readings at
  most one ulp, 0.0625 at outputs up to 9.1): the residual stream holds
  values up to 9, so an output near zero inherits the rounding of its
  terms, not its own.

Teacher-forced decode against the forward of the same package: ``1e-4``
in float32, the bound of the reference's own
``test_decode_matches_forward_dense``, in both packages. kimi-k2's GQA
decode gives its bf16 forward exactly in both (gap 0.0), so it keeps
``1e-4`` in bf16 too. MLA's decode takes another path than its prefill
(weights absorbed into the query and the output, probabilities rounded
to bf16 before the context product), so in bf16 decode and forward
differ by about an ulp after the first layer, and routing flips between
them make the whole model's gap a matter of the input, in the reference
as in the port: on deepseek reduced, ten seeded inputs (weights and
tokens of seeds 0-9, 8 tokens) gave the reference 0.039-1.28 and the port
0.036-0.46 on logits near 2.5. So in bf16 the check is layer by layer, in
each package, by the margin rule and the two-ulp bound above.
"""

import contextlib
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
from repro.launch.train import ADCCTrainer as RefADCCTrainer
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.launch.steps import tree_checksums as ref_tree_checksums
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.optim import adamw as ref_adamw
from repro.optim import init_error_state as ref_init_error_state
from repro.sharding.partition import make_rules
from repro_torch.configs.base import TrainConfig
from repro_torch.core.acc_state import flatten_checksums
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.mesh import Mesh, single_device_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import ADCCTrainer
from repro_torch.models import build_model, get_config, list_archs
from repro_torch.models import lm, mla, moe
from repro_torch.models.carry import (cache_from_reference,
                                      opt_from_reference, opt_to_reference,
                                      params_from_reference,
                                      params_to_reference, reference_paths,
                                      reference_tree, to_host, tree_items)

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
SEEDS = [0, 1, 2]
B, S = 2, 32
F32_ATOL = 1e-4
MARGIN = moe.ROUTING_MARGIN            # 1e-2
FLIP_SHARE = moe.ROUTING_FLIP_SHARE    # 5 %

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


def _t(x, dtype=None) -> torch.Tensor:
    """A jax or numpy array as a CPU tensor with the same values."""
    out = torch.from_numpy(np.array(_np(x)))
    return out if dtype is None else out.to(dtype)


def _cfg(arch: str, compute: str = "bfloat16"):
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype=compute)


_CASES, _PARAMS, _APIS = {}, {}, {}


def _case(arch: str, compute: str, seed: int = 0):
    """(cfg, ref api, ref params, port LM, tokens (B, S) int32), built once
    per (arch, compute, seed) for the whole file. The reference's forward
    and decode step are jitted (the same functions, compiled once per
    (arch, compute) and shared by the seeds)."""
    key = (arch, compute, seed)
    if key not in _CASES:
        cfg = _cfg(arch, compute)
        if (arch, compute) not in _APIS:
            api = ref_build_model(cfg)
            _APIS[arch, compute] = dataclasses.replace(
                api, forward=jax.jit(api.forward, static_argnames=(
                    "mesh", "remat", "flash")),
                decode_step=jax.jit(api.decode_step,
                                    static_argnames=("mesh",)))
        api = _APIS[arch, compute]
        if (arch, seed) not in _PARAMS:     # float32 either way
            _PARAMS[arch, seed] = api.init(jax.random.PRNGKey(seed))[0]
        params = _PARAMS[arch, seed]
        tokens = np.random.default_rng(100 + seed).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        lm_ = params_from_reference(cfg, jax.tree.map(np.asarray, params))
        _CASES[key] = (cfg, api, params, lm_, tokens)
    return _CASES[key]


def _positions(n: int, start: int = 0):
    pos = np.broadcast_to(np.arange(start, start + n), (B, n)).astype(np.int32)
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def _layer_params(params, i: int):
    return jax.tree.map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# routing records: what each package's router chose, layer after layer
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _routing():
    """Records every router call of both packages: the reference's ids
    and probabilities (its layers must run eagerly, not under a scan),
    the port's ids."""
    rec = {"ref": [], "port": []}
    real_ref, real_port = ref_moe.router_topk, moe.router_topk

    def ref_topk(cfg, w, x):
        out = real_ref(cfg, w, x)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ w.astype(jnp.float32),
                               axis=-1)
        rec["ref"].append((np.asarray(out[1]), np.asarray(probs)))
        return out

    def port_topk(cfg, w, x):
        out = real_port(cfg, w, x)
        rec["port"].append(out[1].numpy())
        return out

    ref_moe.router_topk, moe.router_topk = ref_topk, port_topk
    try:
        yield rec
    finally:
        ref_moe.router_topk, moe.router_topk = real_ref, real_port


def _margin(cfg, probs) -> np.ndarray:
    """Per token, its K-th minus its (K+1)-th router probability."""
    return moe.routing_margin(cfg, torch.from_numpy(np.array(probs))
                              ).numpy()


def _same_routing(cfg, ref_ids, ref_probs, port_ids,
                  margin: float = MARGIN) -> np.ndarray:
    """Per token, whether both packages chose the same set of experts.
    Every token whose reference margin exceeds ``margin`` must agree; the
    others may flip (:func:`_flip_share` bounds how many)."""
    return moe.same_routing(cfg, torch.from_numpy(np.array(ref_ids)),
                            torch.from_numpy(np.array(ref_probs)),
                            torch.from_numpy(np.array(port_ids)),
                            margin=margin).numpy()


def _flip_share(sames) -> None:
    """The tokens that flipped, over all of a test's routing decisions,
    printed and under FLIP_SHARE."""
    flips = moe.check_flip_share([torch.from_numpy(np.array(x))
                                  for x in sames])
    print(f"routing: {flips} of {sum(np.size(x) for x in sames)} "
          f"decisions flipped")


def _bf16_close(got, want) -> None:
    """Within two bf16 ulps of the largest value (see the module
    docstring)."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=2.0 ** -6 * float(np.abs(w).max()))


def _bf16_layer_close(got, want, same) -> None:
    """Outputs of the tokens routed alike within two bf16 ulps of the
    layer's largest output."""
    _bf16_close(_np(got).reshape(same.size, -1)[same],
                _np(want).reshape(same.size, -1)[same])


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
    assert mine.param_count(active_only=True) == \
        ref.param_count(active_only=True)
    assert arch in list_archs()


@pytest.mark.parametrize("arch,expected_b", [
    ("deepseek-v2-lite-16b", 16.0), ("kimi-k2-1t-a32b", 1000.0)])
def test_param_counts_match_published(arch, expected_b):
    n = get_config(arch).param_count() / 1e9
    assert 0.7 * expected_b <= n <= 1.35 * expected_b, (arch, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_have_the_references_shapes(arch):
    """Every leaf of the reference's abstract parameters has one port
    parameter per layer of the same shape, and nothing is left over."""
    cfg = get_config(arch).reduced()
    shapes, _ = ref_build_model(cfg).abstract_init(jax.random.PRNGKey(0))
    want = {p: tuple(s.shape) for p, s in tree_items(shapes)}
    meta = build_model(cfg).abstract_init()
    got = {}
    by_name = dict(meta.named_parameters())
    for path, names in reference_paths(cfg):
        shape = tuple(by_name[names[0]].shape)
        got[path] = (len(names),) + shape if path.startswith("layers/") \
            else shape
    assert got == want
    assert meta.layers[0].moe.router.dtype == torch.float32


# ---------------------------------------------------------------------------
# router and experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_topk_matches_reference(dtype):
    cfg = get_config("deepseek-v2-lite-16b")      # 64 experts, top 6
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(96, cfg.d_model)), jnp.dtype(dtype))
    w = jnp.asarray(rng.normal(size=(cfg.d_model, cfg.n_experts)) * 0.02,
                    jnp.float32)
    rw, rid = ref_moe.router_topk(cfg, w, x)
    tw, tid = moe.router_topk(cfg, _t(w), _t(x, getattr(torch, dtype)))
    assert tid.shape == (96, cfg.experts_per_token)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(rid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


def test_router_topk_breaks_ties_as_the_reference():
    """Equal probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` orders them: a hidden state of zeros (every expert
    equally likely), and a router whose columns repeat in pairs."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()      # 8 experts, top 2
    E, D, K = cfg.n_experts, cfg.d_model, cfg.experts_per_token
    rng = np.random.default_rng(4)
    # small integers: every logit is exact in any summation order, so
    # the repeated columns tie exactly
    half = rng.integers(-2, 3, size=(D, E // 2)).astype(np.float32) / 8
    for w, x in ((rng.normal(size=(D, E)).astype(np.float32),
                  np.zeros((5, D), np.float32)),
                 (np.repeat(half, 2, axis=1),
                  rng.integers(-2, 3, size=(7, D)).astype(np.float32))):
        rw, rid = ref_moe.router_topk(cfg, jnp.asarray(w), jnp.asarray(x))
        tw, tid = moe.router_topk(cfg, torch.from_numpy(w),
                                  torch.from_numpy(x))
        np.testing.assert_array_equal(tid.numpy(), np.asarray(rid))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
    # the zero state: ids 0..K-1, each weight 1/K
    assert tid.numpy().shape == (7, K)
    _, tid0 = moe.router_topk(cfg, torch.ones(D, E), torch.zeros(3, D))
    np.testing.assert_array_equal(tid0.numpy(), np.tile(np.arange(K), (3, 1)))
    # the pairs: both members of the top pair, the lower id first
    assert (tid.numpy()[:, 0] % 2 == 0).all()
    assert (tid.numpy()[:, 1] == tid.numpy()[:, 0] + 1).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_apply_dense_matches_reference(arch, compute):
    """Layer 0's experts on 64 random tokens. float32: ids equal, output
    within 1e-5 (summation order). bf16: the margin rule and two ulps."""
    cfg, _, params, lm_, _ = _case(arch, compute)
    jdt, tdt = jnp.dtype(compute), getattr(torch, compute)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(64, cfg.d_model)),
                    jdt)
    with _routing() as rec:
        want = ref_moe.moe_apply_dense(cfg, _layer_params(params, 0)["moe"], x)
        got = moe.moe_apply_dense(cfg, lm_.layers[0].moe, _t(x, tdt))
    assert got.dtype == tdt and got.shape == (64, cfg.d_model)
    (rid, probs), = rec["ref"]
    same = _same_routing(cfg, rid, probs, rec["port"][0])
    _flip_share([same])
    if compute == "float32":
        assert same.all()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    else:
        _bf16_layer_close(got, want, same)


def test_moe_backward_is_deterministic():
    """The combine matrix is built without a scatter: forward and backward
    under deterministic algorithms, twice, bitwise alike."""
    cfg, _, _, lm_, _ = _case("deepseek-v2-lite-16b", "float32")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(40, cfg.d_model)).astype(np.float32))
    p = lm_.layers[0].moe
    out = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            ws = [w.detach().clone().requires_grad_(True)
                  for w in (p.router, p.w_gate, p.w_up, p.w_down)]
            q = moe.MoE(cfg, device="meta")
            for name, w in zip(("router", "w_gate", "w_up", "w_down"), ws):
                setattr(q, name, torch.nn.Parameter(w))
            y = moe.moe_apply_dense(cfg, q, x)
            out.append([y] + list(torch.autograd.grad(y.square().sum(),
                                                      list(q.parameters()))))
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert float(out[0][1].abs().max()) > 0      # the router learns
    with pytest.raises(NotImplementedError, match="A10b.7"):
        moe.moe_apply_ep(cfg, p, x, mesh=object())


def _skewed_moe(cfg, seed: int, skew: float):
    """Reference MoE parameters whose router sends most tokens to experts
    0 and 1 (by ``skew``), the port's module holding them, and tokens."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    x = rng.normal(size=(64, D)).astype(np.float32)
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) * 0.02,
         "w_gate": rng.normal(size=(E, D, F)).astype(np.float32) * 0.05,
         "w_up": rng.normal(size=(E, D, F)).astype(np.float32) * 0.05,
         "w_down": rng.normal(size=(E, F, D)).astype(np.float32) * 0.05}
    p["router"][:, :2] += skew * np.sign(x.mean(0))[:, None]
    m = moe.MoE(cfg, device="cpu")
    for k, v in p.items():
        getattr(m, k).data.copy_(_t(v))
    return {k: jnp.asarray(v) for k, v in p.items()}, m, x


def test_moe_apply_ep_matches_reference_where_windows_overflow():
    """The one-card expert-parallel path against repro's ``moe_apply_ep``
    on ``single_device_mesh()``, float32, with a router skewed so that two
    experts take far more rows than their window (``cap`` 40 of 53 each):
    outputs equal within 1e-5 (reading 9e-8), the dropped rows' zeros
    included, and the drops counted. A mesh of several cards raises."""
    cfg = _cfg("deepseek-v2-lite-16b", "float32")
    jp, m, x = _skewed_moe(cfg, 0, 0.5)
    mesh = ref_single_device_mesh()
    want = np.asarray(ref_moe.moe_apply_ep(
        cfg, jp, jnp.asarray(x), mesh, token_axes=tuple(mesh.axis_names)))
    moe.EP_COUNTS.update(assignments=0, dropped=0)
    got = moe.moe_apply_ep(cfg, m, _t(x), single_device_mesh()).numpy()
    assert (moe.EP_COUNTS["assignments"], int(moe.EP_COUNTS["dropped"])) \
        == (128, 26)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dropped = np.abs(want).sum(axis=1) == 0
    assert dropped.sum() > 0 and (got[dropped] == 0).all()
    dense = moe.moe_apply_dense(cfg, m, _t(x)).numpy()
    assert np.abs(dense - got).max() > 0.1
    with pytest.raises(NotImplementedError, match="A10b.7"):
        moe.moe_apply_ep(cfg, m, _t(x), Mesh(("data", "model"), (1, 2)))
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.moe_apply_ep(cfg, m, _t(x), None)


def test_moe_apply_ep_equals_dense_at_generous_capacity():
    """With routing spread over the experts, no window overflows and the
    expert-parallel path gives the dense oracle's outputs (float32, 1e-5;
    the reference's own claim, src/repro/models/moe.py)."""
    cfg = _cfg("deepseek-v2-lite-16b", "float32")
    _, m, x = _skewed_moe(cfg, 1, 0.0)
    moe.EP_COUNTS.update(assignments=0, dropped=0)
    got = moe.moe_apply_ep(cfg, m, _t(x), single_device_mesh())
    assert int(moe.EP_COUNTS["dropped"]) == 0
    np.testing.assert_allclose(got.numpy(),
                               moe.moe_apply_dense(cfg, m, _t(x)).numpy(),
                               rtol=0, atol=1e-5)


def test_moe_apply_ep_backward_is_deterministic():
    """The sort, its inverse and the windows are gathers and slices:
    forward and backward under deterministic algorithms, twice, bitwise
    alike, and the router learns."""
    cfg = _cfg("deepseek-v2-lite-16b", "float32")
    _, m, x = _skewed_moe(cfg, 2, 0.5)
    out = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            q = copy.deepcopy(m)
            for w in q.parameters():
                w.requires_grad_(True)
            xt = _t(x).requires_grad_(True)
            y = moe.moe_apply_ep(cfg, q, xt, single_device_mesh())
            out.append([y] + list(torch.autograd.grad(
                y.square().sum(), [xt] + list(q.parameters()))))
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert float(out[0][2].abs().max()) > 0


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode_match_reference(compute):
    """Layer 0's attention: a prefill of S tokens (latent expanded into
    per-head K/V), then three absorbed decode steps against the latent
    cache; outputs and the cache after each step. float32 within 1e-5
    (summation order), bf16 within two ulps of the largest value."""
    cfg, _, params, lm_, _ = _case("deepseek-v2-lite-16b", compute)
    jdt, tdt = jnp.dtype(compute), getattr(torch, compute)
    p_ref, p = _layer_params(params, 0)["attn"], lm_.layers[0].attn
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jdt)
    jpos, tpos = _positions(S)
    close = (_bf16_close if compute == "bfloat16" else
             lambda g, w: np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                                     atol=1e-5))
    want, _ = ref_mla.mla_apply(cfg, p_ref, x, jpos)
    got, none = mla.mla_apply(cfg, p, _t(x, tdt), tpos)
    assert none is None and got.dtype == tdt
    close(got, want)

    max_len = 6
    ref_cache, _ = ref_mla.mla_cache_init(cfg, B, max_len)
    cache, axes = mla.mla_cache_init(cfg, B, max_len)
    assert cache["c_kv"].shape == (B, max_len, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (B, max_len, cfg.qk_rope_dim)
    assert cache["c_kv"].dtype == tdt and axes["c_kv"][-1] == "kv_lora"
    for step in range(3):
        xs = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), jdt)
        jp, tp = _positions(1, step)
        want, ref_cache = ref_mla.mla_apply(cfg, p_ref, xs, jp,
                                            cache=ref_cache,
                                            cache_index=step)
        got, cache = mla.mla_apply(cfg, p, _t(xs, tdt), tp, cache=cache,
                                   cache_index=step)
        close(got, want)
        for name in ("c_kv", "k_rope"):
            close(cache[name], ref_cache[name])


# ---------------------------------------------------------------------------
# the whole model: forward
# ---------------------------------------------------------------------------

def _ref_layers_eager(cfg, params, tokens, port_lm=None,
                      flash: bool = False):
    """The reference's forward layer by layer, outside its scan, so that
    its router calls can be recorded. With ``port_lm`` each port layer
    takes the reference layer's own input beside it. Returns
    [(input, reference output, port output or None, routing record)]."""
    dt = jnp.dtype(cfg.compute_dtype)
    h = jnp.take(params["embed"], jnp.asarray(tokens), axis=0).astype(dt)
    jpos, tpos = _positions(tokens.shape[1])
    out = []
    for i in range(cfg.n_layers):
        with _routing() as rec:
            want, _ = ref_lm._layer_apply(cfg, _layer_params(params, i), h,
                                          jpos, None, None, flash=flash)
            got = None if port_lm is None else lm._layer_apply(
                cfg, port_lm.layers[i],
                _t(h, getattr(torch, cfg.compute_dtype)),
                tpos, flash=flash)[0]
        out.append((h, want, got, rec))
        h = want
    return out


_ROUTES: list = []
_ROUTING_FNS: dict = {}


def _ref_routing_on_mesh(cfg, params, tokens):
    """The reference's forward layer by layer on its one-device mesh (the
    expert-parallel path, as its trainer runs it): per layer its router's
    (ids, probabilities). Its router runs inside ``shard_map``'s trace,
    so the record is taken by a debug callback, in a function jitted once
    per configuration."""
    if cfg not in _ROUTING_FNS:
        real = ref_moe.router_topk

        def spy(cfg_, w, x):
            out = real(cfg_, w, x)
            probs = jax.nn.softmax(x.astype(jnp.float32)
                                   @ w.astype(jnp.float32), axis=-1)
            jax.debug.callback(lambda i, p: _ROUTES.append(
                (np.asarray(i), np.asarray(p))), out[1], probs)
            return out

        def layers(params, tokens):
            mesh = ref_single_device_mesh()
            dt = jnp.dtype(cfg.compute_dtype)
            h = jnp.take(params["embed"], tokens, axis=0).astype(dt)
            jpos = jnp.broadcast_to(jnp.arange(tokens.shape[1]),
                                    tokens.shape)
            ref_moe.router_topk = spy       # while this function traces
            try:
                for i in range(cfg.n_layers):
                    h, _ = ref_lm._layer_apply(cfg, _layer_params(params, i),
                                               h, jpos, None, mesh)
            finally:
                ref_moe.router_topk = real
            return h

        _ROUTING_FNS[cfg] = jax.jit(layers)
    _ROUTES.clear()
    jax.block_until_ready(_ROUTING_FNS[cfg](params, jnp.asarray(tokens)))
    jax.effects_barrier()
    assert len(_ROUTES) == cfg.n_layers
    return list(_ROUTES)


def _check_bf16_layers(cfg, layers) -> None:
    sames = []
    for _, want, got, rec in layers:
        (rid, probs), = rec["ref"]
        same = _same_routing(cfg, rid, probs, rec["port"][0])
        assert got.dtype == torch.bfloat16
        _bf16_layer_close(got.reshape(same.size, -1), want, same)
        sames.append(same)
    _flip_share(sames)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_reference(arch, seed):
    """The whole model in float32: the same experts at every layer, and
    logits within F32_ATOL."""
    cfg, api, params, lm_, tokens = _case(arch, "float32", seed)
    ref_layers = _ref_layers_eager(cfg, params, tokens)
    with _routing() as rec:
        got = build_model(cfg).forward(lm_, {"tokens": torch.from_numpy(
            tokens)})
    assert len(rec["port"]) == cfg.n_layers
    for (_, _, _, ref_rec), pid in zip(ref_layers, rec["port"]):
        (rid, probs), = ref_rec["ref"]
        assert _same_routing(cfg, rid, probs, pid).all()
    want = api.forward(params, {"tokens": jnp.asarray(tokens)})
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_layer_by_layer(arch):
    """bf16: each port layer on the reference layer's own input."""
    cfg, api, params, lm_, tokens = _case(arch, "bfloat16")
    _check_bf16_layers(cfg, _ref_layers_eager(cfg, params, tokens, lm_))
    # and the whole bf16 forward: right shape and type, finite
    logits = build_model(cfg).forward(lm_,
                                      {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def test_kimi_flash_forward_matches_reference(monkeypatch):
    """kimi-k2 (GQA) takes the flash branch once per layer where the
    reference does (its Pallas kernel in interpret mode), and matches the
    reference's flash forward in float32; deepseek's MLA never does."""
    calls = []
    real = fa_ops.flash_attention_plain
    monkeypatch.setattr(fa_ops, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg, api, params, lm_, tokens = _case("kimi-k2-1t-a32b", "float32")
    got = build_model(cfg).forward(lm_, {"tokens": torch.from_numpy(tokens)},
                                   flash=True)
    assert len(calls) == cfg.n_layers
    want = api.forward(params, {"tokens": jnp.asarray(tokens)}, flash=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    calls.clear()
    cfg, api, params, lm_, tokens = _case("deepseek-v2-lite-16b", "float32")
    got = build_model(cfg).forward(lm_, {"tokens": torch.from_numpy(tokens)},
                                   flash=True)
    assert calls == []
    want = api.forward(params, {"tokens": jnp.asarray(tokens)}, flash=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


def test_kimi_flash_bf16_layer_by_layer():
    """kimi-k2 in bf16 with the flash branch, on each reference layer's
    own flash-forward input."""
    cfg, _, params, lm_, tokens = _case("kimi-k2-1t-a32b", "bfloat16")
    _check_bf16_layers(cfg, _ref_layers_eager(cfg, params, tokens, lm_,
                                              flash=True))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_float32_matches_reference(arch):
    """Three decode steps in both packages: logits at every step, the
    caches after the last."""
    cfg, api, params, lm_, tokens = _case(arch, "float32")
    port = build_model(cfg)
    max_len = 8
    ref_cache, _ = api.init_cache(B, max_len)
    cache, axes = port.init_cache(B, max_len)
    assert sorted(cache) == sorted(ref_cache)
    for name, c in cache.items():
        assert tuple(c.shape) == tuple(ref_cache[name].shape)
        assert axes[name][0] == "layers"
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        want, ref_cache = api.decode_step(params, ref_cache, jnp.asarray(tok),
                                          pos)
        got, cache = port.decode_step(lm_, cache, torch.from_numpy(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=F32_ATOL)
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), _np(ref_cache[name]),
                                   rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bf16_layer_by_layer(arch):
    """bf16 decode, three steps: each port layer takes the reference
    layer's input and its cache as the reference holds it; outputs by the
    margin rule and two ulps, the caches within two ulps of their largest
    value."""
    cfg, api, params, lm_, tokens = _case(arch, "bfloat16")
    ref_cache, _ = api.init_cache(B, 4)
    sames = []
    for pos in range(3):
        h = jnp.take(params["embed"], jnp.asarray(tokens[:, pos:pos + 1]),
                     axis=0).astype(jnp.bfloat16)
        jpos, tpos = _positions(1, pos)
        layer_caches = []
        for i in range(cfg.n_layers):
            ref_c = jax.tree.map(lambda a: a[i], ref_cache)
            mine = {k: _t(v, torch.bfloat16) for k, v in ref_c.items()}
            with _routing() as rec:
                want, new_c = ref_lm._layer_apply(
                    cfg, _layer_params(params, i), h, jpos, None, None,
                    cache=ref_c, cache_index=pos)
                got, mine = lm._layer_apply(cfg, lm_.layers[i],
                                            _t(h, torch.bfloat16), tpos,
                                            cache=mine, cache_index=pos)
            (rid, probs), = rec["ref"]
            same = _same_routing(cfg, rid, probs, rec["port"][0])
            _bf16_layer_close(got.reshape(B, -1), want, same)
            sames.append(same)
            for name in mine:
                _bf16_close(mine[name], new_c[name])
            layer_caches.append(new_c)
            h = want
        ref_cache = jax.tree.map(lambda *a: jnp.stack(a), *layer_caches)
    _flip_share(sames)


@pytest.mark.parametrize("arch,compute", [
    ("deepseek-v2-lite-16b", "float32"), ("kimi-k2-1t-a32b", "float32"),
    ("kimi-k2-1t-a32b", "bfloat16")])
def test_teacher_forced_decode_equals_forward(arch, compute):
    """Feeding the prompt one token at a time gives the plain forward's
    logits within 1e-4, the bound of the reference's own
    test_decode_matches_forward_dense, in the reference as in the port
    (kimi-k2 in bf16 too: GQA decode gives its forward exactly in both).
    MLA in bf16: the next test."""
    cfg, api, params, lm_, tokens = _case(arch, compute)
    n = 8
    bound = F32_ATOL
    port = build_model(cfg)
    ref_fwd = api.forward(params, {"tokens": jnp.asarray(tokens[:, :n])})
    fwd = port.forward(lm_, {"tokens": torch.from_numpy(tokens[:, :n])})
    ref_cache, _ = api.init_cache(B, n)
    cache, _ = port.init_cache(B, n)
    ref_out, out = [], []
    for t in range(n):
        tok = tokens[:, t:t + 1]
        lg, ref_cache = api.decode_step(params, ref_cache, jnp.asarray(tok), t)
        ref_out.append(_np(lg))
        lg, cache = port.decode_step(lm_, cache, torch.from_numpy(tok), t)
        out.append(_np(lg))
    ref_gap = float(np.abs(np.concatenate(ref_out, 1) - _np(ref_fwd)).max())
    gap = float(np.abs(np.concatenate(out, 1) - _np(fwd)).max())
    assert ref_gap <= bound
    assert gap <= bound, (gap, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_bf16_layer_by_layer(arch):
    """bf16, in each package: at every layer, decode steps over the prompt
    on the forward's own layer input give the forward's layer output.
    The decode's routing against the forward's by the margin rule, the
    outputs of tokens routed alike within two ulps (module docstring)."""
    cfg, api, params, lm_, tokens = _case(arch, "bfloat16")
    n = 8
    ref_cache_init = (ref_mla.mla_cache_init if cfg.use_mla
                      else ref_layers.attention_cache_init)
    sames = {False: [], True: []}        # the reference's, the port's
    for i, (h, want, got, rec) in enumerate(
            _ref_layers_eager(cfg, params, tokens[:, :n], lm_)):
        (fwd_ids, probs), = rec["ref"]
        margin = _margin(cfg, probs)
        for fwd_out, fwd_ids_, step in (
                (want, fwd_ids, lambda c, x, t: ref_lm._layer_apply(
                    cfg, _layer_params(params, i), x, _positions(1, t)[0],
                    None, None, cache=c, cache_index=t)),
                (got, rec["port"][0], lambda c, x, t: lm._layer_apply(
                    cfg, lm_.layers[i], _t(x, torch.bfloat16),
                    _positions(1, t)[1], cache=c, cache_index=t))):
            torch_side = isinstance(fwd_out, torch.Tensor)
            cache = (lm.init_cache(cfg, B, n)[0] if torch_side
                     else ref_cache_init(cfg, B, n)[0])
            if torch_side:
                cache = {k: v[0] for k, v in cache.items()}
            outs, same = [], np.ones((B, n), bool)
            for t in range(n):
                with _routing() as dec:
                    out, cache = step(cache, h[:, t:t + 1], t)
                outs.append(_np(out))
                ids = dec["port" if torch_side else "ref"][0]
                ids = ids[0] if not torch_side else ids
                for b in range(B):
                    same[b, t] = set(ids[b].tolist()) == \
                        set(fwd_ids_[b * n + t].tolist())
            assert (margin[~same.reshape(-1)] <= MARGIN).all()
            sames[torch_side].append(same)
            _bf16_layer_close(np.concatenate(outs, 1).reshape(B * n, -1),
                              fwd_out, same.reshape(-1))
    for side in sames.values():
        _flip_share(side)


def test_mla_cache_carried_mid_decode():
    """A decode begun in the reference continues in the port: its latent
    cache after two steps, carried, and the third step in both."""
    cfg, api, params, lm_, tokens = _case("deepseek-v2-lite-16b", "float32")
    ref_cache, _ = api.init_cache(B, 6)
    for pos in range(2):
        _, ref_cache = api.decode_step(params, ref_cache,
                                       jnp.asarray(tokens[:, pos:pos + 1]),
                                       pos)
    cache = cache_from_reference(cfg, jax.tree.map(np.asarray, ref_cache))
    assert sorted(cache) == ["c_kv", "k_rope"]
    want, _ = api.decode_step(params, ref_cache, jnp.asarray(tokens[:, 2:3]),
                              2)
    got, _ = build_model(cfg).decode_step(lm_, cache,
                                          torch.from_numpy(tokens[:, 2:3]), 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    bad = dict(jax.tree.map(np.asarray, ref_cache))
    bad["c_kv"] = bad["c_kv"][..., :-1]
    with pytest.raises(ValueError, match="cache c_kv"):
        cache_from_reference(cfg, bad)
    with pytest.raises(ValueError, match="expected"):
        cache_from_reference(cfg, {"k": bad["c_kv"], "v": bad["c_kv"]})


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py::TestArchSmoke
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
class TestArchSmoke:
    def test_forward_and_train_step(self, arch):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        lm_ = api.init(torch.Generator().manual_seed(0))
        batch = SyntheticPipeline(cfg, B, S, seed=1).batch_at(0)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits = api.forward(lm_, batch)
        assert logits.shape == (B, S, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        for p in lm_.parameters():
            p.requires_grad_(True)
        loss = api.loss_fn(lm_, batch)
        grads = torch.autograd.grad(loss, list(lm_.parameters()))
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        with torch.no_grad():
            for p, g in zip(lm_.parameters(), grads):
                p.sub_(1e-3 * g)
        assert bool(torch.isfinite(api.loss_fn(lm_, batch)))

    def test_decode_step(self, arch):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        lm_ = api.init(torch.Generator().manual_seed(0))
        cache, _ = api.init_cache(B, 16)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        for pos in range(3):
            logits, cache = api.decode_step(lm_, cache, tok, pos)
            assert logits.shape == (B, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits.float()).all())
            tok = logits.argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# carried parameters and optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_round_trips_through_reference_layout(arch, optimizer):
    cfg, _, params, lm_, _ = _case(arch, "float32")
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(cfg, lm_)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    # the reference's state layout, filled with seeded values
    rng = np.random.default_rng(8)
    init, _ = ref_adamw.make_optimizer(RefTrainConfig(optimizer=optimizer))
    opt_np = jax.tree.map(
        lambda a: (rng.normal(size=a.shape).astype(np.float32)
                   if a.ndim else np.asarray(3, np.int32)),
        init(params)._asdict())
    again = opt_to_reference(cfg, opt_from_reference(cfg, opt_np))
    assert jax.tree.structure(again) == jax.tree.structure(opt_np)
    jax.tree.map(np.testing.assert_array_equal, opt_np, again)


def test_carry_rejects_a_tree_that_does_not_fit():
    cfg, _, params, _, _ = _case("deepseek-v2-lite-16b", "float32")
    tree = jax.tree.map(np.asarray, params)
    layers = dict(tree["layers"])
    no_shared = dict(tree, layers={k: v for k, v in layers.items()
                                   if k != "shared"})
    with pytest.raises(KeyError, match="lacks"):
        params_from_reference(cfg, no_shared)
    extra = dict(tree, layers=dict(layers, ffn={"w_up": layers["moe"]
                                                ["w_up"]}))
    with pytest.raises(ValueError, match="expected"):
        params_from_reference(cfg, extra)
    moe_leaves = dict(layers["moe"], w_gate=layers["moe"]["w_gate"][:, :-1])
    with pytest.raises(ValueError, match="layers/moe/w_gate"):
        params_from_reference(cfg, dict(tree, layers=dict(layers,
                                                          moe=moe_leaves)))
    one_layer = dict(layers["attn"], wq=layers["attn"]["wq"][:1])
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_reference(cfg, dict(tree, layers=dict(layers,
                                                          attn=one_layer)))
    # kimi's GQA attention does not take deepseek's MLA leaves
    with pytest.raises(ValueError, match="expected"):
        params_from_reference(_cfg("kimi-k2-1t-a32b", "float32"), tree)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _batch(cfg, step: int = 0):
    return SyntheticPipeline(cfg, B, S, seed=3).batch_at(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """float32 compute: the loss within 1e-5 and each gradient leaf within
    1e-5 of its largest value, through the reference's cast-once step
    (readings: summation order, a few 1e-7)."""
    cfg, api, params, lm_, _ = _case(arch, "float32")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: api.loss_fn(p, jb, None, remat="none"))(params)
    _, info, _ = build_train_step(build_model(cfg), TrainConfig(remat="dots"))
    loss, grads = info["value_and_grad"](lm_, _torch_batch(batch))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    mine = {p: to_host(x) for p, x in tree_items(reference_tree(cfg, grads))}
    want = dict(tree_items(jax.tree.map(np.asarray, ref_grads)))
    assert list(mine) == list(want)
    for path, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, path
        err = float(np.abs(mine[path] - g).max())
        assert err <= 1e-5 * scale, (path, err / scale)


def test_bf16_step_routes_on_the_bf16_router():
    """The step casts every float32 weight of two or more dimensions to
    bf16 once, the router (float32 in the model) included, as the
    reference's cast-once rule does: the step's gradients are bf16
    values, and its loss is the loss of the model whose router was
    rounded to bf16, not of the float32 one (serving routes on that)."""
    cfg, _, _, lm_, _ = _case("deepseek-v2-lite-16b", "bfloat16")
    batch = _torch_batch(_batch(cfg))
    api = build_model(cfg)
    _, info, _ = build_train_step(api, TrainConfig(remat="none"))
    loss, grads = info["value_and_grad"](lm_, batch)
    for name, g in grads.items():
        assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32)), name
    rounded = copy.deepcopy(lm_)
    with torch.no_grad():
        for blk in rounded.layers:
            blk.moe.router.copy_(blk.moe.router.to(torch.bfloat16))
    assert float(api.loss_fn(rounded, batch)) == float(loss)
    assert float(api.loss_fn(lm_, batch)) != float(loss)


def _ref_train_step(api, tcfg):
    """repro's own ``build_train_step`` on its one-device mesh (the mesh
    its trainer builds), as (step(params, opt, batch, t), opt_init). Its
    MoE layers take the expert-parallel path, with capacity drops; so do
    the port's on its one-card mesh."""
    step, _, init = ref_build_train_step(
        api, RefTrainConfig(**dataclasses.asdict(tcfg)),
        make_rules(ref_single_device_mesh(), fsdp=True), donate=False)

    def run(params, opt, batch, t):
        params, opt, _, metrics, checksums = step(
            params, opt, ref_init_error_state(params), batch,
            jax.random.PRNGKey(t))
        return params, opt, metrics, checksums

    return run, init


def test_reference_step_on_a_mesh_drops_by_capacity(tmp_path):
    """repro's trainer always builds its step on a mesh (one device
    here), and there its MoE layers take the expert-parallel path, whose
    assignments beyond an expert's window are dropped: another loss than
    the dense path's. The port's trainer builds a one-card mesh and its
    step gives repro's on-mesh loss (6.3876 here, against the dense
    6.3770) within 1e-5, from the same carried weights."""
    cfg, api, params, lm_, _ = _case("deepseek-v2-lite-16b", "float32")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = TrainConfig(remat="none")
    trainer = RefADCCTrainer(cfg, RefTrainConfig(**dataclasses.asdict(tcfg)),
                             str(tmp_path / "ref"), batch=B, seq=S)
    assert trainer.rules.mesh is trainer.mesh and trainer.mesh.size == 1
    on_mesh = float(api.loss_fn(params, jb, trainer.mesh))
    dense = float(api.loss_fn(params, jb, None))
    assert abs(on_mesh - dense) > 1e-3
    port = ADCCTrainer(cfg, tcfg, str(tmp_path / "port"), batch=B, seq=S)
    assert port.info["mesh"] == single_device_mesh()
    moe.EP_COUNTS.update(assignments=0, dropped=0)
    loss = float(port.info["value_and_grad"](lm_, _torch_batch(batch))[0])
    assert abs(loss - on_mesh) <= 1e-5
    assert int(moe.EP_COUNTS["dropped"]) > 0
    # without a mesh the port's step stays on the dense path, as repro's
    _, info, _ = build_train_step(build_model(cfg), tcfg)
    assert abs(float(info["value_and_grad"](lm_, _torch_batch(batch))[0])
               - dense) <= 1e-5


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_train_steps_match_reference(optimizer):
    """deepseek-v2-lite reduced, float32 compute, remat "dots", the
    port's step on its one-card mesh against repro's own step on its
    one-device mesh (``_ref_train_step``): loss and grad_norm within
    1e-5 relative, parameter and optimizer checksums within 1e-5 relative
    plus 1e-3 absolute, update checksums within 1e-4 of the largest, and
    the parameters within 2 lr + 1e-6 (as for the dense family,
    tests/test_torch_train.py).

    Every expert is selected here (``experts_per_token = n_experts``).
    At the config's own top 2 a step's loss and checksums sum over every
    token, and one token whose 2nd and 3rd router probabilities are
    closer than float32's summation-order difference takes another
    expert in each package: on this file's inputs a margin of 1.2e-7 at
    the third Adafactor step moved the loss by 1.8e-5 relative and
    grad_norm by 2.8e-3. With all experts selected no float32 difference
    can change which experts a token uses, so the comparison holds by
    construction; the selection itself is held by the forward and router
    tests above."""
    cfg, _, params, _, _ = _case("deepseek-v2-lite-16b", "float32")
    cfg = dataclasses.replace(cfg, experts_per_token=cfg.n_experts)
    api = ref_build_model(cfg)
    tcfg = TrainConfig(remat="dots", warmup_steps=2, total_steps=20,
                       optimizer=optimizer)
    ref_step, ref_init = _ref_train_step(api, tcfg)
    lm_ = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    step, _, opt_init = build_train_step(build_model(cfg), tcfg,
                                         single_device_mesh())
    r_p, r_o = params, ref_init(params)
    opt = opt_init(lm_)
    for t in range(3):
        batch = _batch(cfg, t)
        r_p, r_o, r_m, r_c = ref_step(
            r_p, r_o, {k: jnp.asarray(v) for k, v in batch.items()}, t)
        lm_, opt, _, m, c = step(lm_, opt, {}, _torch_batch(batch),
                                 torch.Generator().manual_seed(t))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]), rtol=1e-5)
        for k in ("params", "opt", "updates"):
            got = np.array(flatten_checksums(c[k]))
            want = np.array(ref_acc.flatten_checksums(r_c[k]))
            assert got.shape == want.shape, k
            if k == "updates":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-4 * np.abs(want).max())
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=2 * tcfg.learning_rate + 1e-6),
        params_to_reference(cfg, lm_), r_p)


F32_ROUTING_MARGIN = 1e-5


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_steps_at_top_k_match_reference(optimizer):
    """The twin above at the config's own top 2: three steps, each begun
    in both packages from the reference's parameters and optimizer state
    after the steps before it (carried), so a routing difference in one
    step cannot reach the next. A step is held to the twin's bounds where
    every token at every layer has a margin of at least
    ``F32_ROUTING_MARGIN`` = 1e-5 in the reference (float32 summation
    order moves the probabilities by about 1e-7, so neither package can
    route such a token otherwise); the port must route those tokens as
    the reference does. A step with a token below the margin is counted
    and printed, not compared: its loss and checksums sum over a token
    that may take another expert in each package."""
    cfg, _, params, _, _ = _case("deepseek-v2-lite-16b", "float32")
    api = ref_build_model(cfg)
    tcfg = TrainConfig(remat="dots", warmup_steps=2, total_steps=20,
                       optimizer=optimizer)
    ref_step, ref_init = _ref_train_step(api, tcfg)
    step, _, _ = build_train_step(build_model(cfg), tcfg,
                                  single_device_mesh())
    r_p, r_o = params, ref_init(params)
    compared = []
    for t in range(3):
        batch = _batch(cfg, t)
        lm_ = params_from_reference(cfg, jax.tree.map(np.asarray, r_p))
        opt = opt_from_reference(cfg, jax.tree.map(np.asarray,
                                                   r_o._asdict()))
        ref_rec = _ref_routing_on_mesh(cfg, r_p, batch["tokens"])
        with _routing() as rec:
            _, _, _, m, c = step(lm_, opt, {}, _torch_batch(batch),
                                 torch.Generator().manual_seed(t))
        r_p, r_o, r_m, r_c = ref_step(
            r_p, r_o, {k: jnp.asarray(v) for k, v in batch.items()}, t)
        # the forward's router calls (remat may call them again)
        assert len(rec["port"]) >= cfg.n_layers
        for (rid, probs), pid in zip(ref_rec, rec["port"]):
            _same_routing(cfg, rid, probs, pid, margin=F32_ROUTING_MARGIN)
        if min(_margin(cfg, probs).min() for _, probs in ref_rec) \
                < F32_ROUTING_MARGIN:
            continue
        compared.append(t)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]), rtol=1e-5)
        for k in ("params", "opt", "updates"):
            got = np.array(flatten_checksums(c[k]))
            want = np.array(ref_acc.flatten_checksums(r_c[k]))
            assert got.shape == want.shape, k
            if k == "updates":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-4 * np.abs(want).max())
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    print(f"{optimizer}: steps compared {compared} of 3")
    assert compared


def _trainer(workdir):
    """deepseek-v2-lite reduced, AdamW, a slot every 2 steps (each step
    appends to the ledger with an fsync, so the runs are kept short)."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    tcfg = TrainConfig(remat="none", total_steps=40, warmup_steps=5)
    return ADCCTrainer(cfg, tcfg, workdir, batch=2, seq=16, slot_every=2)


def _max_diff(lm_a, lm_b) -> float:
    return max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(lm_a.named_parameters(), lm_b.named_parameters()))


class TestTrainer:
    def test_crash_restart_is_bitwise(self, tmp_path):
        ref = _trainer(str(tmp_path / "ref"))
        r_ref = ref.run(5, log_every=0)
        wd = str(tmp_path / "crash")
        _trainer(wd).run(5, crash_at_step=3, log_every=0)
        tr = _trainer(wd)
        res = tr.run(5, log_every=0)
        assert res.resumed_from == 1
        assert res.losses == r_ref.losses[2:]
        assert _max_diff(ref._final_params, tr._final_params) == 0.0

    def test_reference_reads_the_ports_slot_and_ledger(self, tmp_path):
        wd = str(tmp_path / "x")
        tr = _trainer(wd)
        tr.run(4, log_every=0)
        recs = ref_acc.ChecksumLedger(
            os.path.join(wd, "ledger.jsonl")).validated_records()
        assert [r.step for r in recs] == list(range(4))
        store = ref_slots.SlotStore(os.path.join(wd, "slots"), 3)
        assert store.slots_by_recency() == [(1, 3), (0, 1)]
        api = ref_build_model(tr.cfg)
        shapes, _ = api.abstract_init(jax.random.PRNGKey(0))
        template = {"params": shapes,
                    "opt": jax.eval_shape(ref_adamw.adamw_init, shapes)}
        state = ref_slots.unflatten_state(template, store.read_slot(1))
        rec = {r.step: r for r in recs}[3]
        assert ref_acc.verify_state_against_record(
            state["params"], state["opt"], rec) == (True, 0)
        final = params_to_reference(tr.cfg, tr._final_params)
        jax.tree.map(np.testing.assert_array_equal, final, state["params"])

    def test_port_recovers_from_the_references_slot(self, tmp_path):
        cfg = get_config("deepseek-v2-lite-16b").reduced()
        _, _, params, _, _ = _case("deepseek-v2-lite-16b", "bfloat16")
        # a state in the reference's layout after two steps: seeded
        # moments and update
        rng = np.random.default_rng(9)
        draw = lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-3
        upd = jax.tree.map(draw, params)
        opt = ref_adamw.AdamWState(
            step=np.asarray(2, np.int32), m=jax.tree.map(draw, params),
            v=jax.tree.map(lambda p: np.abs(draw(p)), params))
        params = jax.tree.map(lambda p, u: np.asarray(p) + u, params, upd)
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
        tr = _trainer(wd)
        seen = {}
        real = tr.step_fn

        def spy(lm_, *a):
            seen.setdefault("p", params_to_reference(cfg, lm_))
            return real(lm_, *a)

        tr.step_fn = spy
        res = tr.run(4, log_every=0)
        assert res.resumed_from == 2
        assert res.recovery_report.endswith("verified")
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, np.asarray(b)), seen["p"], params)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_moe_modules_import_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "import repro_torch\n"
        "from repro_torch.models import build_model, get_config, moe, mla\n"
        "cfg = get_config('deepseek-v2-lite-16b').reduced()\n"
        "with repro_torch.use_device('cpu'):\n"
        "    api = build_model(cfg)\n"
        "    lm = api.init(torch.Generator().manual_seed(0))\n"
        "    cache, _ = api.init_cache(1, 4)\n"
        "    out, _ = api.decode_step(lm, cache, torch.zeros((1, 1),"
        " dtype=torch.int32), 0)\n"
        "assert out.shape == (1, 1, cfg.vocab_size)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " or m == 'repro' or m.startswith('repro.')"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"

"""Port vs reference, flash attention: the same seeded numpy inputs go
through ``repro.kernels.flash_attention`` (the Pallas kernel in interpret
mode, and its jnp oracle) and through ``repro_torch.kernels.flash_attention``
on CPU tensors, where the wrapper takes the plain version beside the CUDA
kernel.

Tolerances are the reference's own (tests/test_kernels.py): ``1e-5``
relative and absolute for float32 (summation order of a float32
softmax), ``5e-2`` for bfloat16 (the output rounds at 2^-8; inputs are
bit-identical in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.kernel import (BF16_ATOL, BF16_RTOL,
                                                        F16_ATOL, F16_RTOL)
from repro_torch.kernels.flash_attention.ref import attention_ref

# the reference's four shapes (tests/test_kernels.py), a ragged S and the
# dense configs' head dim
SHAPES = [
    (2, 128, 4, 2, 32), (1, 256, 2, 2, 64), (2, 64, 8, 2, 16),
    (1, 64, 4, 4, 32),     # MHA
    (2, 72, 4, 2, 32),     # S not a multiple of the kernel's 64-row tile
    (1, 40, 8, 2, 128),    # head_dim 128 as in every dense config
    (1, 64, 4, 2, 80),     # head dims off the kernel's tile widths: 80
    (2, 72, 4, 2, 48),     # (hubert-xlarge's, whose attention is not
    #                        causal and never reaches the kernel), and 48
    (1, 64, 12, 2, 128),   # qwen2-vl-2b's heads: six query heads per KV head
]

_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=5e-2, atol=5e-2),
        # two ulps of float16's rounding of outputs below 2 (2^-10 each)
        "float16": dict(rtol=2e-3, atol=2e-3)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield
    assert fa_kernel.launches == 0


def _pair(x64: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU tensor (bit-identical)."""
    xj = jnp.asarray(x64, _JNP[dtype])
    xt = torch.from_numpy(np.array(xj, dtype=np.float32)).to(_TORCH[dtype])
    return xj, xt


def _inputs(B, S, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(size=shape), dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _flat(x, heads):
    """(B, S, heads, hd) -> (B*heads, S, hd), either package."""
    B, S, _, hd = x.shape
    if isinstance(x, torch.Tensor):
        return x.permute(0, 2, 1, 3).reshape(B * heads, S, hd)
    return x.transpose(0, 2, 1, 3).reshape(B * heads, S, hd)


@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel(B, S, H, KV, hd, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(B, S, H, KV, hd, dtype,
                                           B * 100 + S)
    want = ref_ops.flash_attention(qj, kj, vj, interpret=True)
    got = fa.flash_attention(qt, kt, vt)
    assert got.shape == (B, S, H, hd) and got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **_TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
def test_plain_matches_oracle(B, S, H, KV, hd):
    """The plain version against the reference's jnp oracle and the port's
    copy of it, on the flattened (BH, S, hd) layout the oracle takes."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(B, S, H, KV, hd, "float32", S)
    want = jax_attention_ref(_flat(qj, H), _flat(kj, KV), _flat(vj, KV),
                             groups=H // KV)
    mine = attention_ref(_flat(qt, H), _flat(kt, KV), _flat(vt, KV),
                         groups=H // KV)
    got = _flat(fa_kernel.flash_attention_plain(qt, kt, vt), H)
    np.testing.assert_allclose(_np(mine), _np(want), **_TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(want), **_TOL["float32"])


@pytest.mark.parametrize("S", [64, 72])
def test_not_causal_matches_reference(S):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, S, 4, 2, 32, "float32", 7)
    want = ref_ops.flash_attention(qj, kj, vj, causal=False, interpret=True)
    got = fa.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **_TOL["float32"])


def test_strided_views_read_in_place():
    """q/k/v as the model hands them: head views of a fused projection."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    fused = torch.from_numpy(rng.normal(size=(B, S, (H + 2 * KV) * hd))
                             ).to(torch.float32)
    q = fused[..., :H * hd].reshape(B, S, H, hd)
    k = fused[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
    v = fused[..., (H + KV) * hd:].reshape(B, S, KV, hd)
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fully_masked_rows_add_nothing():
    """A causal row sees only its prefix: changing later keys and values
    leaves every earlier row's output bit for bit."""
    (_, q), (_, k), (_, v) = _inputs(1, 64, 2, 1, 16, "float32", 11)
    base = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] += 100.0
    v2[:, 40:] -= 7.0
    out = fa.flash_attention(q, k2, v2)
    torch.testing.assert_close(out[:, :40], base[:, :40], rtol=0, atol=0)
    assert not torch.allclose(out[:, 40:], base[:, 40:])


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    q = torch.zeros(1, 16, 4, 32)
    kv = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q, kv, kv)
    # every head dim and every dtype the reference's kernel takes passes
    # the wrapper's checks and fails only for lying on the CPU
    for hd in (48, 80, 136, 44, 256, 512):
        with pytest.raises(ValueError, match="CUDA"):
            fa_kernel.flash_attention_cuda(torch.zeros(1, 16, 4, hd),
                                           torch.zeros(1, 16, 2, hd),
                                           torch.zeros(1, 16, 2, hd))
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            fa_kernel.flash_attention_cuda(q.to(dtype), kv.to(dtype),
                                           kv.to(dtype))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q, kv.to(torch.bfloat16), kv)
    # what the reference asserts too: shapes that do not match, query
    # heads that are not a multiple of the kv heads
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(q, torch.zeros(1, 16, 3, 32),
                           torch.zeros(1, 16, 3, 32))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 32),
                           torch.zeros(1, 8, 2, 32))
    assert launch_counts()["flash_attention"] == 0


# The bf16 kernel's arithmetic (csrc/flash_attention.cu, the wgmma route),
# emulated in plain PyTorch: the card's check holds the kernel to two bf16
# ulps of the f32-P result (BF16_RTOL / BF16_ATOL), and these tests show
# that P split into bf16 hi + lo meets that bound where one bf16 P does not.
KEY_TILE = 128      # wg::BKV, the kernel's key tile


def _blockwise_bf16(q, k, v, *, split: bool) -> torch.Tensor:
    """bf16 on the 128-key tiles of head dims up to 128."""
    return _blockwise_2byte(q, k, v, split=split, tile=KEY_TILE)


def _blockwise_2byte(q, k, v, *, split: bool, tile: int) -> torch.Tensor:
    """Causal online softmax over ``tile``-key tiles in f32: scale after
    the dot, masked logits NEG_INF and masked p exactly 0, l from the
    unrounded p, P.V from P in q's 2-byte type E (hi, plus lo = E(p - hi)
    when ``split``) with f32 sums, out = acc / max(l, 1e-30) in E. Query
    rows that precede a tile skip it, as the kernel's warps do."""
    el = q.dtype
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              for t in (k, v))
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((B, H, S, 1), fa_kernel.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, tile):
        rows = slice(k0, S)
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = qf[:, :, rows] @ kt.transpose(-1, -2) * scale
        ok = (torch.arange(k0, k0 + kt.shape[2])[None, :]
              <= torch.arange(k0, S)[:, None])
        s = s.masked_fill(~ok, fa_kernel.NEG_INF)
        m_new = torch.maximum(m[:, :, rows], s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m[:, :, rows] - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        hi = p.to(el).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(el).float() @ vt
        acc[:, :, rows] = acc[:, :, rows] * alpha + pv
        m[:, :, rows] = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(el)


def _out_of_bound(got: torch.Tensor, want: torch.Tensor) -> int:
    g, w = got.double(), want.double()
    return int(((g - w).abs() > BF16_ATOL + BF16_RTOL * w.abs()).sum())


def _bf16_inputs(S, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, S, heads, hd))
                             ).to(torch.bfloat16) for heads in (2, 1, 1)]


@pytest.mark.parametrize("S,hd", [(4096, 128), (1000, 64)])
def test_split_p_meets_the_cards_bf16_bound(S, hd):
    q, k, v = _bf16_inputs(S, hd, S + hd)
    want = fa_kernel.flash_attention_plain(q, k, v)
    got = _blockwise_bf16(q, k, v, split=True)
    assert _out_of_bound(got, want) == 0


def test_single_bf16_p_misses_the_cards_bf16_bound():
    """Why the kernel splits P: rounded once to bf16 before P.V, the same
    prefill-length inputs leave the bound at many elements."""
    q, k, v = _bf16_inputs(4096, 128, 4096 + 128)
    want = fa_kernel.flash_attention_plain(q, k, v)
    assert _out_of_bound(_blockwise_bf16(q, k, v, split=False), want) > 1000


# The same emulation for the routes added beside it: f16 P split into f16
# hi + lo, whose lo lies on f16's subnormal grid (2^-24) for most p, held to
# the card's f16 bound (F16_RTOL / F16_ATOL); and the 256-column tile's
# 64-key tiles, f16 and bf16.
WIDE_KEY_TILE = 64      # Tiles<256>::BKV


def _out_of_f16_bound(got: torch.Tensor, want: torch.Tensor) -> int:
    g, w = got.double(), want.double()
    return int(((g - w).abs() > F16_ATOL + F16_RTOL * w.abs()).sum())


@pytest.mark.parametrize("S,hd,tile", [(4096, 128, KEY_TILE),
                                       (1000, 64, KEY_TILE),
                                       (2048, 256, WIDE_KEY_TILE)])
def test_split_p_meets_the_cards_f16_bound(S, hd, tile):
    q, k, v = (t.float().to(torch.float16) for t in _bf16_inputs(S, hd,
                                                                 S + hd))
    want = fa_kernel.flash_attention_plain(q, k, v)
    got = _blockwise_2byte(q, k, v, split=True, tile=tile)
    assert got.dtype == torch.float16
    assert _out_of_f16_bound(got, want) == 0


def test_single_f16_p_misses_the_cards_f16_bound():
    """Why the f16 kernel splits P as the bf16 one does."""
    q, k, v = (t.float().to(torch.float16) for t in _bf16_inputs(
        4096, 128, 4096 + 128))
    want = fa_kernel.flash_attention_plain(q, k, v)
    got = _blockwise_2byte(q, k, v, split=False, tile=KEY_TILE)
    assert _out_of_f16_bound(got, want) > 1000


def test_split_p_meets_the_cards_bf16_bound_on_the_wide_tile():
    q, k, v = _bf16_inputs(2048, 256, 2048 + 256)
    want = fa_kernel.flash_attention_plain(q, k, v)
    got = _blockwise_2byte(q, k, v, split=True, tile=WIDE_KEY_TILE)
    assert _out_of_bound(got, want) == 0


# Every head dim and dtype the reference's Pallas kernel takes (interpret
# mode): head dims off the tiles and past them, float16, and q of another
# dtype than k and v. The output has q's dtype in both packages.
ANY_CASES = [
    # (B, S, H, KV, hd), q dtype, k/v dtype
    ((1, 16, 4, 2, 100), "float32", "float32"),
    ((1, 24, 4, 2, 192), "float32", "float32"),
    ((1, 16, 4, 2, 256), "float32", "float32"),
    ((1, 16, 2, 1, 512), "float32", "float32"),
    ((1, 32, 4, 2, 100), "bfloat16", "bfloat16"),
    ((1, 24, 4, 2, 192), "bfloat16", "bfloat16"),
    ((1, 16, 4, 2, 256), "bfloat16", "bfloat16"),
    ((1, 16, 2, 1, 512), "bfloat16", "bfloat16"),
    ((2, 72, 4, 2, 64), "float16", "float16"),
    ((1, 40, 4, 2, 256), "float16", "float16"),
    ((1, 16, 4, 2, 100), "float16", "float16"),
    ((2, 48, 4, 2, 32), "bfloat16", "float32"),
    ((1, 16, 4, 2, 136), "float32", "bfloat16"),
]


@pytest.mark.parametrize("shape,q_dtype,kv_dtype", ANY_CASES)
def test_any_head_dim_and_dtype_matches_reference_kernel(shape, q_dtype,
                                                         kv_dtype):
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(B * 100 + S + hd)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(B, S, n, hd)), d)
        for n, d in ((H, q_dtype), (KV, kv_dtype), (KV, kv_dtype)))
    want = ref_ops.flash_attention(qj, kj, vj, interpret=True)
    got = fa.flash_attention(qt, kt, vt)
    assert str(want.dtype) == q_dtype
    assert got.shape == (B, S, H, hd) and got.dtype == _TORCH[q_dtype]
    np.testing.assert_allclose(_np(got), _np(want), **_TOL[q_dtype])


@pytest.mark.parametrize("shape,causal", [((2, 32, 4, 2, 64), True),
                                          ((1, 24, 4, 2, 300), False)])
def test_float64_is_computed_in_float32_as_the_reference(shape, causal):
    """float64 under x64: the reference's kernel casts its blocks to
    float32 and writes q's dtype, so the result is float64 holding a
    float32 computation; held at the float32 tolerance."""
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(S + hd)
    x = [rng.normal(size=(B, S, n, hd)) for n in (H, KV, KV)]
    with jax.enable_x64(True):
        want = ref_ops.flash_attention(*(jnp.asarray(a) for a in x),
                                       causal=causal, interpret=True)
        assert want.dtype == jnp.float64
        want = np.asarray(want)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in x),
                             causal=causal)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **_TOL["float32"])


def test_route_of_every_dtype_and_head_dim():
    """Which kernel of csrc/flash_attention.cu each input goes to, by the
    wrapper's own choice (``route``): entry, kernel, tile width, the cast
    and the zero padding it makes first."""
    f16, bf16 = torch.float16, torch.bfloat16
    f32, f64 = torch.float32, torch.float64
    f8 = torch.float8_e4m3fn

    def r(hd, qd, kvd=None):
        q = torch.zeros(1, 2, 2, hd, dtype=qd)
        kv = torch.zeros(1, 2, 1, hd, dtype=kvd or qd)
        return tuple(fa_kernel.route(q, kv, kv))

    for d, name in ((bf16, "bf16"), (f16, "f16")):
        entry = f"flash_attention_{name}"
        for hd, tile in ((8, 16), (16, 16), (24, 32), (48, 64), (80, 128),
                         (128, 128), (136, 256), (192, 256), (256, 256)):
            assert r(hd, d) == (entry, "wgmma", tile, None, None)
        # not a multiple of 8: a zero-padded copy, on the padded width's tile
        for hd, pad, tile in ((44, 48, 64), (100, 104, 128), (4, 8, 16),
                              (250, 256, 256)):
            assert r(hd, d) == (entry, "wgmma", tile, None, pad)
        for hd in (257, 300, 512):
            assert r(hd, d) == (entry, "fma_chunks", 128, None, None)
    for d, name in ((f32, "f32"), (f64, "f64")):
        entry = f"flash_attention_{name}"
        for hd, tile in ((8, 16), (44, 64), (100, 128), (128, 128),
                         (200, 256), (256, 256)):
            assert r(hd, d) == (entry, "fma", tile, None, None)
        for hd in (260, 512):
            assert r(hd, d) == (entry, "fma_chunks", 128, None, None)
    # mixed and other dtypes: cast to float32, float32's route
    for qd, kvd in ((bf16, f32), (f32, bf16), (f16, bf16), (f64, f32),
                    (f8, f8), (f8, bf16)):
        assert r(64, qd, kvd) == ("flash_attention_f32", "fma", 64, f32,
                                  None)
        assert r(100, qd, kvd) == ("flash_attention_f32", "fma", 128, f32,
                                   None)
        assert r(512, qd, kvd) == ("flash_attention_f32", "fma_chunks", 128,
                                   f32, None)

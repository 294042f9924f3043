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
from repro_torch.kernels.flash_attention.kernel import BF16_ATOL, BF16_RTOL
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
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    # head dims: multiples of 8 up to 128 (48 and 80 pass the check and
    # fail only for lying on the CPU); 136 and 44 are refused by name
    for hd in (48, 80):
        with pytest.raises(ValueError, match="CUDA"):
            fa_kernel.flash_attention_cuda(torch.zeros(1, 16, 4, hd),
                                           torch.zeros(1, 16, 2, hd),
                                           torch.zeros(1, 16, 2, hd))
    for hd in (136, 44):
        with pytest.raises(ValueError,
                           match=f"head_dim {hd}; it takes multiples of 8 "
                                 f"from 8 to 128"):
            fa_kernel.flash_attention_cuda(torch.zeros(1, 16, 4, hd),
                                           torch.zeros(1, 16, 2, hd),
                                           torch.zeros(1, 16, 2, hd))
    with pytest.raises(TypeError, match="float64"):
        fa_kernel.flash_attention_cuda(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_cuda(q, kv.to(torch.bfloat16), kv)
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
    """Causal online softmax over KEY_TILE-key tiles in f32: scale after
    the dot, masked logits NEG_INF and masked p exactly 0, l from the
    unrounded p, P.V from bf16 P (hi, plus lo = bf16(p - hi) when
    ``split``) with f32 sums, out = acc / max(l, 1e-30) in bf16. Query rows
    that precede a tile skip it, as the kernel's warps do."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              for t in (k, v))
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((B, H, S, 1), fa_kernel.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, KEY_TILE):
        rows = slice(k0, S)
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = qf[:, :, rows] @ kt.transpose(-1, -2) * scale
        ok = (torch.arange(k0, k0 + kt.shape[2])[None, :]
              <= torch.arange(k0, S)[:, None])
        s = s.masked_fill(~ok, fa_kernel.NEG_INF)
        m_new = torch.maximum(m[:, :, rows], s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m[:, :, rows] - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc[:, :, rows] = acc[:, :, rows] * alpha + pv
        m[:, :, rows] = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


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

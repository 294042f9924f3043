"""Port vs reference, kernel level: the same seeded numpy inputs go
through ``repro.kernels.*.ops`` (Pallas, interpret mode) and through
``repro_torch.kernels.*.ops`` on CPU tensors, where each wrapper takes
the plain version beside its CUDA kernel.

Tolerances: float32 ``rtol 1e-4 / atol 1e-3`` (summation order of a
float32 accumulator) and bfloat16 ``2e-2`` (inputs round at 2^-8) — the
reference's own (tests/test_kernels.py); float64 ``1e-12`` relative
(summation order only, ~1e-16 per term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.abft_matmul import ops as ref_mm
from repro.kernels.checksum_verify import ops as ref_cv
from repro_torch.kernels.abft_matmul import kernel as mm_kernel
from repro_torch.kernels.abft_matmul import ops as mm
from repro_torch.kernels.abft_matmul import ref as mm_ref
from repro_torch.kernels.checksum_verify import kernel as cv_kernel
from repro_torch.kernels.checksum_verify import ops as cv
from repro_torch.kernels.checksum_verify import ref as cv_ref

SHAPES = [
    (128, 128, 128),   # exactly one reference tile
    (256, 256, 256),   # multi-tile aligned
    (256, 384, 128),   # rectangular aligned
    (8, 8, 8),         # minimum reference tile
    (100, 130, 70),    # unaligned -> ragged edges
    (257, 129, 65),    # prime-ish unaligned
    (1, 512, 1),       # degenerate rows/cols
]
SUM_SHAPES = [(128, 128), (64, 256), (100, 70), (9, 5), (257, 127)]

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float64": jnp.float64}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def _tol(dtype):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    if dtype == "float64":
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-4, atol=1e-3)


def _pair(x64: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU tensor of ``dtype``. The
    jax side rounds once; the tensor is built from jax's rounded values,
    so both packages see bit-identical inputs."""
    xj = jnp.asarray(x64, _JNP[dtype])
    wide = np.float64 if dtype == "float64" else np.float32
    xt = torch.from_numpy(np.array(xj, dtype=wide)).to(_TORCH[dtype])
    return xj, xt


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


@pytest.fixture(autouse=True)
def _launch_counters_stay_zero():
    """On the CPU the wrappers must take the plain versions: no test in
    this file may launch (or try to build) a CUDA kernel."""
    before = (mm_kernel.launches, cv_kernel.launches)
    yield
    assert (mm_kernel.launches, cv_kernel.launches) == before == (0, 0)


class TestAbftMatmul:
    @pytest.mark.parametrize("m,k,n", SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_kernel(self, m, k, n, dtype):
        rng = np.random.default_rng(m * 7 + k * 3 + n)
        aj, at = _pair(rng.normal(size=(m, k)), dtype)
        bj, bt = _pair(rng.normal(size=(k, n)), dtype)
        cr, rowr, colr = ref_mm.abft_matmul(aj, bj, interpret=True)
        c, row, col = mm.abft_matmul(at, bt)
        assert c.dtype == _TORCH[dtype] and row.dtype == torch.float32
        assert c.shape == (m, n) and row.shape == (m,) and col.shape == (n,)
        tol = _tol(dtype)
        np.testing.assert_allclose(_np(c), _np(cr), **tol)
        np.testing.assert_allclose(_np(row), _np(rowr), rtol=tol["rtol"],
                                   atol=tol["atol"] * k)
        np.testing.assert_allclose(_np(col), _np(colr), rtol=tol["rtol"],
                                   atol=tol["atol"] * k)

    def test_checksums_equal_true_sums(self):
        rng = np.random.default_rng(0)
        _, at = _pair(rng.normal(size=(96, 160)), "float32")
        _, bt = _pair(rng.normal(size=(160, 64)), "float32")
        c, row, col = mm.abft_matmul(at, bt)
        np.testing.assert_allclose(_np(row), _np(c).sum(1), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(col), _np(c).sum(0), rtol=1e-5,
                                   atol=1e-3)

    def test_full_matrix_layout(self):
        rng = np.random.default_rng(1)
        aj, at = _pair(rng.normal(size=(40, 50)), "float32")
        bj, bt = _pair(rng.normal(size=(50, 30)), "float32")
        cfr = ref_mm.abft_matmul_full(aj, bj, interpret=True)
        cf = mm.abft_matmul_full(at, bt)
        assert cf.shape == (41, 31)
        np.testing.assert_allclose(_np(cf), _np(cfr), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(_np(mm_ref.abft_encode_full_ref(at, bt)),
                                   _np(cfr), rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("m,k,n", [(100, 130, 70), (257, 129, 65),
                                       (1, 512, 1), (64, 256, 256)])
    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_gemm_batch_matches_reference_kernel(self, m, k, n, dtype):
        rng = np.random.default_rng(m + 31 * k + 977 * n)
        a64, b64 = rng.normal(size=(m, k)), rng.normal(size=(k, n))
        with jax.enable_x64(True):
            aj, at = _pair(a64, dtype)
            bj, bt = _pair(b64, dtype)
            cr = np.asarray(ref_mm.gemm_batch(
                aj, bj, acc_dtype=_JNP[dtype], use_pallas=True,
                interpret=True), dtype=np.float64)
        c = mm.gemm_batch(at, bt, acc_dtype=_TORCH[dtype])
        assert c.dtype == _TORCH[dtype] and c.shape == (m, n)
        np.testing.assert_allclose(_np(c), cr, **_tol(dtype))

    def test_gemm_batch_casts_to_the_accumulator(self):
        rng = np.random.default_rng(5)
        _, at = _pair(rng.normal(size=(6, 40)), "float32")
        _, bt = _pair(rng.normal(size=(40, 9)), "float32")
        c = mm.gemm_batch(at, bt)         # float64 by default
        assert c.dtype == torch.float64
        np.testing.assert_allclose(
            _np(c), _np(at) @ _np(bt), rtol=1e-12, atol=1e-12)

    def test_route_follows_the_tensor_never_a_flag(self):
        a = torch.zeros(4, 4)
        with pytest.raises(ValueError, match="use_kernel=True"):
            mm.gemm_batch(a, a, use_kernel=True)
        with pytest.raises(ValueError, match="use_kernel=True"):
            cv.tile_sums_batch(a[None], use_kernel=True)
        with pytest.raises(ValueError, match="CUDA"):
            mm_kernel.abft_matmul_cuda(a, a)
        with pytest.raises(ValueError, match="CUDA"):
            cv_kernel.tile_sums_cuda(a[None])
        assert mm.gemm_batch(a, a, use_kernel=False).shape == (4, 4)


class TestChecksumVerify:
    @pytest.mark.parametrize("m,n", SUM_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tile_sums_match_reference_kernel(self, m, n, dtype):
        rng = np.random.default_rng(m * 11 + n)
        xj, xt = _pair(rng.normal(size=(m, n)), dtype)
        rowr, colr = ref_cv.tile_sums(xj, interpret=True)
        row, col = cv.tile_sums(xt)
        assert row.dtype == torch.float32 and row.shape == (m,)
        # both sides accumulate the same rounded inputs in float32
        np.testing.assert_allclose(_np(row), _np(rowr), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(col), _np(colr), rtol=1e-4,
                                   atol=1e-3)

    @pytest.mark.parametrize("view", ["contiguous", "data_block"])
    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    @pytest.mark.parametrize("B,m", [(3, 33), (2, 65), (5, 9)])
    def test_tile_sums_batch_matches_reference_kernel(self, B, m, dtype,
                                                      view):
        rng = np.random.default_rng(B * 101 + m)
        v64 = rng.normal(size=(B, m, m))
        with jax.enable_x64(True):
            vj, vt = _pair(v64, dtype)
            if view == "data_block":
                # the sweep's case: the data block of full-checksum
                # matrices, read in place through the view's strides
                vj, vt = vj[:, :-1, :-1], vt[:, :-1, :-1]
                assert not vt.is_contiguous()
            rowr, colr = ref_cv.tile_sums_batch(
                vj, acc_dtype=_JNP[dtype], use_pallas=True, interpret=True)
            rowr, colr = _np(rowr), _np(colr)
        row, col = cv.tile_sums_batch(vt, acc_dtype=_TORCH[dtype])
        assert row.dtype == _TORCH[dtype]
        assert row.shape == rowr.shape and col.shape == colr.shape
        np.testing.assert_allclose(_np(row), rowr, **_tol(dtype))
        np.testing.assert_allclose(_np(col), colr, **_tol(dtype))

    def test_verify_clean_and_tampered(self):
        rng = np.random.default_rng(2)
        aj, at = _pair(rng.normal(size=(64, 64)), "float32")
        bj, bt = _pair(rng.normal(size=(64, 64)), "float32")
        cf = mm.abft_matmul_full(at, bt)
        ok, _, _ = cv.verify_checksums(cf)
        ok_ref, _, _ = cv_ref.verify_ref(cf)
        ok_jax, _, _ = ref_cv.verify_checksums(
            ref_mm.abft_matmul_full(aj, bj, interpret=True), interpret=True)
        assert bool(ok) and bool(ok_ref) and bool(ok_jax)
        bad = cf.clone()
        bad[10, 20] += 50.0
        ok2, rres, cres = cv.verify_checksums(bad)
        assert not bool(ok2)
        assert int(torch.argmax(rres.abs())) == 10
        assert int(torch.argmax(cres.abs())) == 20

    def test_verify_matches_reference_residuals(self):
        rng = np.random.default_rng(3)
        cfj, cft = _pair(rng.normal(size=(101, 77)), "float32")
        ok_r, rr_r, cr_r = ref_cv.verify_checksums(cfj, interpret=True)
        ok_k, rr_k, cr_k = cv.verify_checksums(cft)
        ok_o, rr_o, cr_o = cv_ref.verify_ref(cft)
        assert bool(ok_k) == bool(ok_r) == bool(ok_o)
        for got in ((rr_k, cr_k), (rr_o, cr_o)):
            np.testing.assert_allclose(_np(got[0]), _np(rr_r), rtol=1e-4,
                                       atol=1e-2)
            np.testing.assert_allclose(_np(got[1]), _np(cr_r), rtol=1e-4,
                                       atol=1e-2)

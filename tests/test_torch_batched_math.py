"""Port vs reference, device-math level: ``repro_torch.core.backends.
batched`` (on the CPU, through the kernels' plain versions) against the
reference's exact host code — ``repro.core.invariants`` for CG's two
invariants, ``repro.core.abft`` for the ABFT residuals — and the
``core/abft.py`` twin against ``repro.core.abft`` on arrays and tensors.

Tolerance for the float64 error magnitudes: ``rtol 1e-9``. Both sides
compute the same float64 expression and differ only in summation order
(~1e-13 relative at these sizes); the sweep engine itself trusts the
device only outside a factor-2 band, which the tests check directly.
"""

import numpy as np
import pytest
import torch

from repro.algorithms.cg import _sym_matvec, make_spd_system, plain_cg
from repro.core import abft as ref_abft
from repro.core.invariants import OrthogonalityInvariant, ResidualInvariant
from repro_torch import use_device
from repro_torch.core import abft
from repro_torch.core.backends import batched
from repro_torch.kernels.abft_matmul import kernel as mm_kernel
from repro_torch.kernels.checksum_verify import kernel as cv_kernel
from repro_torch.scenarios import batched_engine, make_workload

ORTH_TOL, RES_TOL, BAND = 1e-7, 1e-6, 2.0


@pytest.fixture(autouse=True)
def cpu():
    with use_device("cpu"):
        yield
    assert mm_kernel.launches == 0 and cv_kernel.launches == 0


def _cg_rows(n=96, iters=6, seed=5):
    """True CG iterates of the reference's seeded system: rows
    (p_{j+1}, q_j, r_{j+1}, z_{j+1}) satisfy both invariants; rows mixed
    across iterations (a torn image) break them by orders of magnitude."""
    A, b = make_spd_system(n, seed=seed)
    z = np.zeros(n)
    r = b - _sym_matvec(A, z)
    p = r.copy()
    rho = float(r @ r)
    good = []
    for _ in range(iters):
        q = _sym_matvec(A, p)
        alpha = rho / float(p @ q)
        z = z + alpha * p
        r = r - alpha * q
        rho_new = float(r @ r)
        p_next = r + (rho_new / rho) * p
        # the orthogonality the scan checks pairs p_{j+1} with q_j
        good.append((p_next.copy(), q.copy(), r.copy(), z.copy()))
        p, rho = p_next, rho_new
    rng = np.random.default_rng(seed)
    torn = []
    for j in range(1, iters):
        pj, qj, rj, zj = good[j]
        torn.append((pj, good[j - 1][1] + rng.normal(size=n) * 1e-3,
                     rj, good[j - 1][3]))
    rows = good + torn
    P, Q, R, Z = (np.stack([row[i] for row in rows]) for i in range(4))
    return A, b, P, Q, R, Z, len(good)


def _exact_errors(A, b, P, Q, R, Z):
    orth = OrthogonalityInvariant("p", "q", tol=ORTH_TOL)
    res = ResidualInvariant("r", "z", b=b,
                            matvec=lambda x: _sym_matvec(A, x), tol=RES_TOL)
    o = [orth.check({"p": p, "q": q}).error for p, q in zip(P, Q)]
    r = [res.check({"r": rr, "z": zz}).error for rr, zz in zip(R, Z)]
    return np.array(o), np.array(r)


def _operator(route, monkeypatch, n, seed):
    """The operator exactly as the engine's evaluator builds it."""
    monkeypatch.setattr(batched, "cg_route", lambda: route)
    wl = make_workload(("cg", {"n": n, "iters": 4, "seed": seed}))
    wl.setup(None, "adcc")
    op = batched_engine._CGAdccEvaluator(wl)._operator()
    assert op[0] == route and all(isinstance(t, torch.Tensor)
                                  for t in op[1:])
    return op


class TestCGInvariantErrors:
    @pytest.mark.parametrize("route", ["sparse", "dense"])
    def test_matches_exact_host_invariants(self, route, monkeypatch):
        n, seed = 96, 5
        A, b, P, Q, R, Z, n_good = _cg_rows(n, seed=seed)
        want_o, want_r = _exact_errors(A, b, P, Q, R, Z)
        op = _operator(route, monkeypatch, n, seed)
        orth, rel = batched.cg_invariant_errors(P, Q, R, Z, b, op)
        assert orth.dtype == rel.dtype == np.float64
        # the errors of a consistent row are cancellations near zero
        # (~1e-16, pure rounding): compare on the scale of the tolerance
        # each is held against
        np.testing.assert_allclose(rel, want_r, rtol=1e-9,
                                   atol=RES_TOL * 1e-6)
        np.testing.assert_allclose(orth, want_o, rtol=1e-9,
                                   atol=ORTH_TOL * 1e-6)
        # consistent rows certainly pass, torn rows certainly fail: both
        # land outside the band, where the device verdict is trusted
        assert np.all(orth[:n_good] <= ORTH_TOL / BAND)
        assert np.all(rel[:n_good] <= RES_TOL / BAND)
        assert np.all((orth[n_good:] >= ORTH_TOL * BAND)
                      | (rel[n_good:] >= RES_TOL * BAND))

    def test_routes_agree_and_numpy_operator_is_uploaded(self, monkeypatch):
        n, seed = 64, 9
        A, b, P, Q, R, Z, _ = _cg_rows(n, iters=4, seed=seed)
        dense = _operator("dense", monkeypatch, n, seed)
        sparse = _operator("sparse", monkeypatch, n, seed)
        od, rd = batched.cg_invariant_errors(P, Q, R, Z, b, dense)
        os_, rs = batched.cg_invariant_errors(P, Q, R, Z, b, sparse)
        np.testing.assert_allclose(rd, rs, rtol=1e-9, atol=RES_TOL * 1e-6)
        np.testing.assert_allclose(od, os_, rtol=1e-9, atol=ORTH_TOL * 1e-6)
        # the same operator as numpy arrays, and b as an uploaded tensor
        as_numpy = ("dense", dense[1].numpy())
        o2, r2 = batched.cg_invariant_errors(P, Q, R, Z,
                                             batched.upload(b), as_numpy)
        np.testing.assert_array_equal(o2, od)
        np.testing.assert_array_equal(r2, rd)
        with pytest.raises(ValueError, match="unknown CG operator"):
            batched.cg_invariant_errors(P, Q, R, Z, b, ("csr", None))

    def test_launches_are_cut_to_the_budget(self, monkeypatch):
        n, seed = 64, 9
        A, b, P, Q, R, Z, _ = _cg_rows(n, iters=4, seed=seed)
        op = _operator("dense", monkeypatch, n, seed)
        whole = batched.cg_invariant_errors(P, Q, R, Z, b, op)
        monkeypatch.setattr(batched, "CHUNK_ELEMS", 4 * n * 3)  # 3 rows
        batched.reset_profile()
        cut = batched.cg_invariant_errors(P, Q, R, Z, b, op)
        assert batched.profile["launch_groups"] == -(-len(P) // 3)
        np.testing.assert_allclose(cut[0], whole[0], rtol=1e-12, atol=1e-20)
        # S z comes from one float64 matmul over 3 rows or over 7, and a
        # CPU BLAS may order a row's n-term dot products by the row count
        # (1e-17 apart here). Two orders of sum_j S_ij z_j differ by at
        # most 2 gamma_n (|S| |z|)_i, gamma_n = n u / (1 - n u), and so
        # does the residual's norm; resid_rel divides by ||b||.
        S = op[1].numpy()
        u = np.finfo(np.float64).eps / 2
        gamma_n = n * u / (1 - n * u)
        bound = (2 * gamma_n * np.linalg.norm(np.abs(Z) @ np.abs(S).T, axis=1)
                 / np.linalg.norm(b) + 2 * gamma_n * whole[1])
        assert np.all(np.abs(cut[1] - whole[1]) <= bound)
        # the verdicts the engine takes from them are the same
        assert np.array_equal(cut[0] <= ORTH_TOL, whole[0] <= ORTH_TOL)
        assert np.array_equal(cut[1] <= RES_TOL, whole[1] <= RES_TOL)

    def test_solver_agrees_across_packages(self):
        from repro_torch.algorithms import cg as port_cg
        A, b = make_spd_system(80, seed=3)
        A2, b2 = port_cg.make_spd_system(80, seed=3)
        np.testing.assert_array_equal(b, b2)
        np.testing.assert_array_equal(plain_cg(A, b, 6),
                                      port_cg.plain_cg(A2, b2, 6))


def _chunk_stack(B=7, n=24, seed=11):
    """Full-checksum chunk images: clean ones, a single flipped element,
    a torn (stale) row, and an all-zero slab."""
    rng = np.random.default_rng(seed)
    slabs = []
    for i in range(B):
        cf = ref_abft.encode_full(rng.normal(size=(n, n)) * 10.0)
        if i == 1:
            cf[3, 5] += 0.5
        elif i == 2:
            cf[7, :] = rng.normal(size=n + 1)       # torn row
        elif i == 3:
            cf[:] = 0.0
        slabs.append(cf)
    return slabs


class TestMMChunkStats:
    @pytest.mark.parametrize("as_list", [False, True])
    def test_matches_exact_host_residuals(self, as_list):
        slabs = _chunk_stack()
        V = slabs if as_list else np.stack(slabs)
        nonzero, absmax, rowmax, colmax = batched.mm_chunk_stats(V)
        for i, cf in enumerate(slabs):
            row, col = ref_abft.residuals(cf)
            assert bool(nonzero[i]) == bool(np.any(cf != 0))
            # exact: no accumulation involved
            assert absmax[i] == np.max(np.abs(cf))
            np.testing.assert_allclose(rowmax[i], np.max(np.abs(row)),
                                       rtol=1e-9, atol=1e-11)
            np.testing.assert_allclose(colmax[i], np.max(np.abs(col)),
                                       rtol=1e-9, atol=1e-11)
            tol = 1e-6 + 1e-9 * max(float(absmax[i]), 1.0)
            worst = max(rowmax[i], colmax[i])
            clean = ref_abft.verify(cf, rtol=1e-9, atol=1e-6)
            # clean slabs certainly verify, damaged ones certainly fail
            assert worst <= tol / BAND if clean else worst >= tol * BAND

    def test_groups_follow_the_budget(self, monkeypatch):
        slabs = _chunk_stack(B=5, n=8)
        whole = batched.mm_chunk_stats(slabs)
        monkeypatch.setattr(batched, "CHUNK_ELEMS", 2 * 9 * 9)  # 2 slabs
        assert batched.mm_slabs_per_launch(9) == 2
        batched.reset_profile()
        cut = batched.mm_chunk_stats(slabs)
        assert batched.profile["launch_groups"] == 3
        for a, b in zip(cut, whole):
            np.testing.assert_array_equal(a, b)
        assert all(len(a) == 0 for a in batched.mm_chunk_stats([]))


class TestAbftTwin:
    def test_numpy_path_is_identical(self):
        rng = np.random.default_rng(4)
        C = rng.normal(size=(13, 9))
        for fn in ("encode_cols", "encode_rows", "encode_full"):
            np.testing.assert_array_equal(getattr(abft, fn)(C),
                                          getattr(ref_abft, fn)(C))
        cf = ref_abft.encode_full(C)
        for got, want in zip(abft.residuals(cf), ref_abft.residuals(cf)):
            np.testing.assert_array_equal(got, want)
        assert abft.verify(cf) is True and ref_abft.verify(cf) is True
        bad = cf.copy()
        bad[2, 3] += 1.0
        assert abft.verify(bad) is False
        fixed, nfix = abft.correct_single_error(bad)
        fixed_r, nfix_r = ref_abft.correct_single_error(bad)
        assert nfix == nfix_r == 1
        np.testing.assert_array_equal(fixed, fixed_r)
        assert abft.vector_checksum(C) == ref_abft.vector_checksum(C)
        assert abft.vector_checksum(C).dtype == np.float64

    def test_tensor_path_matches_reference_on_jax_arrays(self):
        import jax
        import jax.numpy as jnp
        rng = np.random.default_rng(6)
        C = rng.normal(size=(11, 7))
        with jax.enable_x64(True):
            cf_ref = np.asarray(ref_abft.encode_full(jnp.asarray(C)))
            res_ref = [np.asarray(x) for x in
                       ref_abft.residuals(jnp.asarray(cf_ref))]
            ok_ref = ref_abft.verify(jnp.asarray(cf_ref))
        cf = abft.encode_full(torch.from_numpy(C))
        assert isinstance(cf, torch.Tensor) and cf.dtype == torch.float64
        # float64 sums of <= 11 terms in another order
        np.testing.assert_allclose(cf.numpy(), cf_ref, rtol=1e-13,
                                   atol=1e-13)
        for got, want in zip(abft.residuals(cf), res_ref):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
        assert abft.verify(cf) is True and ok_ref is True
        np.testing.assert_array_equal(abft.strip(cf).numpy(), C)
        # a tensor keeps its own type in the scalar checksum
        x32 = torch.from_numpy(C.astype(np.float32))
        assert abft.vector_checksum(x32).dtype == torch.float32

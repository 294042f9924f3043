"""Device-math layer for the batched sweep engine (``sweep(mode="batched")``).

The batched engine (repro_torch.scenarios.batched_engine) evaluates
every crash cell of a (workload, strategy) pair from host-side
snapshots; the only per-cell work that is numerically heavy is
integrity checking — CG's invariant backward-scan (orthogonality +
residual per candidate iteration) and ABFT's per-chunk checksum
verification. This module lifts exactly that math onto the torch
device (:func:`repro_torch.get_device`): the engine stacks (cell,
candidate) / (cell, chunk) crash-image rows of a whole sweep matrix and
gets the error magnitudes back from a handful of launches, routed
through the hand-written CUDA kernels (`repro_torch.kernels`) on the
card and their plain versions on the CPU.

Device results are used as a *screen*, not a verdict: accumulation
order on device differs from the host reference by a few ulps, so the
engine accepts a device verdict only outside a safety band around the
tolerance (certainly-ok / certainly-fail) and recomputes the borderline
sliver with the exact host code (`repro_torch.core.invariants`,
`repro_torch.core.abft`). That keeps batched cells bit-identical to
measure-mode cells while the overwhelming majority of checks never
touch the host path. All device math is float64: the band absorbs
summation order, not lost precision.

Launches are cut to the ``CHUNK_ELEMS`` budget, which bounds the
host/device transfer buffers; shapes are otherwise taken as they come.
``profile`` accumulates where the wall time of the calls went (uploads,
device math, download), synchronizing the card at each boundary.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from ...device import get_device
from ...kernels import on_cuda
from ...kernels.abft_matmul.ops import gemm_batch
from ...kernels.checksum_verify.ops import tile_sums_batch

__all__ = ["cuda_runtime_live", "cg_route", "upload", "cg_operator_to_device",
           "cg_invariant_errors", "mm_chunk_stats", "mm_slabs_per_launch",
           "CHUNK_ELEMS", "GEMM_MAX_N", "profile", "reset_profile"]

# per-launch element budget: bounds device/host transfer buffers
CHUNK_ELEMS = 1 << 25

# largest CG system routed through the dense symmetrized-operator GEMM
# (the kernel route on the card — densifying the CSR operator would
# dominate memory beyond this); bigger systems take the engine's
# per-cell fallback there. The sparse route has no such cliff and is
# ungated.
GEMM_MAX_N = 4096

# seconds of wall time spent inside this module's calls, by phase —
# uploads of what many launches share (operator, b), then per launch
# group its upload, device pass and download — and the number of groups
profile: Dict[str, float] = {}


def reset_profile() -> None:
    profile.clear()
    profile.update(shared_upload_seconds=0.0, upload_seconds=0.0,
                   device_seconds=0.0, download_seconds=0.0,
                   launch_groups=0)


reset_profile()


def cuda_runtime_live() -> bool:
    """Whether this process has already initialised CUDA. A forked child
    cannot use a context its parent created — ``scenarios.sweep`` switches
    its worker pool to spawn-start when this is true."""
    return torch.cuda.is_initialized()


class _Phase:
    """Charge the enclosed wall time to one ``profile`` key; on the card
    the phase ends with a synchronize so that queued work is charged to
    the phase that queued it."""

    def __init__(self, key: str, dev: torch.device):
        self._key, self._dev = key, dev

    def __enter__(self):
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        profile[self._key] += time.perf_counter() - self._t0


def _to_device(a, dev: torch.device, dtype=torch.float64) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()    # snapshot views are frozen; torch wants writable
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def upload(a, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a tensor on
    :func:`~repro_torch.get_device`. For inputs that many calls share
    (CG's ``b``, the operator): uploaded once, they are passed on
    without another copy, and the copy is charged to
    ``profile["shared_upload_seconds"]``."""
    dev = get_device()
    with _Phase("shared_upload_seconds", dev):
        return _to_device(a, dev, dtype)


# ---------------------------------------------------------------------------
# CG invariant errors (Eq. 1 orthogonality, Eq. 2 residual)
# ---------------------------------------------------------------------------

def _cg_errors_from_Sz(P, Q, R, b, Sz):
    pq = torch.sum(P * Q, dim=1)
    denom = (torch.linalg.vector_norm(P, dim=1)
             * torch.linalg.vector_norm(Q, dim=1) + 1e-300)
    orth = torch.abs(pq) / denom
    resid = torch.linalg.vector_norm(R - (b[None, :] - Sz), dim=1)
    rel = resid / (torch.linalg.vector_norm(b) + 1e-300)
    return orth, rel


def cg_route() -> str:
    """Which residual-matvec route ``cg_invariant_errors`` will take:
    ``"dense"`` (the fused-epilogue GEMM kernel over the densified
    symmetrized operator — the route on the card, subject to
    :data:`GEMM_MAX_N`) or ``"sparse"`` (batched gather-multiply-sum
    over padded row slabs — O(nnz) per row, the route on the CPU)."""
    return "dense" if on_cuda() else "sparse"


def cg_operator_to_device(operator) -> tuple:
    """Upload a CG operator once: ``("dense", S)`` or ``("sparse", vals,
    cols)`` with numpy arrays in, the same tuple with tensors on
    :func:`~repro_torch.get_device` out. ``cg_invariant_errors`` takes
    either, and moves nothing when handed the uploaded form."""
    kind, *op = operator
    if kind == "dense":
        return ("dense", upload(op[0]))
    if kind == "sparse":
        vals, cols = op
        return ("sparse", upload(vals), upload(cols, torch.int64))
    raise ValueError(f"unknown CG operator representation {kind!r}")


def cg_invariant_errors(P: np.ndarray, Q: np.ndarray, R: np.ndarray,
                        Z: np.ndarray,
                        b: Union[np.ndarray, torch.Tensor], operator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched CG invariant error magnitudes over candidate rows.

    P/Q/R/Z are (T, n) stacks of post-crash overlay rows — one row per
    (cell, candidate iteration) pair. ``operator`` is the symmetrized
    system matrix S = 0.5*(A + A^T) in the representation matching
    :func:`cg_route`: ``("dense", S)`` densified, or
    ``("sparse", vals, cols)`` — (n, K) equal-width row slabs of S,
    rows zero-padded to the widest row (see
    :func:`~repro_torch.scenarios.batched_engine._CGAdccEvaluator._operator`).
    A caller that scans in waves uploads ``operator`` and ``b`` once
    (:func:`cg_operator_to_device`) so that a wave moves only its row
    blocks up and two (T,) vectors down.
    Returns (orth_err (T,), resid_rel (T,)) as float64 numpy arrays:

      orth_err[t]  = |p.q| / (|p||q| + 1e-300)       (vs tol 1e-7)
      resid_rel[t] = ||r - (b - S z)|| / (||b|| + 1e-300)  (vs tol 1e-6)

    the exact quantities OrthogonalityInvariant / ResidualInvariant
    compare — up to device accumulation order, which is why callers
    apply a certainty band before trusting a verdict.
    """
    dev = get_device()
    kind = operator[0]
    if kind not in ("dense", "sparse"):
        raise ValueError(f"unknown CG operator representation {kind!r}")
    T, n = P.shape
    if not isinstance(operator[1], torch.Tensor) \
            or operator[1].device.type != dev.type:
        operator = cg_operator_to_device(operator)
    bt = upload(b)
    if kind == "dense":
        rows = max(1, CHUNK_ELEMS // (4 * n))
    else:
        # the gather materializes (rows, n, K) products
        rows = max(1, CHUNK_ELEMS // (n * operator[1].shape[1]))
    orth = np.empty(T, dtype=np.float64)
    rel = np.empty(T, dtype=np.float64)
    for lo in range(0, T, rows):
        hi = min(lo + rows, T)
        with _Phase("upload_seconds", dev):
            Pt, Qt, Rt, Zt = (_to_device(X[lo:hi], dev)
                              for X in (P, Q, R, Z))
        with _Phase("device_seconds", dev):
            if kind == "dense":
                # stacking all candidate z rows makes the residual
                # matvecs one GEMM launch
                Sz = gemm_batch(Zt, operator[1], acc_dtype=torch.float64)
            else:
                _, vals, cols = operator
                Sz = torch.sum(Zt[:, cols] * vals[None, :, :], dim=-1)
            o, r = _cg_errors_from_Sz(Pt, Qt, Rt, bt, Sz)
        with _Phase("download_seconds", dev):
            orth[lo:hi] = o.cpu().numpy()
            rel[lo:hi] = r.cpu().numpy()
        profile["launch_groups"] += 1
    return orth, rel


# ---------------------------------------------------------------------------
# ABFT chunk statistics
# ---------------------------------------------------------------------------

def mm_slabs_per_launch(m: int) -> int:
    """How many (m, m) slabs one ``mm_chunk_stats`` launch group holds
    under the :data:`CHUNK_ELEMS` budget."""
    return max(1, CHUNK_ELEMS // (m * m))


def _mm_stats(V: torch.Tensor):
    # the data block is read in place through the view's strides
    row_sums, col_sums = tile_sums_batch(V[:, :-1, :-1],
                                         acc_dtype=torch.float64)
    rowmax = torch.amax(torch.abs(V[:, :-1, -1] - row_sums), dim=1)
    colmax = torch.amax(torch.abs(V[:, -1, :-1] - col_sums), dim=1)
    # exact on device: no accumulation, not derived from the sums
    absmax = torch.amax(torch.abs(V), dim=(1, 2))
    nonzero = torch.any(V != 0, dim=2).any(dim=1)
    return nonzero, absmax, rowmax, colmax


def mm_chunk_stats(V: Union[np.ndarray, Sequence[np.ndarray]]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched ABFT checksum statistics over full-checksum matrices.

    V is a (B, m, m) stack — or a sequence of B (m, m) arrays, which is
    stacked one launch group at a time so that the whole stack never
    exists at once — of post-crash chunk images (m = n+1 with the
    checksum row/column in place), one slab per (cell, examined chunk)
    pair. Returns per-slab

      nonzero  any element != 0 (exact on device)
      absmax   max |V| (exact on device — no accumulation)
      rowmax   max row-checksum residual |V[:-1,-1] - sum(data, axis=1)|
      colmax   max col-checksum residual |V[-1,:-1] - sum(data, axis=0)|

    matching ``repro_torch.core.abft.residuals``/``verify`` up to device
    summation order (callers apply a certainty band on rowmax/colmax;
    nonzero and the tolerance derived from absmax are exact).
    """
    dev = get_device()
    B = len(V)
    nonzero = np.empty(B, dtype=bool)
    absmax = np.empty(B, dtype=np.float64)
    rowmax = np.empty(B, dtype=np.float64)
    colmax = np.empty(B, dtype=np.float64)
    if B == 0:
        return nonzero, absmax, rowmax, colmax
    group = mm_slabs_per_launch(V[0].shape[-1])
    for lo in range(0, B, group):
        hi = min(lo + group, B)
        block = V[lo:hi]
        if not isinstance(block, np.ndarray):
            block = np.stack(block)
        with _Phase("upload_seconds", dev):
            Vt = _to_device(block, dev)
        with _Phase("device_seconds", dev):
            nz, am, rm, cm = _mm_stats(Vt)
        with _Phase("download_seconds", dev):
            nonzero[lo:hi] = nz.cpu().numpy()
            absmax[lo:hi] = am.cpu().numpy()
            rowmax[lo:hi] = rm.cpu().numpy()
            colmax[lo:hi] = cm.cpu().numpy()
        profile["launch_groups"] += 1
    return nonzero, absmax, rowmax, colmax

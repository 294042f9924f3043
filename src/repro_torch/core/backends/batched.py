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

The same layer carries the integer math of the KV family's batched
evaluator (SplitMix64 row checksums and value words) and the
``DeviceBackend`` cache transitions (:mod:`.device`): int64 torch ops,
exact, so no band applies to them.

Launches are cut to the ``CHUNK_ELEMS`` budget, which bounds the
host/device transfer buffers; shapes are otherwise taken as they come.
``profile`` accumulates where the wall time of the calls went (uploads,
device math, download), synchronizing the card at each boundary, and
how many calls and rows or entries each kind of integer math took.
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
           "kv_row_checksums", "kv_value_match",
           "cache_op_update", "queue_validity",
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
# group its upload, device pass and download — and the number of groups;
# for the integer math, calls and the rows or entries they covered
profile: Dict[str, float] = {}


def reset_profile() -> None:
    profile.clear()
    profile.update(shared_upload_seconds=0.0, upload_seconds=0.0,
                   device_seconds=0.0, download_seconds=0.0,
                   launch_groups=0,
                   kv_checksum_calls=0, kv_checksum_rows=0,
                   kv_value_calls=0, kv_value_rows=0,
                   cache_op_calls=0, cache_op_entries=0,
                   validity_calls=0, validity_entries=0)


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


# ---------------------------------------------------------------------------
# KV integrity math (SplitMix64 mix-chain checksums, value-word verify)
# ---------------------------------------------------------------------------
#
# Unlike the float CG/ABFT screens above, everything here is 64-bit
# integer arithmetic with wraparound semantics — bit-exact on the card,
# on the CPU and in the numpy oracle — so no certainty band is needed: a
# device verdict IS the host verdict. The batched KV evaluator still
# re-confirms device-flagged-bad rows with the exact host code
# (repro_torch.scenarios.kv), because those rare verdicts are the ones
# that drive visible behavior (row drops, violation counts).
#
# torch has no full uint64 arithmetic, so the words are int64: a
# constant above 2^63 is written as its two's-complement int64 value,
# `+`, `*` and `<<` wrap exactly as their uint64 counterparts do on the
# low 64 bits, and every right shift is made logical by masking off the
# sign bits that torch's arithmetic `>>` copies in.

_SM64_GAMMA = 0x9E3779B97F4A7C15
_SM64_MIX1 = 0xBF58476D1CE4E5B9
_SM64_MIX2 = 0x94D049BB133111EB
_KV_MIX_INIT = 0x243F6A8885A308D3
_KV_VALUE_SALT = 21  # key << 21 ^ seq, matching kv._value_words
_MASK63 = (1 << 63) - 1


def _i64(x: int) -> int:
    """The int64 with the bits of the uint64 ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _np_splitmix(z: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 over uint64 arrays — bit-identical to the
    scalar ``repro_torch.scenarios.kv._splitmix`` (wraparound
    multiplies). The oracle the torch version is held against."""
    with np.errstate(over="ignore"):
        z = z + np.uint64(_SM64_GAMMA)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_SM64_MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_SM64_MIX2)
        return z ^ (z >> np.uint64(31))


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words by ``k`` (0 < k < 64)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _t_splitmix(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64 of int64 words, bit-identical to :func:`_np_splitmix`
    on the same 64 bits."""
    z = z + _i64(_SM64_GAMMA)
    z = (z ^ _lsr(z, 30)) * _i64(_SM64_MIX1)
    z = (z ^ _lsr(z, 27)) * _i64(_SM64_MIX2)
    return z ^ _lsr(z, 31)


def _t_row_checksums(wt: torch.Tensor) -> torch.Tensor:
    """The (N,) checksums of an (N, K) int64 tensor of row words."""
    acc = torch.full((wt.shape[0],), _KV_MIX_INIT, dtype=torch.int64,
                     device=wt.device)
    for j in range(wt.shape[1]):
        acc = _t_splitmix(acc ^ wt[:, j])
    return acc & _MASK63


def _t_value_match(kt: torch.Tensor, st: torch.Tensor, gt: torch.Tensor,
                   nt: torch.Tensor) -> torch.Tensor:
    """The (N,) verdicts of :func:`kv_value_match` on int64 tensors."""
    base = _t_splitmix((kt << _KV_VALUE_SALT) ^ st)
    offs = torch.arange(gt.shape[1], dtype=torch.int64, device=gt.device)
    expect = _t_splitmix(base[:, None] + offs[None, :]) & _MASK63
    live = offs[None, :] < nt[:, None]
    return torch.all((gt == expect) | ~live, dim=1)


def _as_i64(a) -> np.ndarray:
    """int64 or uint64 words as int64 with the same bits (the scalar host
    code's ``w & _MASK64`` on python ints)."""
    a = np.ascontiguousarray(np.asarray(a))
    return (a.view(np.int64) if a.dtype == np.uint64
            else a.astype(np.int64, copy=False))


def kv_row_checksums(words: np.ndarray) -> np.ndarray:
    """Batched order-sensitive 63-bit mix-chain checksum per row.

    ``words`` is an (N, K) int64/uint64 stack of row prefixes (K = 7 for
    KV index rows, 15 for meta rows). Returns the (N,) int64 checksums
    ``acc = splitmix(acc ^ w_j)`` from ``_KV_MIX_INIT``, masked to 63
    bits — the device counterpart of ``repro_torch.scenarios.kv.
    _mix_words``, exact.
    """
    if len(words) == 0:
        return np.empty(0, dtype=np.int64)
    dev = get_device()
    w = _as_i64(words).reshape(len(words), -1)
    N, K = w.shape
    out = np.empty(N, dtype=np.int64)
    rows = max(1, CHUNK_ELEMS // K)
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        with _Phase("upload_seconds", dev):
            wt = _to_device(w[lo:hi], dev, torch.int64)
        with _Phase("device_seconds", dev):
            acc = _t_row_checksums(wt)
        with _Phase("download_seconds", dev):
            out[lo:hi] = acc.cpu().numpy()
        profile["launch_groups"] += 1
    profile["kv_checksum_calls"] += 1
    profile["kv_checksum_rows"] += N
    return out


def kv_value_match(keys: np.ndarray, seqs: np.ndarray, got: np.ndarray,
                   nwords: np.ndarray) -> np.ndarray:
    """Batched value-word verification for KV index rows.

    Row i matches when ``got[i, :nwords[i]]`` equals the deterministic
    value words of (key, seq), ``splitmix(splitmix((key << 21) ^ seq)
    + j) & MASK63`` — the device counterpart of comparing against
    ``repro_torch.scenarios.kv._value_words``. ``got`` is (N, W)
    zero-padded beyond each row's width; words past ``nwords[i]`` are
    not compared. Returns an (N,) bool array. Exact.
    """
    if len(keys) == 0:
        return np.empty(0, dtype=bool)
    dev = get_device()
    k = _as_i64(keys).reshape(-1)
    s = _as_i64(seqs).reshape(-1)
    g = _as_i64(got).reshape(len(k), -1)
    nw = np.asarray(nwords, dtype=np.int64).reshape(-1)
    N, W = g.shape
    out = np.empty(N, dtype=bool)
    rows = max(1, CHUNK_ELEMS // max(1, W))
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        with _Phase("upload_seconds", dev):
            kt, st, gt, nt = (_to_device(x[lo:hi], dev, torch.int64)
                              for x in (k, s, g, nw))
        with _Phase("device_seconds", dev):
            ok = _t_value_match(kt, st, gt, nt)
        with _Phase("download_seconds", dev):
            out[lo:hi] = ok.cpu().numpy()
        profile["launch_groups"] += 1
    profile["kv_value_calls"] += 1
    profile["kv_value_rows"] += N
    return out


# ---------------------------------------------------------------------------
# DeviceBackend step math (forward-pass cache transitions)
# ---------------------------------------------------------------------------

def cache_op_update(present: np.ndarray, dirty: np.ndarray,
                    stamp: np.ndarray, t0: int, is_write: bool, fifo: bool
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, int]:
    """Bulk cache-state transition for one span op touching entries
    ``[e_lo, e_hi)`` when no eviction is needed (the streaming regime).

    Inputs are the per-entry slices of a region's present/dirty bitmaps
    and LRU stamps; ``t0`` is the op's base clock tick. Returns
    ``(new_present, new_dirty, new_stamp, miss, n_miss)`` — exactly the
    state ``VectorizedBackend._op`` produces for a no-eviction op:

      * every touched entry ends resident;
      * a write dirties all touched entries, a read preserves dirt on
        hits and leaves misses clean;
      * LRU restamps every entry with ``t0 + position``; FIFO restamps
        misses only (hits keep their insertion stamp);
      * ``n_miss`` misses were fetched (the caller charges read traffic
        and queue-appends accordingly), as a Python int: reading it
        waits for the card.

    Only the inputs a variant reads go up (``stamp`` for FIFO, ``dirty``
    for a read); the all-resident bitmap is not a result of the card's
    and is made on the host. The caller must pre-check capacity and keep
    the host path when the op could evict.
    """
    dev = get_device()
    m = len(present)
    with _Phase("upload_seconds", dev):
        pt = _to_device(present, dev, torch.bool)
        dt = None if is_write else _to_device(dirty, dev, torch.bool)
        st = _to_device(stamp, dev, torch.int64) if fifo else None
    with _Phase("device_seconds", dev):
        miss = ~pt
        new_stamp = torch.arange(t0, t0 + m, dtype=torch.int64, device=dev)
        if fifo:
            new_stamp = torch.where(miss, new_stamp, st)
        new_dirty = None if is_write else dt & pt
        n_miss = int(miss.sum())
    with _Phase("download_seconds", dev):
        new_dirty = (np.ones(m, dtype=bool) if is_write
                     else new_dirty.cpu().numpy())
        new_stamp = new_stamp.cpu().numpy()
        miss = miss.cpu().numpy()
    profile["launch_groups"] += 1
    profile["cache_op_calls"] += 1
    profile["cache_op_entries"] += m
    return np.ones(m, dtype=bool), new_dirty, new_stamp, miss, n_miss


def queue_validity(present: np.ndarray, stamp: np.ndarray,
                   entries: np.ndarray, stamps: np.ndarray,
                   weight: int) -> Tuple[np.ndarray, np.ndarray]:
    """Eviction-queue slot validation for a single-region window.

    A queue slot is live when its entry is still resident and its
    recorded stamp matches the entry's current stamp (stale LRU
    re-touch duplicates fail the stamp check). Returns ``(valid, wts)``
    with ``wts[i] = weight`` (the region's sector-line weight) on valid
    slots and 0 elsewhere — the single-rid core of
    ``VectorizedBackend._validity``.
    """
    dev = get_device()
    n = len(entries)
    with _Phase("upload_seconds", dev):
        pt = _to_device(present, dev, torch.bool)
        st = _to_device(stamp, dev, torch.int64)
        et = _to_device(entries, dev, torch.int64)
        qt = _to_device(stamps, dev, torch.int64)
    with _Phase("device_seconds", dev):
        valid = pt[et] & (st[et] == qt)
        wts = valid.to(torch.int64) * int(weight)
    with _Phase("download_seconds", dev):
        valid = valid.cpu().numpy()
        wts = wts.cpu().numpy()
    profile["launch_groups"] += 1
    profile["validity_calls"] += 1
    profile["validity_entries"] += n
    return valid, wts

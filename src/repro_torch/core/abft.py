"""ABFT checksum algebra (paper §III.C, Eqs. 3-6).

Column-checksum encoding  A_c = [A ; v^T A]   (extra last row)
Row-checksum encoding     B_r = [B , B w]     (extra last column)
Full-checksum product     C_f = A_c @ B_r  =  [AB, ABw ; v^T AB, v^T A B w]

with v = w = ones. The checksum relationships (Eq. 6)

    C_f[m, j]  = sum_i C_f[i, j]      (column sums match the extra row)
    C_f[i, n]  = sum_j C_f[i, j]      (row sums match the extra column)

hold for any matrix produced by valid computation; a crash that leaves a
tile half-updated breaks them. A *single* corrupted element sits at the
intersection of the one inconsistent row and one inconsistent column and
can be corrected from either checksum; torn whole rows are detectable
(and recomputable row-wise) via the row checksum.

Everything here works on both numpy arrays and torch tensors (the
module dispatches on the input), so the crash-emulator algorithms and
the kernels' oracles share one implementation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "encode_cols",
    "encode_rows",
    "encode_full",
    "strip",
    "verify",
    "residuals",
    "correct_single_error",
    "vector_checksum",
]


def _xp(a):
    """``torch`` for a tensor, ``numpy`` for everything else. The calls
    below use the spellings both accept (``axis=``, ``keepdims=``,
    ``concatenate``)."""
    return torch if isinstance(a, torch.Tensor) else np


def encode_cols(A):
    """A (m,k) -> A_c (m+1,k): append column-sum row (Eq. 3)."""
    xp = _xp(A)
    return xp.concatenate([A, xp.sum(A, axis=0, keepdims=True)], axis=0)


def encode_rows(B):
    """B (k,n) -> B_r (k,n+1): append row-sum column (Eq. 4)."""
    xp = _xp(B)
    return xp.concatenate([B, xp.sum(B, axis=1, keepdims=True)], axis=1)


def encode_full(C):
    """C (m,n) -> C_f (m+1,n+1) with both checksums (Eq. 5 layout)."""
    return encode_rows(encode_cols(C))


def strip(Cf):
    """Drop the checksum row+column."""
    return Cf[:-1, :-1]


def residuals(Cf) -> Tuple[np.ndarray, np.ndarray]:
    """(row_resid (m,), col_resid (n,)):

    row_resid[i] = Cf[i, -1] - sum_j Cf[i, :-1]   (row checksum error)
    col_resid[j] = Cf[-1, j] - sum_i Cf[:-1, j]   (column checksum error)

    Note both residual vectors *exclude* the checksum row/col themselves,
    i.e. they cover the data block of C_f.
    """
    xp = _xp(Cf)
    row = Cf[:-1, -1] - xp.sum(Cf[:-1, :-1], axis=1)
    col = Cf[-1, :-1] - xp.sum(Cf[:-1, :-1], axis=0)
    return row, col


def verify(Cf, rtol: float = 1e-8, atol: float = 1e-6) -> bool:
    """True iff both checksum relationships hold (within fp tolerance,
    scaled by the magnitude of the data block)."""
    xp = _xp(Cf)
    row, col = residuals(Cf)
    scale = max(float(xp.max(xp.abs(Cf))), 1.0)
    tol = atol + rtol * scale
    ok = (xp.max(xp.abs(row)) <= tol) & (xp.max(xp.abs(col)) <= tol)
    return bool(ok)


def correct_single_error(Cf, rtol: float = 1e-8, atol: float = 1e-6):
    """Detect-and-correct for a single corrupted data element (numpy only;
    recovery runs on host). Returns (corrected copy, n_corrected) or
    (None, -1) if the corruption pattern is not single-error correctable.
    """
    Cf = np.asarray(Cf).copy()
    row, col = residuals(Cf)
    scale = max(float(np.max(np.abs(Cf))), 1.0)
    tol = atol + rtol * scale
    bad_rows = np.nonzero(np.abs(row) > tol)[0]
    bad_cols = np.nonzero(np.abs(col) > tol)[0]
    if len(bad_rows) == 0 and len(bad_cols) == 0:
        return Cf, 0
    if len(bad_rows) == 1 and len(bad_cols) == 1:
        i, j = int(bad_rows[0]), int(bad_cols[0])
        # both residuals must agree on the error magnitude
        if abs(row[i] - col[j]) <= 2 * tol:
            Cf[i, j] += row[i]
            return Cf, 1
    # a corrupted *checksum* element (data intact) shows as one bad row
    # XOR one bad col; rebuild it from the data
    if len(bad_rows) == 1 and len(bad_cols) == 0:
        i = int(bad_rows[0])
        Cf[i, -1] = np.sum(Cf[i, :-1])
        return Cf, 1
    if len(bad_cols) == 1 and len(bad_rows) == 0:
        j = int(bad_cols[0])
        Cf[-1, j] = np.sum(Cf[:-1, j])
        return Cf, 1
    return None, -1


def vector_checksum(x):
    """Scalar checksum of a vector/tensor: sum of all elements. Linear,
    so it can be maintained incrementally across linear updates — the
    property the ADCC training-state layer relies on."""
    if _xp(x) is np:
        return np.sum(x, dtype=np.float64)
    return torch.sum(x)

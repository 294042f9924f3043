"""CUDA kernel launcher: tiled checksum-consistency detection.

The recovery path's hot loop (paper §III.C "detecting where to restart")
is a full pass over a checksummed matrix computing row and column sums
to compare against the embedded checksums. The kernel reads a stack of
matrices once, through its strides, and writes per-tile row and column
partial sums. Source and design notes: ``csrc/tile_sums.cu``.

:func:`tile_sums_cuda` launches the kernel and returns the partials;
``ops.py`` adds them across tiles (a fixed-order second step instead of
atomics). :func:`tile_sums_plain` is the plain PyTorch version of the
same function: ``ops.py`` takes it for CPU tensors, and the card's smoke
run holds the kernel against it. ``launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = ["tile_sums_cuda", "tile_sums_plain", "launches"]

launches = 0

# (input dtype, accumulator dtype) -> C entry point
_ENTRY = {
    (torch.float32, torch.float32): "tile_sums_f32",
    (torch.bfloat16, torch.float32): "tile_sums_bf16",
    (torch.float64, torch.float64): "tile_sums_f64",
}

# CUDA's limit on the second and third grid dimensions
_GRID_YZ_MAX = 65535

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tile_sums")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i64, i64, i64, ptr]
            fn.restype = i32
        for name in ("tile_sums_tile_m", "tile_sums_tile_n"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        _lib = lib
    return _lib


def tile_sums_cuda(x: torch.Tensor, *,
                   acc_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA tensor ``x (B, m, n)`` of any strides
    (a sliced view is read in place). Returns ``(row_partials
    (B, m, n_tiles), col_partials (B, m_tiles, n))`` in ``acc_dtype``.
    Raises for a tensor that is not on the card or a type pair the
    kernel lacks."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"tile_sums_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"expected (B, m, n), got {tuple(x.shape)}")
    if (x.dtype, acc_dtype) not in _ENTRY:
        raise TypeError(f"no tile_sums kernel for input {x.dtype} with "
                        f"accumulator {acc_dtype}")
    lib = _library()
    B, m, n = x.shape
    mi = -(-m // lib.tile_sums_tile_m())
    nj = -(-n // lib.tile_sums_tile_n())
    if mi > _GRID_YZ_MAX or nj > _GRID_YZ_MAX:
        raise ValueError(f"matrix ({m}, {n}) exceeds the kernel's grid")
    rowp = torch.empty((B, m, nj), dtype=acc_dtype, device=x.device)
    colp = torch.empty((B, mi, n), dtype=acc_dtype, device=x.device)
    if B == 0 or m == 0 or n == 0:
        return rowp, colp
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[(x.dtype, acc_dtype)])(
            x.data_ptr(), rowp.data_ptr(), colp.data_ptr(), B, m, n,
            x.stride(0), x.stride(1), x.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"tile_sums kernel launch failed: CUDA error "
                           f"{err} for shape {(B, m, n)}")
    launches += 1
    return rowp, colp


def tile_sums_plain(x: torch.Tensor, *,
                    acc_dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(row_sums (B, m), col_sums (B, n))`` of
    ``x (B, m, n)`` accumulated in ``acc_dtype``."""
    xa = x.to(acc_dtype)
    return xa.sum(dim=2), xa.sum(dim=1)

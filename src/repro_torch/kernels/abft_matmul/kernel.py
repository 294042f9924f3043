"""CUDA kernel launcher: matrix product with fused ABFT-checksum epilogue.

The paper's §III.C mechanism generates the checksums while the product
is being written; on the card that is the kernel's epilogue: each block
writes its C tile together with the tile's row and column sums, both
taken from the register accumulator before the cast to the output type,
so the checksums cost no second pass over C. Source and design notes:
``csrc/abft_matmul.cu``.

:func:`abft_matmul_cuda` launches the kernel and returns per-tile
partials; the small cross-tile sums happen in ``ops.py`` (a fixed-order
second step instead of atomics). :func:`abft_matmul_plain` is the plain
PyTorch version of the same function: ``ops.py`` takes it for CPU
tensors, and the card's smoke run holds the kernel against it.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = ["abft_matmul_cuda", "abft_matmul_plain", "launches"]

launches = 0

_NAME = _build.TYPE_NAMES
# (operand dtype, accumulator dtype) -> C entry point: operands of any of
# the four floating types, accumulated in float32 or float64
_ENTRY = {(t, acc): f"abft_mm_{_NAME[t]}_{_NAME[acc]}"
          for t in _NAME for acc in (torch.float32, torch.float64)}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("abft_matmul")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                           i64, i64, i64, i32, ptr]
            fn.restype = i32
        for name in ("abft_mm_tile_m", "abft_mm_tile_n"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        _lib = lib
    return _lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    # the kernel takes any row stride but needs unit column stride
    return t if t.stride(1) == 1 or t.shape[1] == 1 else t.contiguous()


def abft_matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                     acc_dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors ``a (m, k)``, ``b (k, n)``.

    Operands of float16, bfloat16, float32 or float64, accumulated in
    ``acc_dtype`` (float32 or float64). Operands of two types go to the
    wider one first (torch.promote_types: exact, as the reference's
    ``jnp.dot`` promotes); C keeps a's dtype, rounded once from the
    accumulator. Returns ``(C (m, n) in a's dtype, row_partials (m,
    n_tiles), col_partials (m_tiles, n))``, partials in ``acc_dtype``.
    Raises for a tensor that is not on the card, mismatched shapes, or a
    type outside those."""
    global launches
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("abft_matmul_cuda needs both operands on one "
                         f"CUDA device, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _NAME or b.dtype not in _NAME \
            or acc_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"no abft_matmul kernel for inputs {a.dtype}/"
                        f"{b.dtype} with accumulator {acc_dtype}")
    out_dtype = a.dtype
    wide = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(wide), b.to(wide)
    # C straight in a's dtype where that is the operands' type; else the
    # kernel writes the accumulator and C is that rounded once to a's dtype
    c_acc = out_dtype != wide
    lib = _library()
    m, k = a.shape
    n = b.shape[1]
    a, b = _rows(a), _rows(b)
    mi = -(-m // lib.abft_mm_tile_m())
    nj = -(-n // lib.abft_mm_tile_n())
    c = torch.empty((m, n), dtype=acc_dtype if c_acc else wide,
                    device=a.device)
    rowp = torch.empty((m, nj), dtype=acc_dtype, device=a.device)
    colp = torch.empty((mi, n), dtype=acc_dtype, device=a.device)
    if m == 0 or n == 0:
        return c.to(out_dtype), rowp, colp
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[(wide, acc_dtype)])(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), rowp.data_ptr(),
            colp.data_ptr(), m, k, n, a.stride(0), b.stride(0), c.stride(0),
            int(c_acc), stream)
    if err != 0:
        raise RuntimeError(f"abft_matmul kernel launch failed: CUDA error "
                           f"{err} for shapes ({m},{k})@({k},{n})")
    launches += 1
    return c.to(out_dtype), rowp, colp


def abft_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                      acc_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(C in a's dtype, row_cs (m,), col_cs
    (n,))`` with product and sums in ``acc_dtype``."""
    acc = a.to(acc_dtype) @ b.to(acc_dtype)
    return acc.to(a.dtype), acc.sum(dim=1), acc.sum(dim=0)

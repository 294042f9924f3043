"""CUDA kernel launcher: blockwise causal GQA attention (forward only).

The serving prefill's attention: every query row's softmax over the keys
it may see, with the online-softmax state carried across key tiles so
the (S, S) score matrix never reaches device memory. The kernel reads q
``(B, S, H, hd)`` and k/v ``(B, S, KV, hd)`` through their strides and
writes ``(B, S, H, hd)``; query head ``h`` reads key/value head
``h // (H // KV)``. Source and design notes: ``csrc/flash_attention.cu``.

:func:`flash_attention_cuda` launches the kernel. :func:`flash_attention_plain`
is the plain PyTorch version of the same function: ``ops.py`` takes it for
CPU tensors, and the card's smoke run holds the kernel against it.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches",
           "MAX_HEAD_DIM", "NEG_INF", "BF16_RTOL", "BF16_ATOL", "F32_TOL"]

launches = 0

NEG_INF = -1e30

# What the kernel is held to against flash_attention_plain on the same
# inputs. bf16: both compute in float32 from the same bf16 inputs (the
# kernel carries p to about 16 bits as bf16 hi + lo) and differ where the
# final rounding to bf16 falls on another side, by one bf16 ulp, at most
# 2^-7 of the value; the bound is two ulps relative, the atol only covers
# values that round near zero. f32: summation order of a float32 softmax,
# both sides full float32, no TF32.
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-5
F32_TOL = 1e-5

# head dims the kernel takes: multiples of 8 up to MAX_HEAD_DIM. It is
# instantiated for tiles of 16, 32, 64 and 128 columns and runs any other
# head dim in the next of them, the columns beyond hd zero-filled
MAX_HEAD_DIM = 128

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}

# CUDA's limit on the second grid dimension: batch * query heads for the
# float32 kernel, query tiles of 128 rows for the bfloat16 one
_GRID_Y_MAX = 65535
_BF16_QUERY_TILE = 128

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ptr] * 4 + [i32] * 6 + [ctypes.c_float]
                           + [i64] * 9 + [ptr])
            fn.restype = i32
        _lib = lib
    return _lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, S, H, hd) and k/v (B, S, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {KV}")


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` in place: unit stride on hd, and for
    bfloat16 (copied in 16-byte chunks) a 16-byte aligned start and strides
    that are multiples of 8 elements."""
    if t.stride(3) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(t.stride(d) % 8 == 0
                                          for d in range(3))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q ``(B, S, H, hd)``, k/v
    ``(B, S, KV, hd)`` of one dtype (float32 or bfloat16), any strides
    (a copy is made only where the kernel cannot read a tensor in place,
    see :func:`_readable`). Returns
    ``(B, S, H, hd)`` contiguous in q's dtype. Raises for mismatched
    shapes, mixed or other dtypes, a head dim that is not a multiple of 8
    up to ``MAX_HEAD_DIM``, and a
    tensor that is not on the card or devices that differ."""
    global launches
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"no flash_attention kernel for {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; it takes one of float32, bfloat16")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"no flash_attention kernel for head_dim {hd}; it "
                         f"takes multiples of 8 from 8 to {MAX_HEAD_DIM}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    grid_y = (B * H if q.dtype == torch.float32
              else -(-S // _BF16_QUERY_TILE))
    if grid_y > _GRID_Y_MAX:
        raise ValueError(f"q {(B, S, H, hd)} exceeds the kernel's grid")
    q, k, v = (t if _readable(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0 or H == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, KV, hd, int(bool(causal)), 1.0 / (hd ** 0.5),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} for q {(B, S, H, hd)}, kv heads {KV}")
    launches += 1
    return o


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the whole (S, S) score matrix in float32,
    scale ``1/sqrt(hd)`` after the dot, masked logits ``NEG_INF``,
    softmax, product with v in float32, cast to q's dtype. GQA by
    grouping the query heads, not by repeating k/v."""
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    logits.mul_(1.0 / (hd ** 0.5))
    if causal:
        pos = torch.arange(S, device=q.device)
        logits.masked_fill_(pos[None, :] > pos[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)

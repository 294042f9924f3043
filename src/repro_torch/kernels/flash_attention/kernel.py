"""CUDA kernel launcher: blockwise causal GQA attention (forward only).

The serving prefill's attention: every query row's softmax over the keys
it may see, with the online-softmax state carried across key tiles so
the (S, S) score matrix never reaches device memory. The kernel reads q
``(B, S, H, hd)`` and k/v ``(B, S, KV, hd)`` through their strides and
writes ``(B, S, H, hd)``; query head ``h`` reads key/value head
``h // (H // KV)``. It takes every input the reference's Pallas kernel
takes: any head dim and any dtype, computed in float32 and written in q's
dtype; :func:`route` says which kernel of ``csrc/flash_attention.cu`` an
input goes to. Source and design notes: ``csrc/flash_attention.cu``.

:func:`flash_attention_cuda` launches the kernel. :func:`flash_attention_plain`
is the plain PyTorch version of the same function: ``ops.py`` takes it for
CPU tensors, and the card's smoke run holds the kernel against it.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches",
           "route", "Route", "NEG_INF", "BF16_RTOL", "BF16_ATOL",
           "F16_RTOL", "F16_ATOL", "F32_TOL", "tolerance"]

launches = 0

NEG_INF = -1e30

# What the kernel is held to against flash_attention_plain on the same
# inputs. bf16: both compute in float32 from the same bf16 inputs (the
# kernel carries p to about 16 bits as bf16 hi + lo) and differ where the
# final rounding to bf16 falls on another side, by one bf16 ulp, at most
# 2^-7 of the value; the bound is two ulps relative, the atol only covers
# values that round near zero. f16: the same with f16's ulp, at most 2^-10
# of the value, so two ulps are 2^-9; p is carried as f16 hi + lo, whose lo
# lies on the subnormal grid of 2^-24 for most p, an absolute error of at
# most 2^-25 in each p, far below an ulp of the output (the CPU emulation
# of the kernel's arithmetic in tests/test_torch_flash.py meets it at the
# prefill's length); the atol as for bf16. f32: summation order of a
# float32 softmax, both sides full float32, no TF32; float64 inputs are
# computed in float32 (the reference's kernel casts them), so they are held
# to the same bound.
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-5
F16_RTOL, F16_ATOL = 2e-3, 1e-5
F32_TOL = 1e-5


def tolerance(dtype: torch.dtype):
    """``(rtol, atol)`` the kernel's output of ``dtype`` is held to against
    :func:`flash_attention_plain`."""
    if dtype == torch.bfloat16:
        return BF16_RTOL, BF16_ATOL
    if dtype == torch.float16:
        return F16_RTOL, F16_ATOL
    return F32_TOL, F32_TOL


# the dtypes with an entry point of their own; any other goes to float32
_NAME = _build.TYPE_NAMES
# tile widths of the kernels up to hd 256; past it, 128-column chunks
_TILES = (16, 32, 64, 128, 256)
_CHUNK = 128


class Route(NamedTuple):
    """Which kernel an input takes: the C entry point, the kernel
    (``"wgmma"``, ``"fma"`` or ``"fma_chunks"``), its tile width in
    columns, the dtype the wrapper casts q, k and v to first (None: read
    as they are) and the head dim it pads them to with zero columns (None:
    no padding)."""
    entry: str
    kernel: str
    tile: int
    cast: Optional[torch.dtype]
    pad: Optional[int]


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Route:
    """The kernel q, k, v go to, from their dtypes and head dim alone.

    bf16 or f16 throughout: the tensor cores (wgmma) up to hd 256, a head
    dim that is not a multiple of 8 padded to the next one (the kernel
    copies 16-byte chunks). f32 or f64 throughout: the FMA kernel up to hd
    256. Past hd 256, any of these four: the FMA kernel over 128-column
    chunks. Mixed dtypes, or any other dtype (float8 included), are cast
    to float32 first, as the reference's kernel casts its blocks, and
    take float32's route; the output is cast back to q's dtype."""
    hd = q.shape[-1]
    dtype, cast = q.dtype, None
    if not (q.dtype == k.dtype == v.dtype) or dtype not in _NAME:
        dtype = cast = torch.float32
    entry = f"flash_attention_{_NAME[dtype]}"
    if hd > _TILES[-1]:
        return Route(entry, "fma_chunks", _CHUNK, cast, None)
    wgmma = dtype in (torch.bfloat16, torch.float16)
    pad = -(-hd // 8) * 8 if wgmma and hd % 8 else None
    tile = next(t for t in _TILES if t >= (pad or hd))
    return Route(entry, "wgmma" if wgmma else "fma", tile, cast, pad)


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _NAME.values():
            fn = getattr(lib, f"flash_attention_{name}")
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


def _readable(t: torch.Tensor, kernel: str) -> bool:
    """Whether the kernel reads ``t`` in place: unit stride on hd, and for
    the wgmma kernel (which copies 16-byte chunks) a 16-byte aligned start
    and strides that are multiples of 8 elements."""
    if t.stride(3) != 1:
        return False
    if kernel != "wgmma":
        return True
    return t.data_ptr() % 16 == 0 and all(t.stride(d) % 8 == 0
                                          for d in range(3))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q ``(B, S, H, hd)``, k/v
    ``(B, S, KV, hd)`` of any dtype and head dim, any strides. A copy is
    made only where :func:`route` asks for a cast or a zero-padded head
    dim, or where the kernel cannot read a tensor in place (see
    :func:`_readable`). Returns ``(B, S, H, hd)`` contiguous in q's dtype.
    Raises for mismatched shapes, query heads that are not a multiple of
    the kv heads, and a tensor that is not on the card or devices that
    differ."""
    global launches
    _check_shapes(q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    out_dtype = q.dtype
    r = route(q, k, v)
    if r.cast is not None:
        q, k, v = (t.to(r.cast) for t in (q, k, v))
    if r.pad is not None:
        q, k, v = (F.pad(t, (0, r.pad - hd)) for t in (q, k, v))
    q, k, v = (t if _readable(t, r.kernel) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    width = r.pad or hd
    o = torch.empty((B, S, H, width), dtype=q.dtype, device=q.device)
    if B and S and H and hd:
        lib = _library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, r.entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, S, H, KV, width, int(bool(causal)), 1.0 / (hd ** 0.5),
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err} for q {(B, S, H, hd)}, kv heads "
                               f"{KV}, {r}")
        launches += 1
    if r.pad is not None:
        o = o[..., :hd].contiguous()
    return o.to(out_dtype)


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

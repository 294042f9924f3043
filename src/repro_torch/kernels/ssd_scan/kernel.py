"""CUDA kernel launchers: the SSD's state passing across chunks.

The chunked SSD (``models/mamba2.py``) carries a (B, H, hd, N) state from
chunk to chunk: ``state_{c+1} = state_c * a_c + S_c[:, c]``, emitting the
state entering each chunk. :func:`state_pass_fwd_cuda` runs that
recurrence for all chunks in one launch, :func:`state_pass_bwd_cuda` its
reverse scan, which gives the gradients of the chunks' contributions and
(as per-warp partials, added by ``ops.py`` in a fixed order) of the
decays. Source and design notes: ``csrc/ssd_state_pass.cu``.

:func:`state_pass_plain` is the plain PyTorch version: the loop as the
model ran it before the kernel, on the per-chunk log decays. ``ops.py``
takes it for any tensor that is not on a CUDA card, and the card's smoke
run holds the kernel against it. ``launches`` counts kernel launches,
forward and backward, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = ["state_pass_fwd_cuda", "state_pass_bwd_cuda", "state_pass_plain",
           "row_view", "launches"]

launches = 0

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ssd_state_pass")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_state_pass_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                           i64, i64, i64, i32, ptr]
        lib.ssd_state_pass_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, i32, i64, i64, i64, i32, ptr]
        lib.ssd_state_pass_warps.argtypes = [i32, i32]
        for fn in (lib.ssd_state_pass_fwd, lib.ssd_state_pass_bwd,
                   lib.ssd_state_pass_warps):
            fn.restype = i32
        _lib = lib
    return _lib


def row_view(x: torch.Tensor) -> torch.Tensor:
    """``x (B, nc, H, hd, N)`` as the kernels read it: (B, nc, H, L) with
    each (b, c, h) row of ``L = hd * N`` elements contiguous, a view where
    ``x``'s strides allow it (the einsum's and autograd's outputs on the
    main path) and otherwise one contiguous copy."""
    B, nc, H, hd, N = x.shape
    if (N > 1 and x.stride(4) != 1) or (hd > 1 and x.stride(3) != N):
        x = x.contiguous()
    return x.view(B, nc, H, hd * N)


def _vec(L: int, *ts: torch.Tensor) -> int:
    """4 where every row starts on 16 bytes (pointers and strides), else 1."""
    ok = L % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:3])
        for t in ts)
    return 4 if ok else 1


def _check(err: int, what: str, shape) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"ssd_state_pass {what} launch failed: CUDA error "
                           f"{err} for shape {tuple(shape)}")
    launches += 1


def state_pass_fwd_cuda(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``a (B, nc, H)`` the chunks' decays, ``s (B, nc, H, L)`` their
    contributions (rows contiguous, any batch / chunk / head strides), both
    float32 on one card. Returns the states entering the chunks, (B, nc,
    H, L) contiguous."""
    B, nc, H, L = s.shape
    a = a.contiguous()
    out = torch.empty((B, nc, H, L), dtype=torch.float32, device=s.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().ssd_state_pass_fwd(
            a.data_ptr(), s.data_ptr(), out.data_ptr(), B, nc, H, L,
            s.stride(0), s.stride(1), s.stride(2), _vec(L, s), stream)
    _check(err, "forward", s.shape)
    return out


def state_pass_bwd_cuda(a: torch.Tensor, states: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse scan: ``a (B, nc, H)``, ``states (B, nc, H, L)`` the
    forward's output (contiguous), ``g`` its gradient (rows contiguous).
    Returns ``(ds (B, nc, H, L), da_partials (B, nc, H, warps))``; the
    decays' gradient is ``da_partials.sum(-1)``."""
    B, nc, H, L = states.shape
    a = a.contiguous()
    lib = _library()
    vec = _vec(L, g)
    warps = lib.ssd_state_pass_warps(L, vec)
    ds = torch.empty_like(states)
    dap = torch.empty((B, nc, H, warps), dtype=torch.float32,
                      device=states.device)
    if ds.numel() == 0:
        return ds, dap
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_state_pass_bwd(
            a.data_ptr(), states.data_ptr(), g.data_ptr(), ds.data_ptr(),
            dap.data_ptr(), B, nc, H, L, g.stride(0), g.stride(1),
            g.stride(2), vec, stream)
    _check(err, "backward", states.shape)
    return ds, dap


def state_pass_plain(la_tot: torch.Tensor, S_c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``la_tot (B, nc, H)`` each chunk's summed
    log decay, ``S_c (B, nc, H, hd, N)`` its contribution; the states
    entering the chunks, (B, nc, H, hd, N). A loop over chunks that
    carries the state, differentiated by autograd."""
    Bb, nc, H, hd, N = S_c.shape
    state = torch.zeros((Bb, H, hd, N), dtype=S_c.dtype, device=S_c.device)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(la_tot[:, c])[:, :, None, None] + S_c[:, c]
    return torch.stack(states_in, dim=1)

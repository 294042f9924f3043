"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

The JAX package's ``models/mamba2.py`` in torch ops (it reaches no Pallas
kernel there either). The full-sequence path is the chunked SSD: within
a chunk the recurrence is a masked (semiseparable) product, across chunks
a loop carries the (heads, head_dim, state) state. Decode is the
recurrent update, one token at a time, O(1) in the sequence's length.

Layout as in the reference: ``in_proj`` emits [z | x | B | C | dt], a
depthwise causal conv (width 4) runs over [x | B | C], a decay ``A`` per
head, ``dt`` per head, a ``D`` skip, a SiLU(z) gate, ``out_proj``. One
B/C group. The SSD's products, the decay and ``dt`` run in float32
whatever the compute type; ``A_log``, ``dt_bias`` and ``D_skip`` are
float32 parameters (the train step's compute copy holds them in the
compute type, as the reference's does, and float32 math promotes them).

Under tensor parallelism (``layers.tp_weights`` on a DeviceMesh whose
"model" axis divides ``d_inner``) ``out_proj`` is split by its rows, as
the reference places it. Each rank runs the SSD for the heads whose
columns its rows read (:func:`ssd_heads`), from its own columns of
``in_proj`` (its rows' z, its heads' x and dt, B and C whole) and its
heads' conv channels, decays and skips; the weights stay whole on every
rank. That is ``ceil(H / tp)`` heads, as XLA splits the reference's,
at the production meshes' TP of 16 for both Mamba2 archs; a rank whose
columns start inside a head may span one head more than that (7 heads
over 4 ranks: 3 on the middle two). It projects its slice
of the gated inner activations, and the ranks' outputs are summed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["Mamba2", "mamba2_apply", "mamba2_body", "mamba2_decode_step",
           "mamba2_cache_init", "mamba2_dims", "ssd_heads"]

F32 = torch.float32
silu = nn.functional.silu


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, n_heads, conv_channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_state  # x, B, C get convolved
    return d_inner, nheads, conv_ch


class Mamba2(nn.Module):
    """in_proj (D, 2 d_inner + 2 N + H), conv_w (W, C), conv_b (C,) and
    out_proj (d_inner, D) in ``cfg.param_dtype``; A_log, dt_bias and
    D_skip (H,) in float32."""

    AXES = {"in_proj": ("embed", "ssm_proj"),
            "conv_w": ("conv_width", "ssm_conv"), "conv_b": ("ssm_conv",),
            "A_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "D_skip": ("ssm_heads",), "out_proj": ("ssm_inner", "embed")}
    # whole on every rank, each of which reads its own heads' part
    TP_PARTIAL = ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                  "D_skip")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, N = cfg.d_model, cfg.ssm_state
        d_inner, nheads, conv_ch = mamba2_dims(cfg)
        dt = L.dtype_of(cfg.param_dtype)
        self.nheads, self.d_inner = nheads, d_inner
        self.in_proj = L.empty_weight((D, 2 * d_inner + 2 * N + nheads), dt,
                                      device)
        self.conv_w = L.empty_weight((cfg.ssm_conv_width, conv_ch), dt,
                                     device)
        self.conv_b = L.empty_weight((conv_ch,), dt, device)
        self.A_log = L.empty_weight((nheads,), F32, device)
        self.dt_bias = L.empty_weight((nheads,), F32, device)
        self.D_skip = L.empty_weight((nheads,), F32, device)
        self.out_proj = L.empty_weight((d_inner, D), dt, device)

    def splits(self, tp: int) -> bool:
        return self.d_inner % tp == 0

    def init_(self, generator: torch.Generator) -> None:
        """The reference's scales: projections N(0, 2 / (in + out)), conv
        taps N(0, 0.1^2), conv bias 0, A = -linspace(1, 16) per head
        (``A_log`` its log), dt bias 0.5, D skip 1."""
        with torch.no_grad():
            L.dense_init_(self.in_proj, generator)
            self.conv_w.normal_(0.0, 0.1, generator=generator)
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, self.nheads, dtype=F32)))
            self.dt_bias.fill_(0.5)
            self.D_skip.fill_(1.0)
            L.dense_init_(self.out_proj, generator)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """[z | x | B | C | dt] of the in-projection's last dim."""
    d_inner, nheads, _ = mamba2_dims(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner, N, N, nheads], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, then SiLU. u: (B, S, C); w: (W, C). The W
    taps are added one after the other, oldest first, as the
    reference's unrolled loop does."""
    W, S = w.shape[0], u.shape[1]
    pad = nn.functional.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros_like(u)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return silu(out + b)


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] =
    sum_{j < u <= i} log_a[..., u], -inf above the diagonal. The mask is
    applied before any ``exp``: the upper triangle's differences are
    large and positive, and their ``exp`` would overflow (and its
    gradient turn NaN)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]              # (..., i, j)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -torch.inf)


def _ssd_intra(la: torch.Tensor, Cc: torch.Tensor, Bc: torch.Tensor,
               xdt: torch.Tensor) -> torch.Tensor:
    """Within each chunk, a masked product: y[q] = sum over k <= q of
    exp(segsum)[q, k] (C_q . B_k) xdt_k. la (B, nc, Q, H); Cc, Bc (B, nc,
    Q, N); xdt (B, nc, Q, H, hd) -> (B, nc, Q, H, hd), float32."""
    Lm = torch.exp(_segsum(la.movedim(-1, -2)))        # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)   # (B,nc,Q,Q)
    return torch.einsum("bchqk,bckhp->bcqhp", Lm * scores[:, :, None], xdt)


def _ssd_chunk_scan(la: torch.Tensor, Cc: torch.Tensor, Bc: torch.Tensor,
                    xdt: torch.Tensor) -> torch.Tensor:
    """Across chunks: each chunk's contribution to the (B, H, hd, N)
    state, a loop that carries the state and emits the state *entering*
    each chunk, and each position's output from that state, decayed to
    it. Shapes as :func:`_ssd_intra`'s."""
    Bb, nc, _, nheads = la.shape
    hd, N = xdt.shape[-1], Bc.shape[-1]
    la_cum = torch.cumsum(la, dim=2)                   # (B,nc,Q,H)
    la_tot = la_cum[:, :, -1, :]                       # (B,nc,H)
    decay_to_end = torch.exp(la_tot[:, :, None, :] - la_cum)  # (B,nc,Q,H)
    # state contribution of each chunk: (B,nc,H,hd,N)
    S_c = torch.einsum("bcqn,bcqhp->bchpn", Bc, xdt * decay_to_end[..., None])
    state = torch.zeros((Bb, nheads, hd, N), dtype=F32, device=la.device)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(la_tot[:, c])[:, :, None, None] + S_c[:, c]
    states_in = torch.stack(states_in, dim=1)          # (B,nc,H,hd,N)
    # inter-chunk output: C_t · decay(t) · state_in
    return (torch.einsum("bcqn,bchpn->bcqhp", Cc, states_in)
            * torch.exp(la_cum)[..., None])


def _out_proj(p: Mamba2, y: torch.Tensor, mesh) -> torch.Tensor:
    """y (..., d_inner) through ``out_proj``, or through this rank's rows
    of it (its slice of y) and summed over "model"."""
    d_loc = p.out_proj.shape[0]
    if d_loc == y.shape[-1]:
        return y @ p.out_proj.to(y.dtype)
    _, idx = L._tp(mesh)
    out = y[..., idx * d_loc:(idx + 1) * d_loc] @ p.out_proj.to(y.dtype)
    return L.tp_reduce(out, mesh)


def _enter(cfg: ModelConfig, p: Mamba2, x: torch.Tensor, mesh):
    return (x if p.out_proj.shape[0] == mamba2_dims(cfg)[0]
            else L.tp_enter(x, mesh))


def ssd_heads(d_inner: int, hd: int, tp: int, rank: int) -> Tuple[int, int]:
    """(first, count) of the SSM heads of head dim ``hd`` whose columns of
    the inner activations rank ``rank``'s ``d_inner / tp`` rows of
    ``out_proj`` read: heads ``floor(c0 / hd)`` to ``ceil((c0 + d_loc) /
    hd) - 1``, ``c0 = rank * d_loc``. A head whose columns two ranks share
    is run by both, each projecting its own columns."""
    d_loc = d_inner // tp
    c0 = rank * d_loc
    h0 = c0 // hd
    return h0, -(-(c0 + d_loc) // hd) - h0


def mamba2_apply(cfg: ModelConfig, p: Mamba2, x_in: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Full-sequence SSD. x_in: (B, S, D) -> (B, S, D) in x_in's type.
    ``S`` must be a multiple of the chunk ``min(cfg.ssm_chunk, S)``
    (decode goes through :func:`mamba2_decode_step`). ``p`` split over
    "model" (see the module's note) needs its DeviceMesh: the rank runs
    :func:`mamba2_body` between ``tp_enter`` and ``tp_reduce``, which
    sums the ranks' outputs."""
    if p.out_proj.shape[0] == mamba2_dims(cfg)[0]:
        return mamba2_body(cfg, p, x_in)
    tp, idx = L._tp(mesh)
    out = mamba2_body(cfg, p, L.tp_enter(x_in, mesh), rank=idx, tp=tp)
    return L.tp_reduce(out, mesh)


def mamba2_body(cfg: ModelConfig, p: Mamba2, x_in: torch.Tensor, *,
                rank: int = 0, tp: int = 1) -> torch.Tensor:
    """One rank's Mamba2 under tensor parallelism over ``tp`` ranks (the
    whole layer at ``tp`` 1): ``p.out_proj`` holds the rank's ``d_inner /
    tp`` rows, every other weight is whole. The SSD runs for the heads
    those rows read (:func:`ssd_heads`), on the columns of ``in_proj``
    and the conv channels they need, taken by index (the weights are not
    copied whole). Returns the rank's share of the output, which the
    ranks sum."""
    Bb, S, D = x_in.shape
    N = cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSD "
                         f"chunk {Q}")
    d_inner, nheads, _ = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x_in.dtype
    d_loc = d_inner // tp
    if tp == 1:
        h0, nh = 0, nheads
        w_in, conv_w, conv_b = p.in_proj, p.conv_w, p.conv_b
    else:
        h0, nh = ssd_heads(d_inner, hd, tp, rank)
        dev = p.in_proj.device
        ar = lambda a, n: torch.arange(a, a + n, device=dev)  # noqa: E731
        # conv channels [x | B | C]; in_proj columns [z | x | B | C | dt]
        ch = torch.cat([ar(h0 * hd, nh * hd), ar(d_inner, 2 * N)])
        cols = torch.cat([ar(rank * d_loc, d_loc), d_inner + ch,
                          ar(2 * d_inner + 2 * N + h0, nh)])
        w_in = p.in_proj.index_select(1, cols)
        conv_w = p.conv_w.index_select(1, ch)
        conv_b = p.conv_b.index_select(0, ch)
    heads = slice(h0, h0 + nh)

    proj = x_in @ w_in.to(dt_)
    z, xs, Bm, Cm, dt = torch.split(proj, [d_loc, nh * hd, N, N, nh],
                                    dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = _causal_conv(conv_in, conv_w.to(dt_), conv_b.to(dt_))
    xs, Bm, Cm = torch.split(conv_out, [nh * hd, N, N], dim=-1)

    dt = nn.functional.softplus(dt.to(F32) + p.dt_bias[heads])  # (B,S,H)
    A = -torch.exp(p.A_log[heads])                                # (H,)
    log_a = dt * A[None, None, :]                                 # (B,S,H)

    nc = S // Q
    xh = xs.reshape(Bb, nc, Q, nh, hd).to(F32)
    Bc = Bm.reshape(Bb, nc, Q, N).to(F32)
    Cc = Cm.reshape(Bb, nc, Q, N).to(F32)
    la = log_a.reshape(Bb, nc, Q, nh)
    dtc = dt.reshape(Bb, nc, Q, nh)
    xdt = xh * dtc[..., None]                                     # fold dt in

    y_intra = _ssd_intra(la, Cc, Bc, xdt)
    y_inter = _ssd_chunk_scan(la, Cc, Bc, xdt)

    y = (y_intra + y_inter).reshape(Bb, S, nh, hd)
    y = y + xh.reshape(Bb, S, nh, hd) * p.D_skip[heads][None, None, :, None]
    y = y.reshape(Bb, S, nh * hd).to(dt_)
    y0 = rank * d_loc - h0 * hd                # the rank's rows' columns
    y = y[..., y0:y0 + d_loc] * silu(z)
    return y @ p.out_proj.to(dt_)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def mamba2_cache_init(cfg: ModelConfig, batch: int, device=None):
    """(cache, axes) of one layer: the SSM state (B, H, hd, N) in float32
    and the conv tail (B, W - 1, C) in the compute type, zeros. O(1) in
    the sequence's length."""
    _, nheads, conv_ch = mamba2_dims(cfg)
    cache = {
        "state": torch.zeros((batch, nheads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=L.dtype_of(cfg.compute_dtype),
                            device=device),
    }
    axes = {"state": ("batch", "ssm_heads", "head_dim", "state"),
            "conv": ("batch", "conv_width", "ssm_conv")}
    return cache, axes


def mamba2_decode_step(cfg: ModelConfig, p: Mamba2, x_tok: torch.Tensor,
                       cache: Dict[str, torch.Tensor], mesh=None):
    """One token. x_tok: (B, 1, D) -> ((B, 1, D), new cache). The new
    cache is returned, not written into ``cache``. A state that holds
    only this rank's heads (a cache split by heads over "model", with
    ``p.out_proj`` split by its rows) is stepped for those heads, whose
    columns of the inner activations are the rank's slice of
    ``out_proj``'s rows."""
    Bb = x_tok.shape[0]
    N = cfg.ssm_state
    d_inner, nheads, _ = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x_tok.dtype
    x_tok = _enter(cfg, p, x_tok, mesh)
    h_loc = cache["state"].shape[1]
    if h_loc != nheads and h_loc * hd != p.out_proj.shape[0]:
        raise ValueError(f"a state of {h_loc} of {nheads} heads needs "
                         f"out_proj split into {h_loc * hd} rows")
    h0 = L._tp(mesh)[1] * h_loc if h_loc != nheads else 0
    heads = slice(h0, h0 + h_loc)

    proj = x_tok[:, 0, :] @ p.in_proj.to(dt_)
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, C)
    window = torch.cat([cache["conv"],
                        conv_in[:, None, :].to(cache["conv"].dtype)],
                       dim=1)                                   # (B, W, C)
    conv_out = silu(torch.einsum("bwc,wc->bc", window.to(dt_),
                                 p.conv_w.to(dt_)) + p.conv_b.to(dt_))
    xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dt_h = nn.functional.softplus(dt.to(F32)[:, heads]
                                  + p.dt_bias[heads])          # (B,H)
    A = -torch.exp(p.A_log[heads])
    da = torch.exp(dt_h * A[None, :])                          # (B,H)
    xh = xs.reshape(Bb, nheads, hd)[:, heads].to(F32)
    state = (cache["state"] * da[:, :, None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xh, Bm.to(F32), dt_h))
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(F32))
    y = y + xh * p.D_skip[heads][None, :, None]
    cols = slice(h0 * hd, (h0 + h_loc) * hd)
    y = y.reshape(Bb, h_loc * hd).to(dt_) * silu(z[:, cols])
    out = (_out_proj(p, y, mesh) if h_loc == nheads else
           L.tp_reduce(y @ p.out_proj.to(dt_), mesh))[:, None, :]
    return out, {"state": state, "conv": window[:, 1:, :]}

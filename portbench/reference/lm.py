"""Plain float32 reference of the benchmark's Mamba2 language model.

Written from the published equations, in plain PyTorch, and independent
of the program under test: nothing here imports it, and the weights are
the benchmark's own (``portbench.weights``), keyed by the names the
program's modules give its parameters.

* Mamba2 (arXiv:2405.21060): ``in_proj`` emits [z | x | B | C | dt]; a
  depthwise causal convolution of width W with a bias, then SiLU, over
  [x | B | C]; ``dt = softplus(dt + dt_bias)``; ``A = -exp(A_log)`` per
  head; the SSD ``y_t = sum_{s <= t} C_t . B_s exp(sum_{s < u <= t} dt_u
  A) dt_s x_s + D x_t``, computed by the paper's chunked algorithm
  (``ssd_minimal_discrete``: a masked product inside each chunk, chunk
  states, and the recurrence across chunks as one segment-sum matrix,
  not a loop); one B/C group; the output ``y * silu(z)`` through
  ``out_proj``. Departure from the published block, as the program
  defines its model: no gated RMSNorm before ``out_proj``.
* The ssm LM: embedding, pre-norm residual Mamba2 blocks, a final
  RMSNorm and the head (tied to the embedding where the configuration
  says so), masked next-token cross entropy.

Every product goes through :func:`mm` / :func:`einsum`, in float32 with
TF32 off (the caller sets ``torch.backends.*.allow_tf32 = False``;
:func:`no_tf32` does). ``Precision("fp8")`` rounds each product's two
operands to float8 e4m3 (per-tensor scale, straight-through gradient):
the control that correctness has to reject.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0


class Precision:
    """How :func:`mm` rounds its operands: ``"f32"`` not at all, ``"fp8"``
    to float8 e4m3 with a per-tensor scale."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        r = (x.detach() * scale).to(torch.float8_e4m3fn).to(F32) / scale
        return x + (r - x).detach()


F32_ONLY = Precision("f32")


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32 for the enclosed code."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.q(a) @ prec.q(b)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    return torch.einsum(spec, prec.q(a), prec.q(b))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * gamma


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < u <= i} x[..., u] for j <= i, -inf above
    the diagonal (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)                   # (..., i, j)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0.0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, -torch.inf)


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        Q: int, prec: Precision) -> torch.Tensor:
    """The chunked SSD of ``ssd_minimal_discrete``. X (b, l, h, p) = x dt;
    A (b, l, h) = dt A; B, C (b, l, n), one group. -> Y (b, l, h, p)."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    c = l // Q
    X = X.reshape(b, c, Q, h, p)
    B = B.reshape(b, c, Q, n)
    C = C.reshape(b, c, Q, n)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)          # (b, h, c, Q)
    A_cum = torch.cumsum(A, dim=-1)
    # 1. inside each chunk
    Lm = torch.exp(segsum(A))                              # (b, h, c, Q, Q)
    CB = einsum("bcln,bcsn->bcls", C, B, prec)             # (b, c, Q, Q)
    W = Lm * CB[:, None]                                   # (b, h, c, Q, Q)
    Y_diag = einsum("bhcls,bcshp->bclhp", W, X, prec)
    # 2. each chunk's state
    decay = torch.exp(A_cum[..., -1:] - A_cum)             # (b, h, c, Q)
    Xd = X * decay.permute(0, 2, 3, 1)[..., None]
    states = einsum("bcln,bclhp->bchpn", B, Xd, prec)      # (b, c, h, p, n)
    # 3. across chunks, as one segment-sum matrix
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    new = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states = new[:, :-1]                                   # entering each
    # 4. states to outputs
    Y_off = einsum("bcln,bchpn->bclhp", C, states, prec) \
        * torch.exp(A_cum).permute(0, 2, 3, 1)[..., None]
    return (Y_diag + Y_off).reshape(b, l, h, p)


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """u (b, l, ch), w (W, ch): out_t = sum_i w[i] u_{t - W + 1 + i}."""
    Wd = w.shape[0]
    out = F.conv1d(F.pad(u.transpose(1, 2), (Wd - 1, 0)),
                   w.t()[:, None, :], bias, groups=u.shape[-1])
    return F.silu(out.transpose(1, 2))


def mamba2(cfg: Dict, p: Dict[str, torch.Tensor], prefix: str,
           x: torch.Tensor, prec: Precision) -> torch.Tensor:
    b, l, _ = x.shape
    N, hd = cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * cfg["d_model"]
    H = di // hd
    proj = mm(x, p[prefix + "in_proj"], prec)
    z, xs, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv = causal_conv(torch.cat([xs, Bm, Cm], dim=-1), p[prefix + "conv_w"],
                       p[prefix + "conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    dt = F.softplus(dt + p[prefix + "dt_bias"])
    A = -torch.exp(p[prefix + "A_log"])
    xh = xs.reshape(b, l, H, hd)
    y = ssd(xh * dt[..., None], dt * A, Bm, Cm, min(cfg["ssm_chunk"], l),
            prec)
    y = y + xh * p[prefix + "D_skip"][:, None]
    return mm(y.reshape(b, l, di) * F.silu(z), p[prefix + "out_proj"], prec)


# ---------------------------------------------------------------------------
# the language models
# ---------------------------------------------------------------------------

def hidden(cfg: Dict, p: Dict, tokens: torch.Tensor,
           prec: Precision = F32_ONLY) -> torch.Tensor:
    """The final normed hidden states (b, l, D) of ``tokens`` (b, l)."""
    eps = cfg["norm_eps"]
    h = p["embed"][tokens]
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}."
        h = h + mamba2(cfg, p, pre + "mamba.",
                       rmsnorm(h, p[pre + "norm.gamma"], eps), prec)
    return rmsnorm(h, p["norm_f.gamma"], eps)


def head(cfg: Dict, p: Dict, h: torch.Tensor,
         prec: Precision = F32_ONLY) -> torch.Tensor:
    """Logits over the vocabulary (the padded table's first ``vocab_size``
    columns)."""
    w = p["embed"].t() if cfg.get("tie_embeddings") else p["head"]
    return mm(h, w[:, :cfg["vocab_size"]], prec)


def loss_and_grads(cfg: Dict, p: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, labels: torch.Tensor,
                   rows: int = 1, prec: Precision = F32_ONLY):
    """(mean next-token cross entropy, {name: gradient}) over all rows of
    the batch, taken ``rows`` rows at a time so that it fits: each block's
    summed loss is divided by the whole batch's token count before its
    backward, so the gradients add up to the whole batch's."""
    names = list(p)
    leaves = [p[n].detach().requires_grad_(True) for n in names]
    q = dict(zip(names, leaves))
    count = labels.numel()
    total = 0.0
    grads = [torch.zeros_like(t) for t in leaves]
    for r0 in range(0, tokens.shape[0], rows):
        tok, lab = tokens[r0:r0 + rows], labels[r0:r0 + rows]
        logits = head(cfg, q, hidden(cfg, q, tok, prec), prec)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              lab.reshape(-1).long(), reduction="sum")
        gs = torch.autograd.grad(nll / count, leaves, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        total += float(nll.detach())
        del logits, nll, gs
    return total / count, dict(zip(names, grads))


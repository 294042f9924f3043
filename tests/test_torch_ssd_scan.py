"""The SSD's state passing across chunks (``repro_torch.kernels.ssd_scan``)
on the CPU.

On the card ``state_pass`` launches one hand-written kernel each way
behind an autograd function; any other tensor takes the plain loop
beside it. Here:

* the route: a CPU tensor (and the dry run's ``meta``) takes the loop,
  counted as ``ssd.state_pass.loop``, and launches nothing;
* the loop is the model's arithmetic as it was before the kernel: the
  chunked SSD's inter-chunk term equals, bit for bit, a copy of the
  pre-kernel ``_ssd_chunk_scan`` kept here, forward and gradients;
* the wrapper's checks: float32 only, matching shapes, one device;
* the autograd function the card runs, with its two launches replaced by
  Python versions of the kernels' arithmetic (``csrc/ssd_state_pass.cu``:
  products then sums, each rounded, and the decays' gradient as per-warp
  partials added in a second step), against autograd through the loop:
  states and the contributions' gradient bit for bit, the decays'
  gradient within 1e-5 of the sum of its terms' magnitudes (the
  summation order only), and unchanged under ``remat="dots"``'s
  selective checkpoint, whose recompute relaunches the forward.

The kernels themselves run only on a card: ``chip_smoke.py --phases
card,build,kernels`` holds them to the loop there.
"""

import functools

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as ckpt

from repro_torch import tracing
from repro_torch.kernels.ssd_scan import kernel as ss_kernel
from repro_torch.kernels.ssd_scan import ops as ss_ops
from repro_torch.models import lm as lm_mod
from repro_torch.models import mamba2
from repro_torch.models import get_config

F32 = torch.float32

# (B, nc, Q, H, hd, N): a few chunks; one chunk; odd widths (hd * N = 21,
# not a multiple of the kernels' vector width)
SHAPES = [(2, 4, 8, 3, 4, 5), (1, 1, 16, 2, 8, 4), (2, 3, 4, 5, 3, 7)]


def _chunk_scan_before_kernel(la, Cc, Bc, xdt):
    """``models/mamba2.py::_ssd_chunk_scan`` as it was before the state
    passing moved into ``kernels/ssd_scan``."""
    Bb, nc, _, nheads = la.shape
    hd, N = xdt.shape[-1], Bc.shape[-1]
    la_cum = torch.cumsum(la, dim=2)
    la_tot = la_cum[:, :, -1, :]
    decay_to_end = torch.exp(la_tot[:, :, None, :] - la_cum)
    S_c = torch.einsum("bcqn,bcqhp->bchpn", Bc, xdt * decay_to_end[..., None])
    state = torch.zeros((Bb, nheads, hd, N), dtype=F32, device=la.device)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(la_tot[:, c])[:, :, None, None] + S_c[:, c]
    states_in = torch.stack(states_in, dim=1)
    return (torch.einsum("bcqn,bchpn->bcqhp", Cc, states_in)
            * torch.exp(la_cum)[..., None])


def _ssd_inputs(shape, seed):
    B, nc, Q, H, hd, N = shape
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    la = -torch.from_numpy(rng.uniform(0.01, 0.3, size=(B, nc, Q, H))
                           .astype(np.float32))
    return [la, t(B, nc, Q, N), t(B, nc, Q, N), t(B, nc, Q, H, hd)]


def _scan_inputs(B, nc, H, hd, N, seed):
    """Summed log decays (B, nc, H) and contributions (B, nc, H, hd, N)."""
    rng = np.random.default_rng(seed)
    la_tot = -torch.from_numpy(rng.uniform(0.05, 3.0, size=(B, nc, H))
                               .astype(np.float32))
    S_c = torch.from_numpy(rng.normal(size=(B, nc, H, hd, N))
                           .astype(np.float32))
    return la_tot, S_c


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_the_loop_before_the_kernel(shape):
    """The model's inter-chunk term on the CPU, output and the gradients
    of all four inputs, equal to the pre-kernel function bit for bit."""
    ins = _ssd_inputs(shape, seed=sum(shape))
    outs, grads = [], []
    for fn in (_chunk_scan_before_kernel, mamba2._ssd_chunk_scan):
        xs = [x.clone().requires_grad_(True) for x in ins]
        y = fn(*xs)
        gy = torch.from_numpy(np.random.default_rng(7).normal(
            size=tuple(y.shape)).astype(np.float32))
        outs.append(y.detach())
        # with one chunk the contributions feed nothing: Bc has no gradient
        grads.append(torch.autograd.grad(y, xs, gy, allow_unused=True))
    assert torch.equal(outs[0], outs[1])
    for want, got in zip(*grads):
        assert (want is None and got is None) or torch.equal(want, got)


def test_cpu_takes_the_loop_and_counts_it():
    la_tot, S_c = _scan_inputs(2, 3, 4, 2, 3, seed=1)
    before = ss_kernel.launches
    with tracing.collect() as c:
        out = ss_ops.state_pass(la_tot, S_c)
    assert c.counters == {"ssd.state_pass.loop": 1}
    assert c.spans == []
    assert ss_kernel.launches == before == 0
    assert torch.equal(out, ss_kernel.state_pass_plain(la_tot, S_c))


def test_meta_takes_the_loop():
    """The dry run traces the program on ``meta``: the loop's shapes."""
    la_tot, S_c = (t.to("meta") for t in _scan_inputs(2, 5, 3, 2, 4, 2))
    with tracing.collect() as c:
        out = ss_ops.state_pass(la_tot, S_c)
    assert out.shape == S_c.shape and out.device.type == "meta"
    assert c.counters == {"ssd.state_pass.loop": 1}


def test_a_layer_under_remat_dots_runs_the_scan_twice():
    """A Mamba2 layer's forward and backward under ``remat="dots"``: the
    scan runs in the forward and again in the recompute, and the
    gradients equal those of the layer kept whole."""
    cfg = get_config("mamba2-130m").reduced()
    mod = mamba2.Mamba2(cfg, device="cpu")
    mod.init_(torch.Generator().manual_seed(3))
    mod.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32)).to(
            mamba2.L.dtype_of(cfg.param_dtype))
    body = functools.partial(mamba2.mamba2_apply, cfg, mod)
    grads = {}
    for remat in ("none", "dots"):
        mod.zero_grad(set_to_none=True)
        with tracing.collect() as c:
            lm_mod.remat_apply(body, x, remat).float().square().sum().backward()
        assert c.counters == {"ssd.state_pass.loop":
                              1 if remat == "none" else 2}
        grads[remat] = {n: p.grad.clone() for n, p in mod.named_parameters()}
    for n, g in grads["none"].items():
        assert torch.equal(grads["dots"][n], g), n


@pytest.mark.parametrize("la_dtype,s_dtype", [
    (F32, torch.float64), (torch.bfloat16, F32), (F32, torch.float16)])
def test_rejects_other_types(la_dtype, s_dtype):
    la_tot, S_c = _scan_inputs(1, 2, 2, 2, 2, seed=3)
    with pytest.raises(TypeError, match="float32"):
        ss_ops.state_pass(la_tot.to(la_dtype), S_c.to(s_dtype))


@pytest.mark.parametrize("la_shape,s_shape", [
    ((1, 3, 2), (1, 2, 2, 4, 4)),      # chunks differ
    ((1, 2, 3), (1, 2, 2, 4, 4)),      # heads differ
    ((2, 2, 2), (1, 2, 2, 4, 4)),      # batch differs
    ((1, 2, 2), (1, 2, 2, 16)),        # S_c without (hd, N)
    ((1, 2), (1, 2, 2, 4, 4))])        # la_tot without heads
def test_rejects_mismatched_shapes(la_shape, s_shape):
    with pytest.raises(ValueError, match="state_pass"):
        ss_ops.state_pass(torch.zeros(la_shape), torch.zeros(s_shape))


def test_rejects_two_devices():
    la_tot, S_c = _scan_inputs(1, 2, 2, 2, 2, seed=4)
    with pytest.raises(ValueError, match="meta"):
        ss_ops.state_pass(la_tot, S_c.to("meta"))


# -- the autograd function the card runs, its launches in Python --------------

def _fwd_like_kernel(a, s):
    """``state_pass_fwd_kernel``'s arithmetic: a product, then a sum."""
    B, nc, H, L = s.shape
    out = torch.empty((B, nc, H, L), dtype=F32)
    st = torch.zeros((B, H, L), dtype=F32)
    for c in range(nc):
        out[:, c] = st
        st = st * a[:, c, :, None] + s[:, c]
    return out


def _bwd_like_kernel(a, states, g):
    """``state_pass_bwd_kernel``'s arithmetic: the reverse scan, ``ds`` the
    carried gradient, ``da`` as one partial a warp of 32 lanes of ``vec``
    elements."""
    B, nc, H, L = states.shape
    vec = ss_kernel._vec(L, g)
    warps = -(-L // (32 * vec))
    ds = torch.zeros_like(states)
    dap = torch.zeros((B, nc, H, warps), dtype=F32)
    hv = g[:, nc - 1].clone()
    for c in range(nc - 2, -1, -1):
        ds[:, c] = hv
        prod = torch.nn.functional.pad(hv * states[:, c],
                                       (0, warps * 32 * vec - L))
        dap[:, c] = prod.view(B, H, warps, 32 * vec).sum(-1)
        hv = g[:, c] + hv * a[:, c, :, None]
    return ds, dap


def _loop_with_decays(a, S_c):
    """The plain loop on the decays themselves (the card's route takes
    ``exp`` of the log decays once, for all chunks)."""
    state = torch.zeros_like(S_c[:, 0])
    states_in = []
    for c in range(S_c.shape[1]):
        states_in.append(state)
        state = state * a[:, c][:, :, None, None] + S_c[:, c]
    return torch.stack(states_in, dim=1)


@pytest.mark.parametrize("B,nc,H,hd,N", [
    (2, 5, 3, 8, 16),     # rows of 128: whole warps of 4-wide vectors
    (1, 1, 2, 4, 8),      # one chunk: only zeros flow back
    (2, 4, 2, 3, 7),      # rows of 21: one-wide, a partial warp
    (1, 6, 5, 16, 12)])   # rows of 192: a partial warp of 4-wide vectors
def test_kernel_function_matches_loop_autograd(monkeypatch, B, nc, H, hd, N):
    monkeypatch.setattr(ss_ops, "state_pass_fwd_cuda", _fwd_like_kernel)
    monkeypatch.setattr(ss_ops, "state_pass_bwd_cuda", _bwd_like_kernel)
    la_tot, S_c = _scan_inputs(B, nc, H, hd, N, seed=B * nc + H + hd * N)
    a0 = torch.exp(la_tot)
    gy = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(S_c.shape)).astype(np.float32))
    res = {}
    for name, fn in (("loop", _loop_with_decays),
                     ("kernel", ss_ops._StatePass.apply)):
        a, s = a0.clone().requires_grad_(True), S_c.clone().requires_grad_()
        with tracing.collect() as c:
            out = fn(a, s)
            # one chunk: the loop's output (zeros) depends on neither input
            da, dS = (torch.autograd.grad(out, (a, s), gy)
                      if out.requires_grad else
                      (torch.zeros_like(a), torch.zeros_like(s)))
        res[name] = (out.detach(), da, dS, c.counters)
    assert res["kernel"][3] == {"ssd.state_pass.kernel": 2}
    assert torch.equal(res["kernel"][0], res["loop"][0])
    assert torch.equal(res["kernel"][2], res["loop"][2])
    assert torch.equal(res["kernel"][2][:, -1], torch.zeros_like(S_c[:, -1]))
    # da[c] = sum over (hd, N) of H_{c+1} * state_c, and H_{c+1} = dS[c]:
    # its terms' magnitudes
    scale = (res["loop"][2] * res["loop"][0]).abs().sum(dim=(-1, -2))
    bad = (res["kernel"][1] - res["loop"][1]).abs() > 1e-5 * scale + 1e-30
    assert not bool(bad.any())


def test_kernel_function_under_selective_checkpoint(monkeypatch):
    """Under ``remat="dots"``'s policy the recompute relaunches the
    forward: the gradients equal those without a checkpoint."""
    launched = []
    monkeypatch.setattr(ss_ops, "state_pass_fwd_cuda",
                        lambda *a: launched.append("fwd")
                        or _fwd_like_kernel(*a))
    monkeypatch.setattr(ss_ops, "state_pass_bwd_cuda",
                        lambda *a: launched.append("bwd")
                        or _bwd_like_kernel(*a))
    la_tot, S_c = _scan_inputs(2, 4, 3, 4, 8, seed=11)
    w = torch.from_numpy(np.random.default_rng(12).normal(
        size=(8, 8)).astype(np.float32))

    def body(s):
        # a projection (saved by the policy), the scan, a product after it
        s = (s.reshape(-1, 8) @ w).reshape(s.shape)
        return ss_ops._StatePass.apply(torch.exp(la_tot), s) * 1.5

    grads = []
    for remat in ("none", "dots"):
        launched.clear()
        s = S_c.clone().requires_grad_(True)
        if remat == "none":
            out = body(s)
        else:
            out = ckpt.checkpoint(
                body, s, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    lm_mod._save_projections))
        out.square().sum().backward()
        grads.append(s.grad)
        assert launched == (["fwd", "bwd"] if remat == "none"
                            else ["fwd", "fwd", "bwd"])
    assert torch.equal(grads[0], grads[1])


def test_row_view_is_a_view_where_the_rows_are_contiguous():
    la_tot, S_c = _scan_inputs(2, 6, 3, 4, 8, seed=5)
    v = ss_kernel.row_view(S_c)
    assert v.shape == (2, 6, 3, 32) and v.data_ptr() == S_c.data_ptr()
    every_other = S_c[:, ::2]          # chunk stride doubled, rows intact
    v = ss_kernel.row_view(every_other)
    assert v.data_ptr() == every_other.data_ptr()
    assert torch.equal(v, every_other.reshape(2, 3, 3, 32))
    swapped = S_c.transpose(3, 4).contiguous().transpose(3, 4)
    v = ss_kernel.row_view(swapped)    # (hd, N) not row-major: one copy
    assert v.data_ptr() != swapped.data_ptr() and v.is_contiguous()
    assert torch.equal(v, S_c.reshape(2, 6, 3, 32))


def test_vector_width_follows_rows_and_alignment():
    x = torch.zeros((2, 3, 4, 32))
    assert ss_kernel._vec(32, x) == 4
    assert ss_kernel._vec(21, torch.zeros((2, 3, 4, 21))) == 1
    assert ss_kernel._vec(32, torch.zeros((2, 3, 4, 33))[..., 1:]) == 1

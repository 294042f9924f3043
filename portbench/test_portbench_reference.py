"""The plain reference against the program on the CPU, at the program's
reduced mamba2-130m in float32, on the benchmark's own weights."""

import dataclasses
import math

import pytest
import torch

from portbench import flops, weights
from portbench.reference import lm as R
from portbench.traffic import TrainFeed
from repro_torch import use_device
from repro_torch.models.registry import build_model, get_config, model_class


def _reduced(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    keys = ["family", "n_layers", "d_model", "ssm_state", "ssm_expand",
            "ssm_head_dim", "ssm_conv_width", "ssm_chunk", "vocab_size",
            "tie_embeddings", "norm_eps"]
    m = {k: getattr(cfg, k) for k in keys}
    m.update(padded_vocab=cfg.padded_vocab)
    return cfg, m


def _program(cfg, w):
    lm = model_class(cfg)(cfg, device="cpu")
    weights.load_into(lm, w)
    return build_model(cfg), lm


def test_logits_match_the_program():
    cfg, m = _reduced("mamba2-130m")
    with use_device("cpu"):
        w = weights.make(m, 11, "cpu")
        api, lm = _program(cfg, w)
        tok = torch.randint(0, m["vocab_size"], (2, 48),
                            generator=torch.Generator().manual_seed(3))
        got = api.forward(lm, {"tokens": tok})[:, -1]
    with torch.no_grad():
        want = R.head(m, w, R.hidden(m, w, tok)[:, -1])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
        float((got - want).abs().max())


def test_loss_and_gradients_match_the_program():
    cfg, m = _reduced("mamba2-130m")
    feed = TrainFeed({"batch": 2, "seq": 32, "tokens": {
        "exponent": 1.0, "copy_share": 0.5}}, m["vocab_size"], 5)
    b = {k: torch.from_numpy(v) for k, v in feed.batch_at(0).items()}
    with use_device("cpu"):
        w = weights.make(m, 5, "cpu")
        api, lm = _program(cfg, w)
        for p in lm.parameters():
            p.requires_grad_(True)
        loss = api.loss_fn(lm, {"tokens": b["tokens"].long(),
                                "labels": b["labels"].long()})
        loss.backward()
    ref_loss, ref_g = R.loss_and_grads(m, w, b["tokens"].long(),
                                       b["labels"], rows=1)
    assert math.isclose(float(loss.detach()), ref_loss, rel_tol=1e-5)
    for n, p in lm.named_parameters():
        scale = float(ref_g[n].abs().max()) or 1.0
        assert float((p.grad - ref_g[n]).abs().max()) <= 1e-4 * scale, n


def test_chunked_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 24, 3, 4, 5
    X = torch.randn(b, l, h, p, generator=g, dtype=torch.float64)
    A = -torch.rand(b, l, h, generator=g, dtype=torch.float64)
    B = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(l):
        state = state * torch.exp(A[:, t])[:, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", X[:, t], B[:, t])
        want.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    want = torch.stack(want, 1)
    for Q in (4, 8, 24):
        got = R.ssd(X, A, B, C, Q, R.F32_ONLY)
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-10), Q


def test_fp8_control_rounds_coarser_than_bf16():
    g = torch.Generator().manual_seed(1)
    a = torch.randn(64, 256, generator=g)
    b = torch.randn(256, 64, generator=g)
    exact = a.double() @ b.double()
    bf16 = (a.bfloat16().float() @ b.bfloat16().float()).double()
    fp8 = R.mm(a, b, R.Precision("fp8")).double()
    assert (fp8 - exact).abs().max() > 8 * (bf16 - exact).abs().max()


def test_flops_match_the_counted_products():
    from torch.utils.flop_counter import FlopCounterMode
    cfg, m = _reduced("mamba2-130m")
    with use_device("cpu"):
        api, lm = _program(cfg, weights.make(m, 2, "cpu"))
        tok = torch.randint(0, m["vocab_size"], (2, 32))
        with FlopCounterMode(display=False) as fc:
            api.forward(lm, {"tokens": tok})
        assert fc.get_total_flops() == flops.forward(m, 2, 32)
        for p in lm.parameters():
            p.requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            api.loss_fn(lm, {"tokens": tok, "labels": tok}).backward()
        assert fc.get_total_flops() == flops.train_step(m, 2, 32)

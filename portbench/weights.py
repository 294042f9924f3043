"""The benchmark's seeded weights, made on the device.

Both sides get these: the program loads them into its modules
(:func:`load_into`), and the reference reads them as a dict keyed by the
program's parameter names. Every normally drawn leaf is a slice of one
``torch.randn`` call on the device's own generator, scaled in place, so
that set-up is a few large calls. Scales follow the published
initialisations: the embedding N(0, 0.02^2), projections N(0, 2 / (in +
out)), conv taps N(0, 0.1^2), conv bias 0, ``A = -linspace(1, 16)`` per
head (``A_log`` its log), dt bias 0.5, D skip 1, norm gains 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

F32 = torch.float32


def _mamba_specs(m: Dict, pre: str) -> List[Tuple]:
    D, N, hd, W = m["d_model"], m["ssm_state"], m["ssm_head_dim"], \
        m["ssm_conv_width"]
    di = m["ssm_expand"] * D
    H = di // hd
    ch = di + 2 * N
    P = 2 * di + 2 * N + H
    return [(pre + "mamba.in_proj", (D, P), "dense"),
            (pre + "mamba.conv_w", (W, ch), ("normal", 0.1)),
            (pre + "mamba.conv_b", (ch,), ("fill", 0.0)),
            (pre + "mamba.A_log", (H,), "a_log"),
            (pre + "mamba.dt_bias", (H,), ("fill", 0.5)),
            (pre + "mamba.D_skip", (H,), ("fill", 1.0)),
            (pre + "mamba.out_proj", (di, D), "dense"),
            (pre + "norm.gamma", (D,), ("fill", 1.0))]


def specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(parameter name, shape, init) of every leaf of the model ``m`` (a
    configuration file's ``model`` section), in drawing order."""
    D, V = m["d_model"], m["padded_vocab"]
    out = [("embed", (V, D), ("normal", 0.02))]
    for i in range(m["n_layers"]):
        out += _mamba_specs(m, f"layers.{i}.")
    out.append(("norm_f.gamma", (D,), ("fill", 1.0)))
    if not m.get("tie_embeddings"):
        out.append(("head", (D, V), "dense"))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on ``device``}, a pure function of
    ``seed`` (any whole number below 2**63)."""
    sp = specs(m)
    drawn = sum(_numel(s) for _, s, init in sp
                if init == "dense" or init[0] == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(drawn, generator=g, dtype=F32, device=device)
    out, at = {}, 0
    for name, shape, init in sp:
        n = _numel(shape)
        if init == "dense" or init[0] == "normal":
            std = ((2.0 / (shape[-2] + shape[-1])) ** 0.5
                   if init == "dense" else init[1])
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif init == "a_log":
            out[name] = torch.log(torch.linspace(1.0, 16.0, n, dtype=F32,
                                                 device=device))
        else:
            out[name] = torch.full(shape, init[1], dtype=F32, device=device)
    return out


def load_into(module: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Copy ``w`` into ``module``'s parameters of the same names; every
    parameter must be given, at its shape."""
    names = dict(module.named_parameters())
    if set(names) != set(w):
        raise ValueError(f"weights {sorted(set(w) ^ set(names))} do not "
                         f"match the model's parameters")
    with torch.no_grad():
        for n, p in names.items():
            if tuple(p.shape) != tuple(w[n].shape):
                raise ValueError(f"{n}: model {tuple(p.shape)}, weights "
                                 f"{tuple(w[n].shape)}")
            p.copy_(w[n])

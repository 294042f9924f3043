"""Plain float32 training reference: AdamW (decoupled weight decay,
Loshchilov & Hutter) with the cell's schedule (linear warm-up, then a
cosine decay to a tenth), over the reference LM's loss and gradients.

It follows the program's first steps from the benchmark's own weights
and batches and returns what correctness compares: each step's loss,
each leaf's first gradient and each leaf's change over the steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import lm as R


def lr_at(h: Dict, step: int) -> float:
    """The learning rate of step ``step`` (1 for the first)."""
    warm = min(step / max(h["warmup_steps"], 1), 1.0)
    prog = min(max((step - h["warmup_steps"])
                   / max(h["total_steps"] - h["warmup_steps"], 1), 0.0), 1.0)
    return h["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def steps(m: Dict, p0: Dict[str, torch.Tensor], batches: List[Dict],
          h: Dict, rows: int, prec: R.Precision = R.F32_ONLY) -> Dict:
    """AdamW from ``p0`` over ``batches`` ({"tokens", "labels"} tensors):
    {"losses": [...], "grad1": {name: first gradient}, "change": {name:
    p_n - p_0}}. ``p0`` is left as it was."""
    p = {n: t.detach().clone() for n, t in p0.items()}
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    var = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2 = h["beta1"], h["beta2"]
    losses, grad1 = [], None
    with R.no_tf32():
        for t, batch in enumerate(batches, start=1):
            loss, g = R.loss_and_grads(m, p, batch["tokens"], batch["labels"],
                                       rows=rows, prec=prec)
            losses.append(loss)
            if grad1 is None:
                grad1 = g
            lr = lr_at(h, t)
            with torch.no_grad():
                for n, gn in g.items():
                    mom[n].mul_(b1).add_((1 - b1) * gn)
                    var[n].mul_(b2).add_((1 - b2) * gn * gn)
                    mh = mom[n] / (1 - b1 ** t)
                    vh = var[n] / (1 - b2 ** t)
                    p[n].add_(-(lr * (mh / (torch.sqrt(vh) + h["eps"])
                                      + h["weight_decay"] * p[n])))
            del g
    change = {n: p[n] - p0[n] for n in p}
    return {"losses": losses, "grad1": grad1, "change": change}

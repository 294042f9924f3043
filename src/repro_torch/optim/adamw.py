"""Optimizers: AdamW (float32 state) and Adafactor (factored second
moment), the JAX package's ``optim/adamw.py`` over dicts of tensors.

Both expose the reference's interface:

  init(params)                       -> opt_state
  update(grads, opt_state, params)   -> (updates, new_opt_state)

``params`` and ``grads`` map names to tensors; updates are *applied
steps* (add them to the parameters), so the ADCC ledger can checksum
them incrementally (``core/acc_state.py``).

The arithmetic is the reference's, expression by expression, in float32:
the schedule and the bias corrections are float32 tensors computed from
the integer step (``b1 ** step.astype(f32)``, ``cos`` in float32), never
Python floats, which would change ``lr`` in its last bit and with it
every update. AdamW updates its moments in place (the reference returns
new ones; the values are the same and one copy of ``m`` and ``v`` less
is live). Adafactor is elementwise on its statistics but factors over
the last two dimensions and clips by the RMS of a whole tensor, so it
must see a stacked ``(L, D, F)`` leaf as one tensor, as the reference
does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import TrainConfig

__all__ = ["AdamWState", "AdafactorState", "make_optimizer", "adamw_init",
           "adamw_update", "adafactor_init", "adafactor_update",
           "lr_schedule"]

Tensors = Dict[str, torch.Tensor]
F32 = torch.float32


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay, a float32 0-d tensor on ``step``'s
    device (``step``: an integer tensor)."""
    s = step.to(F32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _zero_step(like: Tensors) -> torch.Tensor:
    dev = next(iter(like.values())).device if like else None
    return torch.zeros((), dtype=torch.int32, device=dev)


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    m: Tensors
    v: Tensors


def adamw_init(params: Tensors) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(step=_zero_step(params),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def adamw_update(cfg: TrainConfig, grads: Tensors, state: AdamWState,
                 params: Tensors) -> Tuple[Tensors, AdamWState]:
    """One AdamW step. Writes the new moments into ``state.m`` / ``state.v``
    and returns them in the new state."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.tensor(b1, dtype=F32, device=step.device) ** step.to(F32)
    bc2 = 1 - torch.tensor(b2, dtype=F32, device=step.device) ** step.to(F32)
    updates = {}
    for k, g in grads.items():
        g32, m, v, p = g.to(F32), state.m[k], state.v[k], params[k]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        m_hat = m / bc1
        v_hat = v / bc2
        delta = -(lr * (m_hat / (torch.sqrt(v_hat) + cfg.eps)
                        + cfg.weight_decay * p.to(F32)))
        updates[k] = delta.to(p.dtype)
    return updates, AdamWState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; Shazeer & Stern 2018, simplified)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    stats: Dict[str, Tensors]  # per leaf: row/col for >= 2-D, v for < 2-D


def adafactor_init(params: Tensors) -> AdafactorState:
    def init_one(p):
        z = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
        if p.ndim >= 2:
            return {"row": z(p.shape[:-1]),
                    "col": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return AdafactorState(step=_zero_step(params),
                          stats={k: init_one(p) for k, p in params.items()})


def adafactor_update(cfg: TrainConfig, grads: Tensors,
                     state: AdafactorState, params: Tensors
                     ) -> Tuple[Tensors, AdafactorState]:
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step.to(F32) + 1.0) ** -0.8
    eps = 1e-30
    updates, stats = {}, {}
    for k, g in grads.items():
        s, p = state.stats[k], params[k]
        g32 = g.to(F32)
        g2 = torch.square(g32) + eps
        if p.ndim >= 2:
            row = decay * s["row"] + (1 - decay) * torch.mean(g2, dim=-1)
            col = decay * s["col"] + (1 - decay) * torch.mean(g2, dim=-2)
            row_mean = torch.mean(row, dim=-1, keepdim=True) + eps
            v_hat = (row / row_mean)[..., :, None] * col[..., None, :]
            stats[k] = {"row": row, "col": col}
        else:
            v_hat = decay * s["v"] + (1 - decay) * g2
            stats[k] = {"v": v_hat}
        update = g32 / torch.sqrt(v_hat + eps)
        # update clipping (RMS <= 1) stabilizes warmup
        rms = torch.sqrt(torch.mean(torch.square(update)) + eps)
        update = update / torch.clamp_min(rms, 1.0)
        delta = -(lr * (update + cfg.weight_decay * p.to(F32)))
        updates[k] = delta.to(p.dtype)
    return updates, AdafactorState(step=step, stats=stats)


def make_optimizer(cfg: TrainConfig):
    """-> (init_fn, update_fn) per cfg.optimizer."""
    if cfg.optimizer == "adafactor":
        return adafactor_init, (lambda g, s, p: adafactor_update(cfg, g, s, p))
    if cfg.optimizer != "adamw":
        raise ValueError(f"optimizer {cfg.optimizer!r}: adamw or adafactor")
    return adamw_init, (lambda g, s, p: adamw_update(cfg, g, s, p))

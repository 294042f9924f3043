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

Across the ranks of a DeviceMesh the parameters, gradients and state are
DTensors, the state placed as ``launch.steps.build_opt_shardings`` says
(AdamW's moments as their parameter; Adafactor's statistics as theirs,
the reduced dim dropped). The arithmetic runs on each rank's shard, and
the updates come back as DTensors placed as their parameters. AdamW is
elementwise; Adafactor's means over a dim that is split across ranks,
and the RMS of the whole update, sum the shards' sums over the ranks
that split it before the division. Where no axis of more than one rank
splits a tensor it is the one-card arithmetic, operation for operation.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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


# a tensor's layout across ranks: (mesh, placements, global shape), or None
# for a tensor every rank holds whole

def _layout(t: torch.Tensor):
    if isinstance(t, DTensor):
        return t.device_mesh, tuple(t.placements), tuple(t.shape)
    return None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _wrap(local: torch.Tensor, lay) -> torch.Tensor:
    if lay is None:
        return local
    mesh, where, shape = lay
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, where, run_check=False,
                              shape=shape, stride=stride)


def _drop(lay, dim: int):
    """The layout of a tensor of layout ``lay`` reduced over ``dim``."""
    if lay is None:
        return None
    mesh, where, shape = lay
    d = dim % len(shape)
    return mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == d else
        Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > d else p
        for p in where), shape[:d] + shape[d + 1:]


def _split_over(lay, dims) -> list:
    """The mesh dims of more than one rank that split any of ``dims``."""
    if lay is None:
        return []
    mesh, where, shape = lay
    dims = {d % len(shape) for d in dims}
    return [i for i, p in enumerate(where)
            if isinstance(p, Shard) and p.dim in dims and mesh.size(i) > 1]


def _mean(x: torch.Tensor, lay, dim: Optional[int] = None,
          keepdim: bool = False) -> torch.Tensor:
    """The mean of the global tensor (layout ``lay``) whose local part is
    ``x``, over ``dim`` (every dim if None), on every rank that holds a
    part of the result."""
    dims = range(x.ndim) if dim is None else [dim]
    over = _split_over(lay, dims)
    if not over:
        return (torch.mean(x) if dim is None
                else torch.mean(x, dim=dim, keepdim=keepdim))
    import torch.distributed as dist
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                    keepdim=keepdim)
    mesh, _, shape = lay
    for i in over:
        dist.all_reduce(s, group=mesh.get_group(i))
    return s / (math.prod(shape) if dim is None else shape[dim])


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    m: Tensors
    v: Tensors


def adamw_init(params: Tensors) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=F32)
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
        g32, m, v, p = (_local(g).to(F32), _local(state.m[k]),
                        _local(state.v[k]), _local(params[k]))
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        m_hat = m / bc1
        v_hat = v / bc2
        delta = -(lr * (m_hat / (torch.sqrt(v_hat) + cfg.eps)
                        + cfg.weight_decay * p.to(F32)))
        updates[k] = _wrap(delta.to(p.dtype), _layout(params[k]))
    return updates, AdamWState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; Shazeer & Stern 2018, simplified)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    stats: Dict[str, Tensors]  # per leaf: row/col for >= 2-D, v for < 2-D


def adafactor_init(params: Tensors) -> AdafactorState:
    def init_one(p):
        lay, x = _layout(p), _local(p)
        z = lambda shape, lay: _wrap(
            torch.zeros(shape, dtype=F32, device=x.device), lay)
        if p.ndim >= 2:
            return {"row": z(x.shape[:-1], _drop(lay, -1)),
                    "col": z(x.shape[:-2] + x.shape[-1:], _drop(lay, -2))}
        return {"v": z(x.shape, lay)}

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
        lay = _layout(params[k])
        s = {n: _local(t) for n, t in state.stats[k].items()}
        p = _local(params[k])
        g32 = _local(g).to(F32)
        g2 = torch.square(g32) + eps
        if p.ndim >= 2:
            row = decay * s["row"] + (1 - decay) * _mean(g2, lay, -1)
            col = decay * s["col"] + (1 - decay) * _mean(g2, lay, -2)
            row_mean = _mean(row, _drop(lay, -1), -1, keepdim=True) + eps
            v_hat = (row / row_mean)[..., :, None] * col[..., None, :]
            stats[k] = {"row": _wrap(row, _drop(lay, -1)),
                        "col": _wrap(col, _drop(lay, -2))}
        else:
            v_hat = decay * s["v"] + (1 - decay) * g2
            stats[k] = {"v": _wrap(v_hat, lay)}
        update = g32 / torch.sqrt(v_hat + eps)
        # update clipping (RMS <= 1) stabilizes warmup
        rms = torch.sqrt(_mean(torch.square(update), lay) + eps)
        update = update / torch.clamp_min(rms, 1.0)
        delta = -(lr * (update + cfg.weight_decay * p.to(F32)))
        updates[k] = _wrap(delta.to(p.dtype), lay)
    return updates, AdafactorState(step=step, stats=stats)


def make_optimizer(cfg: TrainConfig):
    """-> (init_fn, update_fn) per cfg.optimizer."""
    if cfg.optimizer == "adafactor":
        return adafactor_init, (lambda g, s, p: adafactor_update(cfg, g, s, p))
    if cfg.optimizer != "adamw":
        raise ValueError(f"optimizer {cfg.optimizer!r}: adamw or adafactor")
    return adamw_init, (lambda g, s, p: adamw_update(cfg, g, s, p))

"""Pipeline parallelism: the GPipe schedule across the ranks of one mesh
axis.

The JAX package's ``sharding/pipeline.py``. Stages live on a mesh axis
(``"stage"``); the rank at index ``i`` of that axis holds stage ``i``'s
layer group. The schedule runs ``n_micro + n_stages - 1`` ticks; at each
tick every stage applies its layers to its current activation and hands
the result to the next stage over a send/recv ring (the reference's
``ppermute``; the first stage receives zeros). Stage 0 takes microbatch
``t``; the last stage emits microbatch ``t - (n_stages - 1)``. At the
end an ``all_reduce`` of the outputs masked to the last stage (the
reference's ``psum``) gives every rank the result. Bubble fraction =
(n_stages - 1) / (n_micro + n_stages - 1).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..launch.mesh import mesh_shape

__all__ = ["pipeline_apply", "stage_params"]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_params(params_stacked, n_stages: int):
    """Reshape (L, ...) stacked layer parameters (a tensor or nested dicts
    of them) into (n_stages, L / n_stages, ...) per-stage groups."""
    def split(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return _tree_map(split, params_stacked)


def pipeline_apply(stage_fn: Callable, params_staged, x_micro: torch.Tensor,
                   mesh, *, axis: str = "stage") -> torch.Tensor:
    """Run the GPipe schedule on every rank of ``mesh`` (a ``DeviceMesh``
    with an ``axis`` dimension).

    stage_fn(stage_local_params, act) -> act applies ONE stage's layer
        group; it sees parameters with the leading per-stage layer dim.
    params_staged: leaves (n_stages, L / n_stages, ...), the whole stack
        on every rank; each rank takes its stage's group.
    x_micro: (n_micro, mb, ...) microbatched inputs, the same on every
        rank.
    Returns (n_micro, mb, ...) outputs of the last stage on every rank.
    """
    n_stages = mesh_shape(mesh)[axis]
    n_micro = x_micro.shape[0]
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    p_stage = _tree_map(lambda w: w[idx], params_staged)
    last = n_stages - 1
    nxt = dist.get_global_rank(group, idx + 1) if idx < last else None
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None

    act = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        act_in = x_micro[min(t, n_micro - 1)] if idx == 0 else act
        act_out = stage_fn(p_stage, act_in).to(x_micro.dtype).contiguous()
        out_t = t - last
        if idx == last and out_t >= 0:
            outs[out_t] = act_out
        # ring shift to the next stage; the first stage receives zeros
        req = dist.isend(act_out, nxt) if nxt is not None else None
        act = torch.zeros_like(act_out)
        if prev is not None:
            dist.recv(act, prev)
        if req is not None:
            req.wait()
    outs = outs * (1.0 if idx == last else 0.0)
    dist.all_reduce(outs, group=group)
    return outs

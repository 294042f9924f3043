"""Gradient compression for cross-pod data parallelism: int8 stochastic
rounding with **error feedback**, the JAX package's
``optim/compression.py`` over dicts of tensors.

The quantization residual of step t is added back into the gradient at
step t+1, so compression error does not bias the long-run update
direction (Karimireddy et al., 2019). The rounding noise comes from an
explicit ``torch.Generator``: its stream cannot equal ``jax.random``'s,
so the two packages agree by property (error feedback converges), not
value by value. As in the reference, the wire payload stays at the
gradients' type; this validates the numerics.

Across the ranks of a DeviceMesh a gradient is a DTensor. Its scale is the
global one (each shard's max, then the max over the ranks), and its noise
is drawn for the whole tensor from the step's generator on every rank,
each rank taking its shard: the rounding of every element is the one a
single card gives it, draw for draw.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

__all__ = ["init_error_state", "compress_decompress", "quantize_int8",
           "dequantize_int8"]

Tensors = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale, stochastic rounding. -> (int8 values, f32 scale).
    A DTensor gives a DTensor placed as ``x`` and the global scale."""
    if isinstance(x, DTensor):
        return _quantize_shards(x, generator)
    x32 = x.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12) / 127.0
    scaled = x32 / scale
    noise = torch.empty_like(x32).uniform_(-0.5, 0.5, generator=generator)
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def _quantize_shards(x: DTensor, generator: torch.Generator):
    import torch.distributed as dist

    from ..sharding.partition import place
    mesh = x.device_mesh
    x32 = x.to_local().to(torch.float32)
    amax = torch.max(torch.abs(x32))
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(i))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    scaled = x32 / scale
    noise = torch.empty(x.shape, dtype=torch.float32,
                        device=x32.device).uniform_(-0.5, 0.5,
                                                    generator=generator)
    noise = place(noise, mesh, x.placements).to_local()
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return DTensor.from_local(q, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride()), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if isinstance(q, DTensor):
        return DTensor.from_local(q.to_local().to(torch.float32) * scale,
                                  q.device_mesh, q.placements,
                                  run_check=False, shape=q.shape,
                                  stride=q.stride())
    return q.to(torch.float32) * scale


def init_error_state(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def compress_decompress(grads: Tensors, error_state: Tensors,
                        generator: torch.Generator) -> Tuple[Tensors, Tensors]:
    """Error-feedback round trip: g' = deq(quant(g + e)); e' = (g + e) - g'.
    Returns (g', e'); the leaves draw their noise from ``generator`` in
    ``grads``' order."""
    outs, errs = {}, {}
    for k, g in grads.items():
        target = g.to(torch.float32) + error_state[k]
        q, scale = quantize_int8(target, generator)
        deq = dequantize_int8(q, scale)
        outs[k] = deq.to(g.dtype)
        errs[k] = target - deq
    return outs, errs

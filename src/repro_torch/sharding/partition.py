"""Logical-axis sharding rules -> DTensor placements.

The JAX package's ``sharding/partition.py``. Every parameter, batch leaf
and cache leaf has a tuple of logical dim names (``models.carry.
param_axes`` gives the parameters' tree in the reference's layout, the
families' ``init_cache`` the caches'). This module maps those names onto
mesh axes, as the reference does:

  batch       -> ("pod", "data")   DP over pods x data
  embed       -> "data" iff fsdp   ZeRO parameter sharding
  qheads/mlp/vocab/experts/ssm_inner -> "model"   TP / EP
  kvheads     -> replicated        (KV heads < TP degree in all archs)
  seq         -> "data" iff sp     sequence parallelism for long prefill

:meth:`PartitionRules.spec` gives the reference's ``PartitionSpec``
entries (one per dim: ``None``, a mesh axis, or a tuple of them), and
:func:`placements` turns a spec into DTensor placements, one per mesh
dimension: ``Shard(i)`` where the spec puts that mesh axis on tensor
dim ``i``, ``Replicate()`` where it uses it nowhere. :func:`place` makes
a DTensor of a global tensor that every rank holds, each rank keeping
its own shard, with no communication.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import mesh_shape

__all__ = ["PartitionRules", "make_rules", "logical_to_spec",
           "params_shardings", "batch_shardings", "cache_shardings",
           "placements", "place"]


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(s, str) for s in t)


def _map(fn: Callable, tree, is_leaf: Callable = _is_axes):
    """``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if not is_leaf(tree):
        raise TypeError(f"not a leaf of this tree: {tree!r}")
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """logical dim name -> mesh axis (or None = replicate), and the mesh:
    a ``launch.mesh.Mesh`` (a layout) or a ``DeviceMesh``."""

    table: Dict[str, Optional[object]]
    mesh: object

    def spec(self, axes: Tuple[str, ...]) -> Tuple:
        """One entry per dim, as ``PartitionSpec`` holds them (a tuple of
        one axis is that axis). A mesh axis may appear only once per spec
        (e.g. experts and mlp_e both map to "model": the first wins, the
        rest replicate)."""
        entries = []
        used = set()
        for name in axes:
            ax = self.table.get(name)
            group = ax if isinstance(ax, tuple) else (ax,)
            if ax is None or any(a in used for a in group):
                entries.append(None)
                continue
            used.update(group)
            entries.append(group[0] if len(group) == 1 else ax)
        return tuple(entries)


def make_rules(mesh, *, fsdp: bool = True, sp: bool = False,
               kv_cache_heads_shardable: bool = False,
               shard_cache_seq: bool = False,
               shard_ssm_heads: bool = False,
               replicate_attn_heads: bool = False) -> PartitionRules:
    """The logical -> mesh table, as the reference builds it.

    kv_cache_heads_shardable: the KV cache's head dim divides by the TP
        degree (the caller checks per arch) -> cache heads on "model".
    shard_cache_seq: shard the KV cache's *sequence* dim over "data"
        (long-context decode where the batch is below the DP degree).
    shard_ssm_heads: the SSM state's head dim divides by the TP degree.
    replicate_attn_heads: decode keeps attention heads whole.
    """
    dp = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    table = {
        # weights
        "embed": "data" if fsdp else None,
        "qheads": None if replicate_attn_heads else "model",
        "kvheads": None,
        "mlp": "model",
        "mlp_e": None,
        "vocab": "model",
        "experts": "model",
        "experts_r": None,
        "kv_lora": None,
        "layers": None,
        "ssm_inner": "model",
        "ssm_proj": None,
        "ssm_conv": None,
        "ssm_heads": "model" if shard_ssm_heads else None,
        "conv_width": None,
        "head_dim": None,
        "state": None,
        # activations and caches
        "batch": None if shard_cache_seq else dp,
        "seq": "data" if sp else None,
        "seq_cache": "data" if shard_cache_seq else None,
        "kvheads_sep": "model" if kv_cache_heads_shardable else None,
        "shared_sites": None,
    }
    return PartitionRules(table=table, mesh=mesh)


def placements(mesh, spec: Tuple) -> Tuple:
    """A spec's DTensor placements on ``mesh``, one per mesh dimension in
    its order: ``Shard(i)`` for the axes the spec puts on dim ``i`` (a
    tuple entry shards dim ``i`` over its axes in mesh order),
    ``Replicate()`` for the others."""
    where = {}
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_shape(mesh))


def logical_to_spec(rules: PartitionRules, axes_tree):
    """The tree of specs of an axes tree (nested dicts of name tuples)."""
    return _map(rules.spec, axes_tree)


def params_shardings(rules: PartitionRules, axes_tree):
    """The tree of placements (on ``rules.mesh``) of an axes tree."""
    return _map(lambda ax: placements(rules.mesh, rules.spec(ax)),
                axes_tree)


def batch_shardings(rules: PartitionRules, batch_tree, *,
                    shard_seq: bool = False):
    """Every batch leaf's leading batch dim over DP; the vlm ``positions``
    leaf is (3, B, S), batch on dim 1. ``shard_seq`` is accepted and, as
    in the reference, changes nothing."""
    dp = rules.table["batch"]

    def spec_for(leaf):
        nd = leaf.dim()
        if nd == 3 and leaf.shape[0] == 3:
            return (None, dp, None)
        return (dp,) + (None,) * (nd - 1)

    return _map(lambda leaf: placements(rules.mesh, spec_for(leaf)),
                batch_tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


def cache_shardings(rules: PartitionRules, cache_axes):
    return params_shardings(rules, cache_axes)


def place(tensor: torch.Tensor, mesh, where: Tuple) -> DTensor:
    """A DTensor on ``mesh`` with placements ``where`` of the global
    ``tensor``, which every rank holds: each rank keeps its shard (the
    chunks ``torch.chunk`` gives, mesh dims in order), nothing moves
    between ranks."""
    tensor = tensor.contiguous()
    local = tensor
    coord = mesh.get_coordinate()
    for d, p in enumerate(where):
        if isinstance(p, Shard):
            local = torch.chunk(local, mesh.size(d), dim=p.dim)[coord[d]]
    return DTensor.from_local(local.contiguous(), mesh, where,
                              run_check=False, shape=tensor.shape,
                              stride=tensor.stride())

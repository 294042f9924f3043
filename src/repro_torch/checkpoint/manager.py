"""Checkpointing of the training state: the durable cross-job tier
beside the ADCC slot store (``core/slots.py``), which is the fast
intra-job one.

The JAX package's ``checkpoint/manager.py``. A checkpoint stores global
(unsharded) arrays in the flat layout of the slots, so one written by
either package restores in the other. ``restore_elastic`` places every
global array against the target mesh's placements (a mesh of another
size than the one that wrote it: elastic scaling).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.carry import nest, to_host, tree_items

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_elastic"]


def save_checkpoint(path: str, state, step: int,
                    extra_meta: Optional[Dict] = None) -> None:
    """state: a nested dict of tensors (fetched to the host as numpy
    arrays)."""
    os.makedirs(path, exist_ok=True)
    flat = {k: to_host(v) for k, v in tree_items(state)}
    np.savez(os.path.join(path, "state.npz"),
             **{k.replace("/", "__"): v for k, v in flat.items()})
    meta = {"step": step, "n_leaves": len(flat)}
    meta.update(extra_meta or {})
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def restore_checkpoint(path: str, template) -> Tuple[Any, Dict]:
    """Rebuild the nested dict of tensors, each on the device of the
    template's leaf. The template supplies the structure; a leaf it has
    and the file lacks raises KeyError."""
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    out = {k: torch.from_numpy(flat[k]).to(t.device)
           for k, t in tree_items(template)}
    return nest(out), meta


def restore_elastic(path: str, template, rules, axes_tree) -> Tuple[Any, Dict]:
    """Restore onto another mesh: every global array of the checkpoint
    (``template``'s leaves, on the device of each) becomes a DTensor on
    ``rules.mesh`` (a ``DeviceMesh``) with the placements its logical
    axes (``axes_tree``, the same structure) take under ``rules``; each
    rank keeps its shard. Raises ValueError without partition rules."""
    from ..sharding.partition import PartitionRules, params_shardings, place
    if not isinstance(rules, PartitionRules):
        raise ValueError("restore_elastic places arrays by the partition "
                         "rules of the target mesh (sharding.partition."
                         f"make_rules); got {rules!r}")
    state, meta = restore_checkpoint(path, template)
    where = dict(tree_items(params_shardings(rules, axes_tree)))
    placed = {k: place(t, rules.mesh, where[k])
              for k, t in tree_items(state)}
    return nest(placed), meta

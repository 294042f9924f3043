"""Checkpointing of the training state: the durable cross-job tier
beside the ADCC slot store (``core/slots.py``), which is the fast
intra-job one.

The JAX package's ``checkpoint/manager.py``. A checkpoint stores global
(unsharded) arrays in the flat layout of the slots, so one written by
either package restores in the other. ``restore_elastic`` places every
array against the target mesh's shardings and needs the port's
sharding slice (ROADMAP A10b.7); until then it raises.
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
    """Restore onto a different mesh. Needs the partition rules of the
    port's sharding slice, which is not ported yet."""
    raise NotImplementedError(
        "restore_elastic needs sharding/partition.py, which is not ported "
        "yet (ROADMAP A10b.7); restore_checkpoint restores on one card")

"""Meshes of the port.

The JAX package's ``launch/mesh.py`` builds ``jax.sharding.Mesh``
objects. The port has two kinds:

* :class:`Mesh` — axis names and sizes, bound to no process: the layout
  :func:`single_device_mesh` gives one card (what the reference's
  trainer builds when it is given no mesh) and
  :func:`make_production_mesh` gives the production pods, for a dry run
  that places nothing.
* :func:`make_mesh` — a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names``, bound to the live default process group: one rank
  per card with NCCL, or ranks on the CPU with gloo. The processes are
  started with ``torch.multiprocessing.spawn`` (never forked) and each
  calls ``torch.distributed.init_process_group`` with its rank, the world
  size and an address of its own choosing before it builds the mesh.

Serving (``forward``, ``decode_step``, ``build_serve_step``) runs across
the ranks of such a mesh. Training across ranks (``build_train_step``,
``ADCCTrainer``) comes with ROADMAP A10b.7b: :func:`one_card` raises for
any mesh but one card there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "single_device_mesh",
           "one_card", "is_ranked", "mesh_shape", "check_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, as ``jax.sharding.Mesh`` gives them
    (``axis_names``, ``shape`` by name, ``size``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = 256 cards, axes (data, model). Multi-pod:
    (2, 16, 16) = 512 cards, axes (pod, data, model). A layout only: no
    process group is needed or touched."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    live default process group, in rank order (the last axis fastest).
    Its device type follows the group's backend: ``cuda`` for NCCL (rank
    ``r`` on card ``r`` of its host), ``cpu`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a live process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} holds "
                         f"{math.prod(shape)} ranks; the group has {world}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def single_device_mesh(axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """A mesh of one card with the production axis names: what the
    reference's trainer builds when it is given none."""
    return Mesh(tuple(axes), (1,) * len(axes))


def is_ranked(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (bound to processes)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, of a :class:`Mesh` or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def check_mesh(mesh):
    """``mesh`` if it is ``None``, a mesh of one card or a ``DeviceMesh``
    with named axes. A :class:`Mesh` of several cards is a layout with no
    processes behind it and raises ValueError; anything else TypeError."""
    if mesh is None or (isinstance(mesh, Mesh) and mesh.size == 1):
        return mesh
    if isinstance(mesh, Mesh):
        raise ValueError(
            f"{mesh!r} is a layout of {mesh.size} ranks with no process "
            f"group behind it; run across ranks on launch.mesh.make_mesh")
    if is_ranked(mesh) and mesh.mesh_dim_names:
        return mesh
    raise TypeError(f"{mesh!r} is not a mesh: pass None, "
                    f"single_device_mesh() or make_mesh(shape, axes)")


def one_card(mesh) -> Optional[Mesh]:
    """``mesh`` if it is ``None`` or a mesh of one card; raises for any
    other, naming the slice that trains across ranks."""
    if mesh is None or (isinstance(mesh, Mesh) and mesh.size == 1):
        return mesh
    raise NotImplementedError(
        f"mesh {mesh!r}: the port trains on one card; training across "
        f"ranks comes with ROADMAP A10b.7b")

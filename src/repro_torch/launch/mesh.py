"""Meshes of the port: one card.

The JAX package's ``launch/mesh.py`` builds ``jax.sharding.Mesh`` objects.
The port runs on one card, so the only mesh it builds is
:func:`single_device_mesh`: the production axis names over a shape of
ones. Code that takes a ``mesh`` accepts ``None`` or such a mesh (it
then runs the path the reference runs on its one-device mesh, e.g. the
expert-parallel MoE with its capacity drops) and raises for anything
larger: sharding over several cards comes with ROADMAP A10b.7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = ["Mesh", "single_device_mesh", "one_card"]


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


def single_device_mesh(axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """A mesh of one card with the production axis names: what the
    reference's trainer builds when it is given none."""
    return Mesh(tuple(axes), (1,) * len(axes))


def one_card(mesh) -> Optional[Mesh]:
    """``mesh`` if it is ``None`` or a mesh of one card; raises for any
    other (a mesh of several cards, or something that is no mesh)."""
    if mesh is None or (isinstance(mesh, Mesh) and mesh.size == 1):
        return mesh
    raise NotImplementedError(
        f"mesh {mesh!r}: the port runs on one card; sharding over a "
        f"larger mesh comes with ROADMAP A10b.7")

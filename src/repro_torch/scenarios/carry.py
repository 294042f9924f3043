"""State carried across from the reference package.

A workload's ``snapshot()`` (``workloads.py``) is the emulator snapshot
— every region's truth and NVM image, the traffic stats, the backend's
volatile-cache state, the crashed flag — plus the workload's host-side
scalars. :func:`snapshot_from_reference` rebuilds that snapshot for this
package from a *flat* dictionary of numpy arrays and Python scalars, so
that a run begun in the reference package (its golden prefix, say) can
be continued here: build the same workload spec, ``setup()`` it, and
``restore_snapshot(snapshot_from_reference(flat))``.

The flat form (the caller flattens the reference snapshot into it; no
object of the other package crosses over):

  ``truth/<region>``, ``image/<region>``   flat region arrays
  ``stats/<field>``                        every TrafficStats field
  ``crashed``                              bool
  ``truth_desynced``                       sequence of region names
  ``scalars/<name>``                       workload scalars (CG's rho)
  ``backend/kind``                         ``"vectorized"`` or ``"reference"``

  vectorized backend:
    ``backend/regions/<region>/present|dirty|stamp``  per-entry arrays
    ``backend/clock``, ``backend/weight_used``        ints
    ``backend/queue/rid|entry|stamp``                 live queue slice

  reference backend:
    ``backend/lru/name``    sequence of region names, eviction order
    ``backend/lru/entry``   int array, same order
    ``backend/lru/dirty``   bool array, same order
    ``backend/weight_used`` int
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np

from ..core.nvm import EmuSnapshot, TrafficStats

__all__ = ["snapshot_from_reference"]

# Mutation epochs are per-instance counters and do not carry over. The
# emulator's restore skips a region whose live epoch equals the
# snapshot's; live epochs are never negative, so this value makes every
# region of a carried snapshot be copied in.
_FOREIGN_EPOCH = -1


def _frozen(a) -> np.ndarray:
    out = np.array(a, copy=True)
    out.flags.writeable = False
    return out


def _group(flat: Mapping[str, object], prefix: str) -> Dict[str, object]:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _backend_state(flat: Mapping[str, object]):
    kind = flat["backend/kind"]
    if kind == "vectorized":
        names = sorted({k.rsplit("/", 1)[0]
                        for k in _group(flat, "backend/regions/")})
        return {
            "regions": {
                name: tuple(_frozen(flat[f"backend/regions/{name}/{part}"])
                            for part in ("present", "dirty", "stamp"))
                for name in names},
            "clock": int(flat["backend/clock"]),
            "weight_used": int(flat["backend/weight_used"]),
            "queue": tuple(_frozen(flat[f"backend/queue/{part}"])
                           for part in ("rid", "entry", "stamp")),
        }
    if kind == "reference":
        lru = OrderedDict(
            ((str(name), int(entry)), bool(dirty))
            for name, entry, dirty in zip(flat["backend/lru/name"],
                                          flat["backend/lru/entry"],
                                          flat["backend/lru/dirty"]))
        return (lru, int(flat["backend/weight_used"]))
    raise ValueError(f"cannot carry backend state of kind {kind!r}")


def snapshot_from_reference(flat: Mapping[str, object]) -> Dict[str, object]:
    """The workload snapshot (``{"emu": EmuSnapshot, "scalars": {...}}``)
    that ``Workload.restore_snapshot`` of this package takes, built from
    the flat form described in the module docstring."""
    truth = {k: _frozen(v) for k, v in _group(flat, "truth/").items()}
    image = {k: _frozen(v) for k, v in _group(flat, "image/").items()}
    fields = {f.name for f in dataclasses.fields(TrafficStats)}
    given = _group(flat, "stats/")
    if set(given) != fields:
        raise ValueError(f"stats fields {sorted(given)} do not match "
                         f"TrafficStats {sorted(fields)}")
    stats = TrafficStats(**{
        k: (float(v) if isinstance(getattr(TrafficStats, k), float)
            else int(v))
        for k, v in given.items()})
    emu = EmuSnapshot(
        truth=truth, image=image,
        truth_epoch={k: _FOREIGN_EPOCH for k in truth},
        image_epoch={k: _FOREIGN_EPOCH for k in image},
        stats=stats,
        backend=_backend_state(flat),
        crashed=bool(flat["crashed"]),
        truth_desynced=frozenset(str(n) for n in flat["truth_desynced"]),
    )
    return {"emu": emu, "scalars": dict(_group(flat, "scalars/"))}

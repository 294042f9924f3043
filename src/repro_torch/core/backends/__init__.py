"""Pluggable NVM cache-emulation backends.

``MemoryBackend`` (base.py) is the narrow protocol; three
implementations ship here:

* ``reference`` — :class:`ReferenceLRUBackend`, exact per-entry
  OrderedDict semantics; the oracle.
* ``vectorized`` — :class:`VectorizedBackend`, batched bitmap/stamp
  arrays; the default, byte-equivalent to the oracle.
* ``device`` — :class:`DeviceBackend`, the vectorized backend with
  large eviction-free span ops and queue-validity scans lifted onto
  torch ops on :func:`~repro_torch.get_device`; byte-equivalent to
  both, it keeps the vectorized host path under eviction pressure and
  raises without a card unless the CPU was selected.

Select with ``NVMConfig(backend="...")`` or the ``REPRO_NVM_BACKEND``
environment variable.
"""

from __future__ import annotations

from .base import (LineSurvival, MediaFault, MemoryBackend,
                   corrupt_image_words, select_survivors)
from .device import DeviceBackend
from .reference import ReferenceLRUBackend
from .vectorized import VectorizedBackend

__all__ = ["MemoryBackend", "LineSurvival", "select_survivors",
           "MediaFault", "corrupt_image_words",
           "ReferenceLRUBackend", "VectorizedBackend", "DeviceBackend",
           "BACKENDS", "make_backend"]

BACKENDS = {
    ReferenceLRUBackend.kind: ReferenceLRUBackend,
    VectorizedBackend.kind: VectorizedBackend,
    DeviceBackend.kind: DeviceBackend,
}


def make_backend(kind: str, store, cfg) -> MemoryBackend:
    try:
        cls = BACKENDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown NVM backend {kind!r}; available: {sorted(BACKENDS)}"
        ) from None
    return cls(store, cfg)

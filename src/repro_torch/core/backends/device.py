"""Device-resident forward pass: torch cache transitions over the
vectorized backend's state.

``DeviceBackend`` lifts the NVM-emulation *forward pass* — the write
coalescing, dirty bitmaps/stamps, and traffic accounting that every
golden prefix pays per step — onto the torch device
(:func:`repro_torch.core.backends.batched.cache_op_update` /
:func:`queue_validity`, on :func:`repro_torch.get_device`). It
subclasses :class:`VectorizedBackend` and overrides exactly two inner
loops:

* ``_op``: a span operation whose entry range is large and provably
  eviction-free (the streaming regime — CSR matvec rows, MC grids, KV
  value-log extents under an adequate cache) is computed as one device
  pass producing the new bitmaps/stamps, the miss mask, and the miss
  count; the host then commits the results, queue-appends in the
  reference order, and charges traffic once. The pass is
  *speculative*: nothing is mutated until the no-eviction precondition
  (``occupancy + misses * weight <= capacity``) is confirmed, so any op
  that could evict takes the parent's host path untouched —
  byte/stat-identity with :class:`VectorizedBackend` is by
  construction, not by reimplementation. The miss count reaches the
  host before the commit: one synchronize per device op.
* ``_validity``: queue-slot validation for large single-region blocks
  (the eviction/compaction/crash-order scan) as one gather pass.

Everything else — batched eviction, flush, drain, ``crash(survival)``
line- and word-granularity torn paths, ``snapshot()/restore()``, media
faults via ``corrupt_image_words`` — is inherited unchanged: the state
stays in the parent's numpy arrays and only slices of it visit the
device, so the fork ladder, snapshot tiering, and fault injection run
on top of it with the cross-backend byte-identity contracts intact.

The transitions are memory-bound elementwise and gather ops, written as
plain torch ops: no hand-written kernel. The host path is taken only
where the reference takes it — below :data:`DeviceBackend.
MIN_DEVICE_ENTRIES`, under eviction pressure, and for a validity window
that spans several regions. Without a card the backend raises (through
:func:`~repro_torch.get_device`) unless the caller selected the CPU
with :func:`~repro_torch.use_device`.

Worker-pool caveat: a process that has run torch math cannot fork
children that run it too (a forked child inherits neither the parent's
CUDA context nor its intra-op thread pool). The sweep driver spawns its
workers whenever the emulator backend is ``device`` (see
``repro_torch.scenarios.driver.sweep``).
"""

from __future__ import annotations

import numpy as np

from ...device import get_device
from . import batched as _dev
from .vectorized import VectorizedBackend

__all__ = ["DeviceBackend"]


class DeviceBackend(VectorizedBackend):
    """Vectorized cache emulation with bulk transitions on the torch
    device."""

    kind = "device"

    # smallest entry count routed to the device: below this the launch
    # and transfer overhead exceeds the bulk-transition win (tests lower
    # it to force every span op through the device math)
    MIN_DEVICE_ENTRIES = 2048

    def __init__(self, store, cfg):
        get_device()    # no card and no use_device("cpu"): raise here
        super().__init__(store, cfg)
        # span ops committed from the device pass, and ops whose pass
        # was declined (eviction pressure) for the host path
        self.device_ops = 0
        self.declined_ops = 0

    def _op(self, name: str, lo: int, hi: int, is_write: bool) -> None:
        r = self._regions[name]
        if hi <= lo:
            return
        e_lo = lo // r.epe
        e_hi = (hi - 1) // r.epe + 1
        m = e_hi - e_lo
        if m < self.MIN_DEVICE_ENTRIES:
            super()._op(name, lo, hi, is_write)
            return
        sl = slice(e_lo, e_hi)
        t0 = self._clock
        fifo = self.cfg.replacement == "fifo"
        new_p, new_d, new_s, miss, n_miss = _dev.cache_op_update(
            r.present[sl], r.dirty[sl], r.stamp[sl], t0, is_write, fifo)
        if self._weight_used + n_miss * r.w > self.capacity_lines:
            # eviction pressure: nothing mutated yet — the parent's
            # hit/miss-run walk with interleaved queue pops is the
            # reference-exact path
            self.declined_ops += 1
            super()._op(name, lo, hi, is_write)
            return
        self.device_ops += 1
        self._clock = t0 + m
        r.present[sl] = new_p
        r.dirty[sl] = new_d
        r.stamp[sl] = new_s
        ents = np.arange(e_lo, e_hi, dtype=np.int64)
        stamps = t0 + np.arange(m, dtype=np.int64)
        if fifo:
            # FIFO hits keep their queue slot; only misses enqueue
            self._q_append(r.rid, ents[miss], stamps[miss])
        else:
            self._q_append(r.rid, ents, stamps)
        self._weight_used += n_miss * r.w
        self.store.stats.charge_batch(
            self.cfg, write_bytes=0,
            read_bytes=0 if is_write else n_miss * r.epe * r.itemsize,
            evict_lines=0)

    def _validity(self, rids: np.ndarray, ents: np.ndarray,
                  stamps: np.ndarray):
        n = rids.shape[0]
        if n < self.MIN_DEVICE_ENTRIES:
            return super()._validity(rids, ents, stamps)
        rid0 = int(rids[0])
        if not np.all(rids == rid0):
            return super()._validity(rids, ents, stamps)
        r = self._by_rid.get(rid0)
        if r is None:  # dropped region: every slot is stale
            return (np.zeros(n, dtype=bool), np.zeros(n, dtype=np.int64))
        return _dev.queue_validity(r.present, r.stamp, ents, stamps, r.w)

"""Exact per-entry LRU/FIFO backend — the semantic oracle.

This is the original ``VolatileCache`` (an ``OrderedDict`` walked one
entry at a time), kept as the reference implementation that the
vectorized backend must match byte-for-byte on any trace. It is the
right choice for small caches / short traces and for equivalence
testing; for large sweeps use ``VectorizedBackend``.

Two deliberate changes from the pre-backend implementation:

* ``drain()`` now goes through the same eviction bookkeeping as
  capacity evictions, so drained entries count in ``lines_evicted`` and
  their writebacks are charged like any other eviction (the old copy
  of the loop silently skipped both);
* all stats for one operation are aggregated and charged once through
  :meth:`TrafficStats.charge_batch`, making stats bit-identical across
  backends (per-entry float accumulation orders would differ).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from .base import (LineSurvival, OpAccumulator as _OpAcc, select_survivors,
                   select_survivor_words)

__all__ = ["ReferenceLRUBackend"]


class ReferenceLRUBackend:
    """Fully-associative LRU (or FIFO) write-back cache, entry at a time.

    Keys are ``(region, entry_index)`` where an *entry* covers
    ``sector_lines`` consecutive cache lines of that region. Only
    occupancy and dirtiness are tracked — the newest data lives in the
    registered truth arrays; the store's image holds whatever has been
    written back.
    """

    kind = "reference"

    def __init__(self, store, cfg):
        self.store = store
        self.cfg = cfg
        self.capacity_lines = max(1, cfg.cache_bytes // cfg.line_bytes)
        # value = dirty flag; weight per entry is a per-region constant
        self._lru: "OrderedDict[Tuple[str, int], bool]" = OrderedDict()
        self._weight_used = 0
        self._truth: Dict[str, np.ndarray] = {}
        self._sector_lines: Dict[str, int] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, truth_flat: np.ndarray,
                 sector_lines: int = 1) -> None:
        self._truth[name] = truth_flat
        self._sector_lines[name] = max(1, int(sector_lines))

    def unregister(self, name: str) -> None:
        self._truth.pop(name, None)
        stale = [k for k in self._lru if k[0] == name]
        w = self._sector_lines.get(name, 1)
        for k in stale:
            del self._lru[k]
            self._weight_used -= w
        self._sector_lines.pop(name, None)

    # -- geometry ----------------------------------------------------------
    def _elems_per_entry(self, name: str) -> int:
        epl = max(1, self.cfg.line_bytes // self._truth[name].itemsize)
        return epl * self._sector_lines[name]

    def _entry_range(self, name: str, lo: int, hi: int) -> range:
        epe = self._elems_per_entry(name)
        return range(lo // epe, (hi - 1) // epe + 1) if hi > lo else range(0)

    # -- internals ----------------------------------------------------------
    def _evict_one(self, acc: _OpAcc) -> None:
        (name, entry), dirty = self._lru.popitem(last=False)
        self._weight_used -= self._sector_lines[name]
        if dirty:
            acc.wb_bytes += self._writeback_entry(name, entry)
        acc.evict_lines += self._sector_lines[name]

    def _writeback_entry(self, name: str, entry: int) -> int:
        truth = self._truth[name]
        epe = self._elems_per_entry(name)
        lo = entry * epe
        hi = min(lo + epe, truth.shape[0])
        if hi > lo:
            self.store.persist(name, lo, hi, truth)
            return (hi - lo) * truth.itemsize
        return 0

    def _touch(self, name: str, entry: int, dirty: bool, acc: _OpAcc) -> None:
        key = (name, entry)
        if self.cfg.replacement == "fifo":
            # FIFO: hits update dirtiness in place (no reordering), so hot
            # lines age out periodically like victims of set conflicts
            prev = self._lru.get(key)
            if prev is not None:
                if dirty and not prev:
                    self._lru[key] = True
                return
            w = self._sector_lines[name]
            while self._weight_used + w > self.capacity_lines and self._lru:
                self._evict_one(acc)
            self._weight_used += w
            self._lru[key] = dirty
            return
        prev = self._lru.pop(key, None)
        if prev is None:
            w = self._sector_lines[name]
            while self._weight_used + w > self.capacity_lines and self._lru:
                self._evict_one(acc)
            self._weight_used += w
        self._lru[key] = dirty or bool(prev)

    # -- program-visible operations ------------------------------------------
    def write(self, name: str, lo: int, hi: int) -> None:
        acc = _OpAcc()
        for entry in self._entry_range(name, lo, hi):
            self._touch(name, entry, dirty=True, acc=acc)
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes, evict_lines=acc.evict_lines)

    def read(self, name: str, lo: int, hi: int) -> None:
        acc = _OpAcc()
        for entry in self._entry_range(name, lo, hi):
            if (name, entry) not in self._lru:
                acc.read_entries += 1
            self._touch(name, entry, dirty=False, acc=acc)
        epe = self._elems_per_entry(name)
        itemsize = self._truth[name].itemsize
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes,
            read_bytes=acc.read_entries * epe * itemsize,
            evict_lines=acc.evict_lines)

    def flush(self, name: str, lo: int = 0, hi: Optional[int] = None) -> None:
        if hi is None:
            hi = self._truth[name].shape[0]
        entries = self._entry_range(name, lo, hi)
        sector = self._sector_lines[name]
        itemsize = self._truth[name].itemsize
        epe = self._elems_per_entry(name)
        wb_bytes = 0
        clean = 0
        for entry in entries:
            key = (name, entry)
            dirty = self._lru.pop(key, None)
            if dirty is not None:
                self._weight_used -= sector
            if dirty:
                wb_bytes += self._writeback_entry(name, entry)
            else:
                # clean/absent flush still occupies the memory pipeline
                clean += 1
        self.store.stats.charge_batch(
            self.cfg, write_bytes=wb_bytes,
            flush_lines=len(entries) * sector,
            clean_flush_bytes=clean * epe * itemsize)

    def drain(self) -> None:
        acc = _OpAcc()
        while self._lru:
            self._evict_one(acc)
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes, evict_lines=acc.evict_lines)

    def crash(self, survival: Optional[LineSurvival] = None) -> int:
        dirty = self.dirty_eviction_order()
        if survival is not None and survival.granularity == "word":
            return self._crash_words(dirty, survival)
        survivors = select_survivors(dirty, survival)
        if survivors:
            nbytes = 0
            for name, entry in survivors:
                nbytes += self._writeback_entry(name, entry)
            self.store.stats.note_torn_persist(nbytes, len(survivors))
        self._lru.clear()
        self._weight_used = 0
        return len(dirty) - len(survivors)

    def _crash_words(self, dirty, survival: LineSurvival) -> int:
        """Word-granularity torn crash: individual machine words of the
        dirty entries persist (sub-line WITCHER crash states). An entry
        counts as lost only if none of its words made it."""
        words = select_survivor_words(dirty, survival, self.entry_geometry)
        if words:
            nbytes = 0
            for name, _entry, lo, hi in words:
                truth = self._truth[name]
                self.store.persist(name, lo, hi, truth)
                nbytes += (hi - lo) * truth.itemsize
            self.store.stats.note_torn_persist(nbytes, len(words))
        touched = {(name, entry) for name, entry, _lo, _hi in words}
        self._lru.clear()
        self._weight_used = 0
        return len(dirty) - len(touched)

    # -- snapshot / fork ----------------------------------------------------
    def snapshot(self) -> object:
        # keys are (name, entry) tuples and values plain bools, so one
        # OrderedDict copy is an exact deep capture incl. recency order
        return (OrderedDict(self._lru), self._weight_used)

    def restore(self, snap: object) -> None:
        lru, weight = snap
        self._lru = OrderedDict(lru)
        self._weight_used = weight

    # -- introspection ------------------------------------------------------
    @property
    def occupancy_lines(self) -> int:
        return self._weight_used

    def dirty_entries(self, name: str) -> np.ndarray:
        out = sorted(e for (n, e), d in self._lru.items() if n == name and d)
        return np.asarray(out, dtype=np.int64)

    def has_dirty(self, name: str) -> bool:
        return any(d for (n, _e), d in self._lru.items() if n == name)

    def dirty_eviction_order(self):
        # OrderedDict iteration order IS the eviction order (front =
        # next victim), so the dirty keys in place are the canonical
        # eviction_order input select_survivors expects
        return [key for key, d in self._lru.items() if d]

    def entry_geometry(self, name: str):
        truth = self._truth[name]
        return self._elems_per_entry(name), truth.shape[0], truth.itemsize

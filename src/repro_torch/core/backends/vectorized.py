"""Batched numpy backend — semantics identical to the reference oracle.

State per region is three flat numpy arrays over *entries* (an entry =
``sector_lines`` cache lines): a presence bitmap, a dirty bitmap, and an
int64 last-touch stamp (insertion stamp under FIFO). Replacement order
lives in a global append-only queue of ``(region, entry, stamp)`` slots
with lazy staleness: a slot is live iff the entry is present and its
stamp still matches (LRU re-touches append a fresh slot, invalidating
the old one). This is exactly an ``OrderedDict`` — but poppable and
appendable in vectorized batches.

An operation over ``[lo, hi)`` decomposes its entry range into
alternating hit/miss *runs* (misses can appear mid-op when eviction
pressure throws out a not-yet-touched entry of the same range — the
queue pop detects those and extends the miss mask, reproducing the
reference's per-entry interleaving). Each run is handled with O(1)
numpy ops: bulk bitmap/stamp updates, bulk queue append, and chunked
queue pops that free exactly the line weight the reference would. Cost
charging follows the invariants in backends/base.py: integer aggregates
per operation, applied once through ``TrafficStats.charge_batch`` — so
traffic stats match the reference bit-for-bit, and the post-crash NVM
image is byte-identical (verified by tests/test_backend_equivalence.py
on randomized traces).

Per-op Python cost is O(#runs + #eviction-chunks) instead of the
reference's O(#entries); contiguous streaming access — the shape of the
paper's CSR matvecs and MC grid lookups — is a single run.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import (LineSurvival, OpAccumulator as _OpAcc, select_survivors,
                   select_survivor_words)

__all__ = ["VectorizedBackend"]

_EVICT_CHUNK = 1024


class _Region:
    __slots__ = ("name", "rid", "truth", "image", "w", "epe", "itemsize",
                 "n_entries", "present", "dirty", "stamp")

    def __init__(self, name: str, rid: int, truth: np.ndarray,
                 image: np.ndarray, sector_lines: int, line_bytes: int):
        self.name = name
        self.rid = rid
        self.truth = truth
        self.image = image
        self.w = sector_lines
        self.itemsize = truth.itemsize
        epl = max(1, line_bytes // truth.itemsize)
        self.epe = epl * sector_lines
        n = truth.shape[0]
        self.n_entries = (n + self.epe - 1) // self.epe
        self.present = np.zeros(self.n_entries, dtype=bool)
        self.dirty = np.zeros(self.n_entries, dtype=bool)
        self.stamp = np.zeros(self.n_entries, dtype=np.int64)

    def entry_nbytes(self, entries: np.ndarray) -> np.ndarray:
        nb = np.full(entries.shape, self.epe * self.itemsize, dtype=np.int64)
        last = self.n_entries - 1
        tail = self.truth.shape[0] - last * self.epe
        nb[entries == last] = tail * self.itemsize
        return nb


class VectorizedBackend:
    """Bitmap/stamp-array cache emulation with batched queue eviction."""

    kind = "vectorized"

    def __init__(self, store, cfg):
        self.store = store
        self.cfg = cfg
        self.capacity_lines = max(1, cfg.cache_bytes // cfg.line_bytes)
        self._regions: Dict[str, _Region] = {}
        self._by_rid: Dict[int, _Region] = {}
        self._next_rid = 0
        self._clock = 1  # stamp 0 = "never touched"
        self._weight_used = 0
        cap = 1024
        self._q_rid = np.zeros(cap, dtype=np.int64)
        self._q_entry = np.zeros(cap, dtype=np.int64)
        self._q_stamp = np.zeros(cap, dtype=np.int64)
        self._q_head = 0
        self._q_len = 0
        # compaction scratch (lazily grown): _q_compact copies the live
        # window here instead of allocating three fresh arrays per
        # compaction — dense sweeps compact thousands of times
        self._qc_rid = np.zeros(0, dtype=np.int64)
        self._qc_entry = np.zeros(0, dtype=np.int64)
        self._qc_stamp = np.zeros(0, dtype=np.int64)

    # -- registration ------------------------------------------------------
    def register(self, name: str, truth_flat: np.ndarray,
                 sector_lines: int = 1) -> None:
        r = _Region(name, self._next_rid, truth_flat, self.store.image[name],
                    max(1, int(sector_lines)), self.cfg.line_bytes)
        self._next_rid += 1
        self._regions[name] = r
        self._by_rid[r.rid] = r

    def unregister(self, name: str) -> None:
        r = self._regions.pop(name, None)
        if r is None:
            return
        self._weight_used -= int(r.present.sum()) * r.w
        # queue slots of a dropped rid fail validity lookups and get
        # skipped/compacted away lazily
        self._by_rid.pop(r.rid, None)

    # -- queue ---------------------------------------------------------------
    def _validity(self, rids: np.ndarray, ents: np.ndarray,
                  stamps: np.ndarray):
        """(live mask, per-slot line weights) for a block of queue slots."""
        valid = np.zeros(rids.shape[0], dtype=bool)
        wts = np.zeros(rids.shape[0], dtype=np.int64)
        for rid in np.unique(rids):
            r = self._by_rid.get(int(rid))
            if r is None:
                continue
            m = rids == rid
            e = ents[m]
            v = r.present[e] & (r.stamp[e] == stamps[m])
            valid[m] = v
            wts[m] = np.where(v, r.w, 0)
        return valid, wts

    def _q_compact(self) -> None:
        n = self._q_len - self._q_head
        if self._qc_rid.shape[0] < n:
            cap = max(n, 2 * self._qc_rid.shape[0])
            self._qc_rid = np.zeros(cap, dtype=np.int64)
            self._qc_entry = np.zeros(cap, dtype=np.int64)
            self._qc_stamp = np.zeros(cap, dtype=np.int64)
        sl = slice(self._q_head, self._q_len)
        rids, ents, stamps = (self._qc_rid[:n], self._qc_entry[:n],
                              self._qc_stamp[:n])
        np.copyto(rids, self._q_rid[sl])
        np.copyto(ents, self._q_entry[sl])
        np.copyto(stamps, self._q_stamp[sl])
        keep, _ = self._validity(rids, ents, stamps)
        k = int(keep.sum())
        self._q_rid[:k] = rids[keep]
        self._q_entry[:k] = ents[keep]
        self._q_stamp[:k] = stamps[keep]
        self._q_head = 0
        self._q_len = k

    def _q_append_one(self, rid: int, entry: int, stamp: int) -> None:
        if self._q_len + 1 > self._q_rid.shape[0]:
            self._q_reserve(1)
        i = self._q_len
        self._q_rid[i] = rid
        self._q_entry[i] = entry
        self._q_stamp[i] = stamp
        self._q_len = i + 1

    def _q_reserve(self, k: int) -> None:
        cap = self._q_rid.shape[0]
        if self._q_len + k > cap:
            self._q_compact()
            if self._q_len + k > cap:
                new_cap = max(self._q_len + k, cap * 2)
                for attr in ("_q_rid", "_q_entry", "_q_stamp"):
                    old = getattr(self, attr)
                    grown = np.zeros(new_cap, dtype=np.int64)
                    grown[:self._q_len] = old[:self._q_len]
                    setattr(self, attr, grown)

    def _q_append(self, rid: int, entries: np.ndarray,
                  stamps: np.ndarray) -> None:
        k = entries.shape[0]
        if k == 0:
            return
        self._q_reserve(k)
        s = slice(self._q_len, self._q_len + k)
        self._q_rid[s] = rid
        self._q_entry[s] = entries
        self._q_stamp[s] = stamps
        self._q_len += k

    # -- writeback -----------------------------------------------------------
    def _persist_entries(self, r: _Region, entries: np.ndarray) -> int:
        """Copy the given entries' truth spans into the image; returns the
        (clipped) byte count, matching the reference's per-entry charges."""
        self.store.mark_image_dirty(r.name)
        ents = np.sort(entries)
        nbytes = int(r.entry_nbytes(ents).sum())
        n = r.truth.shape[0]
        if int(ents[-1]) - int(ents[0]) + 1 == ents.size:  # contiguous
            lo = int(ents[0]) * r.epe
            hi = min((int(ents[-1]) + 1) * r.epe, n)
            r.image[lo:hi] = r.truth[lo:hi]
        else:
            idx = (ents[:, None] * r.epe +
                   np.arange(r.epe, dtype=np.int64)).ravel()
            idx = idx[idx < n]
            r.image[idx] = r.truth[idx]
        return nbytes

    # -- eviction ------------------------------------------------------------
    def _evict_until(self, target: int, acc: _OpAcc,
                     cur: Optional[_Region] = None, e_lo: int = 0,
                     e_hi: int = 0, dyn_pos: int = 0,
                     miss: Optional[np.ndarray] = None) -> None:
        """Pop oldest live slots until occupancy <= target (or the queue
        empties). When popping evicts a not-yet-touched entry of the
        in-flight range (``cur`` region, entries >= e_lo+dyn_pos), the
        entry is flagged in ``miss`` so the caller re-touches it as a
        miss — the reference's intra-op eviction interleaving."""
        while self._weight_used > target and self._q_head < self._q_len:
            hi = min(self._q_head + _EVICT_CHUNK, self._q_len)
            sl = slice(self._q_head, hi)
            rids = self._q_rid[sl]
            ents = self._q_entry[sl]
            stamps = self._q_stamp[sl]
            valid, wts = self._validity(rids, ents, stamps)
            cum = np.cumsum(wts)
            need = self._weight_used - target
            cut = int(np.searchsorted(cum, need, side="left"))
            consume = (hi - self._q_head) if cut >= cum.size else cut + 1
            crids = rids[:consume]
            cents = ents[:consume]
            cvalid = valid[:consume]
            for rid in np.unique(crids[cvalid]):
                r = self._by_rid[int(rid)]
                es = cents[(crids == rid) & cvalid]
                if cur is not None and r is cur and miss is not None:
                    dyn = es[(es >= e_lo + dyn_pos) & (es < e_hi)]
                    if dyn.size:
                        miss[dyn - e_lo] = True
                d = es[r.dirty[es]]
                if d.size:
                    acc.wb_bytes += self._persist_entries(r, d)
                r.present[es] = False
                r.dirty[es] = False
                freed = es.size * r.w
                acc.evict_lines += freed
                self._weight_used -= freed
            self._q_head += consume

    def _persist_one(self, r: _Region, entry: int) -> int:
        lo = entry * r.epe
        hi = min(lo + r.epe, r.truth.shape[0])
        r.image[lo:hi] = r.truth[lo:hi]
        self.store.mark_image_dirty(r.name)
        return (hi - lo) * r.itemsize

    # -- program-visible operations ------------------------------------------
    def _op_one(self, r: _Region, entry: int, is_write: bool) -> None:
        """Single-entry fast path: plain-int state updates, no array
        temporaries — dominant in pointer-chasing traffic (XSBench's
        binary-search probes, per-lookup counters)."""
        stamp = self._clock
        self._clock = stamp + 1
        if r.present[entry]:
            if self.cfg.replacement != "fifo":
                r.stamp[entry] = stamp
                self._q_append_one(r.rid, entry, stamp)
            if is_write:
                r.dirty[entry] = True
            return
        r.present[entry] = True
        r.dirty[entry] = is_write
        r.stamp[entry] = stamp
        self._q_append_one(r.rid, entry, stamp)
        self._weight_used += r.w
        acc = _OpAcc()
        if self._weight_used > self.capacity_lines:
            self._evict_until(max(self.capacity_lines, r.w), acc)
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes,
            read_bytes=0 if is_write else r.epe * r.itemsize,
            evict_lines=acc.evict_lines)

    def _op(self, name: str, lo: int, hi: int, is_write: bool) -> None:
        r = self._regions[name]
        if hi <= lo:
            return
        e_lo = lo // r.epe
        e_hi = (hi - 1) // r.epe + 1
        if e_hi - e_lo == 1:
            self._op_one(r, e_lo, is_write)
            return
        m = e_hi - e_lo
        t0 = self._clock
        self._clock += m
        ents = np.arange(e_lo, e_hi, dtype=np.int64)
        miss = ~r.present[ents]
        acc = _OpAcc()
        fifo = self.cfg.replacement == "fifo"
        p = 0
        while p < m:
            if miss[p]:
                nxt = np.flatnonzero(~miss[p:])
                t = m if nxt.size == 0 else p + int(nxt[0])
                run = ents[p:t]
                stamps = t0 + np.arange(p, t, dtype=np.int64)
                r.present[run] = True
                r.dirty[run] = is_write
                r.stamp[run] = stamps
                self._q_append(r.rid, run, stamps)
                self._weight_used += (t - p) * r.w
                if not is_write:
                    acc.read_entries += t - p
                if self._weight_used > self.capacity_lines:
                    # target C normally; a single entry heavier than the
                    # whole cache leaves exactly the newest entry resident
                    self._evict_until(max(self.capacity_lines, r.w), acc,
                                      cur=r, e_lo=e_lo, e_hi=e_hi,
                                      dyn_pos=t, miss=miss)
                p = t
            else:
                nxt = np.flatnonzero(miss[p:])
                t = m if nxt.size == 0 else p + int(nxt[0])
                run = ents[p:t]
                if not fifo:  # LRU re-touch; FIFO hits keep their slot
                    stamps = t0 + np.arange(p, t, dtype=np.int64)
                    r.stamp[run] = stamps
                    self._q_append(r.rid, run, stamps)
                if is_write:
                    r.dirty[run] = True
                p = t
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes,
            read_bytes=acc.read_entries * r.epe * r.itemsize,
            evict_lines=acc.evict_lines)

    def write(self, name: str, lo: int, hi: int) -> None:
        self._op(name, lo, hi, is_write=True)

    def read(self, name: str, lo: int, hi: int) -> None:
        self._op(name, lo, hi, is_write=False)

    def flush(self, name: str, lo: int = 0, hi: Optional[int] = None) -> None:
        r = self._regions[name]
        if hi is None:
            hi = r.truth.shape[0]
        if hi <= lo:
            return
        e_lo = lo // r.epe
        e_hi = (hi - 1) // r.epe + 1
        if e_hi - e_lo == 1:  # scalar fast path (counter/line flushes)
            entry = e_lo
            wb_bytes = 0
            clean = 0
            if r.present[entry]:
                self._weight_used -= r.w
                r.present[entry] = False
                if r.dirty[entry]:
                    r.dirty[entry] = False
                    wb_bytes = self._persist_one(r, entry)
                else:
                    clean = 1
            else:
                clean = 1
            self.store.stats.charge_batch(
                self.cfg, write_bytes=wb_bytes, flush_lines=r.w,
                clean_flush_bytes=clean * r.epe * r.itemsize)
            return
        ents = np.arange(e_lo, e_hi, dtype=np.int64)
        pres = r.present[ents]
        d = ents[pres & r.dirty[ents]]
        wb_bytes = self._persist_entries(r, d) if d.size else 0
        clean = ents.size - int(d.size)
        self._weight_used -= int(pres.sum()) * r.w
        r.present[ents] = False
        r.dirty[ents] = False
        self.store.stats.charge_batch(
            self.cfg, write_bytes=wb_bytes, flush_lines=ents.size * r.w,
            clean_flush_bytes=clean * r.epe * r.itemsize)

    def drain(self) -> None:
        acc = _OpAcc()
        self._evict_until(0, acc)
        self._q_head = 0
        self._q_len = 0
        self.store.stats.charge_batch(
            self.cfg, write_bytes=acc.wb_bytes, evict_lines=acc.evict_lines)

    def _dirty_eviction_order(self):
        """Dirty entries as (name, entry) in replacement order: live
        queue slots front-to-back — exactly the reference OrderedDict's
        iteration order (stale slots are skipped by validity)."""
        sl = slice(self._q_head, self._q_len)
        rids = self._q_rid[sl]
        ents = self._q_entry[sl]
        valid, _ = self._validity(rids, ents, self._q_stamp[sl])
        out = []
        for i in np.flatnonzero(valid):
            r = self._by_rid[int(rids[i])]
            e = int(ents[i])
            if r.dirty[e]:
                out.append((r.name, e))
        return out

    def crash(self, survival: Optional[LineSurvival] = None) -> int:
        # fraction 0.0 selects nothing: skip the per-slot queue walk on
        # the dense-sweep hot path (crash is once per measure cell)
        torn = survival is not None and survival.fraction > 0.0
        if torn and survival.granularity == "word":
            return self._crash_words(survival)
        survivors = select_survivors(
            self._dirty_eviction_order() if torn else (), survival)
        if survivors:
            nbytes = 0
            by_region: Dict[str, list] = {}
            for name, entry in survivors:
                by_region.setdefault(name, []).append(entry)
            for name, entries in by_region.items():
                nbytes += self._persist_entries(
                    self._regions[name], np.asarray(entries, dtype=np.int64))
            self.store.stats.note_torn_persist(nbytes, len(survivors))
        lost = -len(survivors)
        for r in self._regions.values():
            lost += int((r.present & r.dirty).sum())
            r.present[:] = False
            r.dirty[:] = False
        self._weight_used = 0
        self._q_head = 0
        self._q_len = 0
        return lost

    def _crash_words(self, survival: LineSurvival) -> int:
        """Word-granularity torn crash — mirrors the reference path:
        surviving word spans persist through ``store.persist`` (which
        handles image epochs), an entry counts as lost only if none of
        its words made it."""
        dirty = self._dirty_eviction_order()
        words = select_survivor_words(dirty, survival, self.entry_geometry)
        if words:
            nbytes = 0
            for name, _entry, lo, hi in words:
                r = self._regions[name]
                self.store.persist(name, lo, hi, r.truth)
                nbytes += (hi - lo) * r.itemsize
            self.store.stats.note_torn_persist(nbytes, len(words))
        touched = {(name, entry) for name, entry, _lo, _hi in words}
        lost = len(dirty) - len(touched)
        for r in self._regions.values():
            r.present[:] = False
            r.dirty[:] = False
        self._weight_used = 0
        self._q_head = 0
        self._q_len = 0
        return lost

    # -- snapshot / fork ----------------------------------------------------
    def snapshot(self) -> object:
        """Capture bitmaps/stamps per region plus the live queue slice.
        Only the [head, len) window is copied — dead slots ahead of the
        head are irrelevant to replay, so snapshots stay proportional to
        live state, not queue history."""
        sl = slice(self._q_head, self._q_len)
        snap = {
            "regions": {name: (r.present.copy(), r.dirty.copy(),
                               r.stamp.copy())
                        for name, r in self._regions.items()},
            "clock": self._clock,
            "weight_used": self._weight_used,
            "queue": (self._q_rid[sl].copy(), self._q_entry[sl].copy(),
                      self._q_stamp[sl].copy()),
        }
        for present, dirty, stamp in snap["regions"].values():
            present.flags.writeable = False
            dirty.flags.writeable = False
            stamp.flags.writeable = False
        for arr in snap["queue"]:
            arr.flags.writeable = False
        return snap

    def restore(self, snap: object) -> None:
        if set(snap["regions"]) != set(self._regions):
            raise ValueError(
                "snapshot regions do not match this backend's regions "
                "(snapshots only restore into the instance that took them)")
        for name, (present, dirty, stamp) in snap["regions"].items():
            r = self._regions[name]
            r.present[:] = present
            r.dirty[:] = dirty
            r.stamp[:] = stamp
        self._clock = snap["clock"]
        self._weight_used = snap["weight_used"]
        q_rid, q_entry, q_stamp = snap["queue"]
        k = q_rid.shape[0]
        if self._q_rid.shape[0] < k:
            cap = max(k, 2 * self._q_rid.shape[0])
            self._q_rid = np.zeros(cap, dtype=np.int64)
            self._q_entry = np.zeros(cap, dtype=np.int64)
            self._q_stamp = np.zeros(cap, dtype=np.int64)
        self._q_rid[:k] = q_rid
        self._q_entry[:k] = q_entry
        self._q_stamp[:k] = q_stamp
        self._q_head = 0
        self._q_len = k

    # -- introspection ------------------------------------------------------
    @property
    def occupancy_lines(self) -> int:
        return self._weight_used

    def dirty_entries(self, name: str) -> np.ndarray:
        r = self._regions[name]
        return np.flatnonzero(r.present & r.dirty).astype(np.int64)

    def has_dirty(self, name: str) -> bool:
        r = self._regions[name]
        return bool(np.any(r.present & r.dirty))

    def dirty_eviction_order(self):
        return self._dirty_eviction_order()

    def entry_geometry(self, name: str):
        r = self._regions[name]
        return r.epe, r.truth.shape[0], r.itemsize

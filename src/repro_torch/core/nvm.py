"""Emulated NVM + volatile cache + crash semantics (paper §III.A).

The paper studies crash consistence with a PIN-based emulator: program
loads/stores go through a configurable LRU cache sitting in front of
NVM-based main memory; on a crash, cache contents are lost and only the
NVM image survives. This module reproduces that machinery in pure
numpy at cache-line granularity, plus a bandwidth/latency *cost model*
(Quartz-style: NVM bandwidth = DRAM/8 by default) so mechanism overheads
can be charged in modeled seconds independent of host speed.

Three layers:

  NVMStore        persistent image (survives ``crash()``) + traffic stats
  MemoryBackend   volatile write-back cache emulation over the store —
                  pluggable (repro_torch.core.backends): an exact per-entry
                  ``reference`` oracle, a batched ``vectorized``
                  default, and a torch ``device`` backend — all with
                  identical semantics
  CrashEmulator   couples program "truth" arrays with backend+store;
                  provides ``crash()`` / ``recover()``, region
                  allocation, and the program-visible read/write/flush
                  facade consumers go through

Granularity: a *line* is ``line_bytes`` of a region's flattened buffer.
Program views ("truth") always hold the latest values — the backend
tracks *which lines would still be dirty in a volatile cache*, i.e.
which bytes have NOT yet reached NVM. ``crash()`` discards exactly
those bytes.

Cost model notes (paper §II): flushing a clean or absent line costs the
same order as flushing a dirty one, so ``flush`` charges per-line cost
unconditionally. CLFLUSH also invalidates, so flushed lines leave the
cache. The full set of cost-model invariants backends must uphold is
documented in backends/base.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .backends import corrupt_image_words, make_backend
from .backends.reference import ReferenceLRUBackend

__all__ = [
    "NVMConfig",
    "TrafficStats",
    "NVMStore",
    "VolatileCache",
    "CrashEmulator",
    "EmuSnapshot",
    "NestedCrashFault",
]


class NestedCrashFault(RuntimeError):
    """Raised by the emulator when an armed nested-crash trap fires:
    power failed *again*, mid-recovery. Strategies must let it propagate
    (recovery code never catches it); the scenario layer crashes the emulator a
    second time and retries recovery — which is what makes re-entrancy
    a tested property instead of an assumption."""

# Back-compat alias: the pre-backend cache class lives on as the
# reference backend (same semantics, entry-at-a-time OrderedDict).
VolatileCache = ReferenceLRUBackend


def _default_backend() -> str:
    return os.environ.get("REPRO_NVM_BACKEND", "vectorized")


@dataclasses.dataclass(frozen=True)
class NVMConfig:
    """Cache geometry + bandwidth cost model + backend selection.

    Defaults mirror the paper's setup: 32 MB cache (their DRAM cache size;
    we use it as the volatile-cache capacity for crash experiments can be
    overridden per-test), 64 B lines, NVM bandwidth = DRAM/8 (Quartz
    configuration), DRAM ~25.6 GB/s (2×DDR3-1600 as on their Xeon E5606
    box), local HDD ~120 MB/s for checkpoint baselines.
    """

    cache_bytes: int = 32 * 1024 * 1024
    dram_cache_bytes: int = 32 * 1024 * 1024  # NVM/DRAM system's DRAM cache
    line_bytes: int = 64
    dram_bw: float = 25.6e9          # B/s
    nvm_read_bw: float = 25.6e9 / 8  # B/s (paper: up to 8x lower bandwidth)
    nvm_write_bw: float = 25.6e9 / 8
    hdd_bw: float = 120e6            # B/s, local hard drive baseline
    flush_latency: float = 100e-9    # s per CLFLUSH instruction issue
    nvm_same_as_dram: bool = False   # the paper's optimistic "NVM-only" config
    # "lru": fully-associative LRU (paper's emulator default).
    # "fifo": insertion-order replacement — models the conflict evictions a
    # real set-associative cache inflicts on *hot* lines, which is what
    # leaves XSBench's counters stale-by-different-amounts in NVM (Fig. 10).
    replacement: str = "lru"
    # emulation backend: "vectorized" (default), "reference" (oracle), or
    # "device" (forward pass on the torch device; raises without a card
    # unless the CPU is selected) — all byte/stat-identical; overridable
    # via the REPRO_NVM_BACKEND environment variable.
    backend: str = dataclasses.field(default_factory=_default_backend)

    @property
    def read_bw(self) -> float:
        return self.dram_bw if self.nvm_same_as_dram else self.nvm_read_bw

    @property
    def write_bw(self) -> float:
        return self.dram_bw if self.nvm_same_as_dram else self.nvm_write_bw


@dataclasses.dataclass
class TrafficStats:
    """Byte-accurate traffic + modeled-time accounting."""

    nvm_bytes_written: int = 0
    nvm_bytes_read: int = 0
    lines_flushed: int = 0
    lines_evicted: int = 0
    # writebacks that were in flight when power failed (torn crashes
    # with a LineSurvival spec): they reach the image but are never
    # charged to modeled_seconds — the program did not wait for them
    torn_bytes_persisted: int = 0
    torn_entries_persisted: int = 0
    modeled_seconds: float = 0.0

    def charge_write(self, nbytes: int, cfg: NVMConfig) -> None:
        self.nvm_bytes_written += nbytes
        self.modeled_seconds += nbytes / cfg.write_bw

    def charge_read(self, nbytes: int, cfg: NVMConfig) -> None:
        self.nvm_bytes_read += nbytes
        self.modeled_seconds += nbytes / cfg.read_bw

    def charge_flush_issue(self, nlines: int, cfg: NVMConfig) -> None:
        self.lines_flushed += nlines
        self.modeled_seconds += nlines * cfg.flush_latency

    def charge_batch(self, cfg: NVMConfig, *, write_bytes: int = 0,
                     read_bytes: int = 0, flush_lines: int = 0,
                     clean_flush_bytes: int = 0, evict_lines: int = 0) -> None:
        """Apply one program-visible operation's aggregated charges.

        Backends accumulate integer byte/line counts per operation and
        charge exactly once through here, in this fixed order — which is
        what makes TrafficStats (including the float ``modeled_seconds``)
        bit-identical across backends for identical traces.
        """
        if write_bytes:
            self.charge_write(write_bytes, cfg)
        if read_bytes:
            self.charge_read(read_bytes, cfg)
        if flush_lines:
            self.charge_flush_issue(flush_lines, cfg)
        if clean_flush_bytes:
            # clean/absent flushes still occupy the memory pipeline
            self.modeled_seconds += clean_flush_bytes / cfg.write_bw
        self.lines_evicted += evict_lines

    def note_torn_persist(self, nbytes: int, entries: int) -> None:
        """Record the dirty-entry writebacks a torn crash completed
        before power loss (backends call this at most once per crash).
        Pure bookkeeping: no modeled time is charged."""
        self.torn_bytes_persisted += nbytes
        self.torn_entries_persisted += entries

    def snapshot(self) -> "TrafficStats":
        return dataclasses.replace(self)

    def delta_since(self, prev: "TrafficStats") -> "TrafficStats":
        return TrafficStats(
            nvm_bytes_written=self.nvm_bytes_written - prev.nvm_bytes_written,
            nvm_bytes_read=self.nvm_bytes_read - prev.nvm_bytes_read,
            lines_flushed=self.lines_flushed - prev.lines_flushed,
            lines_evicted=self.lines_evicted - prev.lines_evicted,
            torn_bytes_persisted=(self.torn_bytes_persisted
                                  - prev.torn_bytes_persisted),
            torn_entries_persisted=(self.torn_entries_persisted
                                    - prev.torn_entries_persisted),
            modeled_seconds=self.modeled_seconds - prev.modeled_seconds,
        )


class NVMStore:
    """The persistent image: named flat byte-addressable regions.

    ``image[name]`` is the array of bytes that would survive a crash.
    Backends copy truth spans in via :meth:`persist` (uncharged — the
    backend aggregates and charges traffic per operation, see
    ``TrafficStats.charge_batch``).
    """

    def __init__(self, cfg: NVMConfig):
        self.cfg = cfg
        self.image: Dict[str, np.ndarray] = {}
        self.meta: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
        self.stats = TrafficStats()
        # monotonic per-region mutation counters: every image change bumps,
        # so equal epochs mean equal contents — the copy-on-write predicate
        # snapshots use to share/skip unchanged regions (mostly the big
        # read-only inputs: CSR matrices, ABFT-encoded operands, MC grids)
        self.image_epoch: Dict[str, int] = {}

    def alloc(self, name: str, shape: Tuple[int, ...], dtype) -> None:
        if name in self.image:
            raise KeyError(f"region {name!r} already allocated")
        dt = np.dtype(dtype)
        self.image[name] = np.zeros(int(np.prod(shape)), dtype=dt)
        self.meta[name] = (tuple(shape), dt)
        self.image_epoch[name] = 0

    def free(self, name: str) -> None:
        self.image.pop(name, None)
        self.meta.pop(name, None)
        self.image_epoch.pop(name, None)

    def mark_image_dirty(self, name: str) -> None:
        """Record an image mutation done outside :meth:`persist` (the
        vectorized backend's direct writebacks, undo-log rollbacks)."""
        self.image_epoch[name] += 1

    def persist(self, name: str, lo: int, hi: int, src: np.ndarray) -> None:
        """Copy src[lo:hi) (flat element indices) into the image."""
        self.image[name][lo:hi] = src[lo:hi]
        self.image_epoch[name] += 1

    def read_view(self, name: str) -> np.ndarray:
        """The surviving (post-crash) contents, shaped. No cost charged:
        recovery-time reads are charged by the recovery code itself."""
        shape, _ = self.meta[name]
        return self.image[name].reshape(shape)


@dataclasses.dataclass(frozen=True)
class EmuSnapshot:
    """Full emulator state captured by :meth:`CrashEmulator.snapshot`.

    Immutable (arrays are marked read-only): one snapshot can seed any
    number of forked executions. Covers everything a replayed suffix
    can observe — program truth, the persistent NVM image, traffic
    stats (including the float ``modeled_seconds``), the backend's
    volatile-cache state, and the crashed flag.

    Truth/image arrays are copy-on-write at region granularity: a
    region whose mutation epoch is unchanged since the previous
    snapshot SHARES that snapshot's frozen array instead of recopying
    it, and :meth:`CrashEmulator.restore` skips regions whose live
    epoch still equals the snapshot's — so repeated snapshot/fork
    cycles pay O(changed state), not O(total footprint).
    """

    truth: Dict[str, np.ndarray]
    image: Dict[str, np.ndarray]
    truth_epoch: Dict[str, int]
    image_epoch: Dict[str, int]
    stats: TrafficStats
    backend: object
    crashed: bool
    # regions with a rollback-induced truth/image divergence pending at
    # capture time (empty in normal step-boundary snapshots)
    truth_desynced: frozenset = frozenset()


class CrashEmulator:
    """Couples program arrays with the backend+NVM pair (paper's crash
    emulator). Allocate regions, compute on their ``.view`` arrays through
    :class:`PersistentRegion` (see regions.py), then ``crash()`` to lose
    volatile state and ``post_crash_view()`` to inspect what survived.

    This is a thin facade: cache semantics live in the selected
    :class:`~repro_torch.core.backends.MemoryBackend`
    (``cfg.backend`` — "vectorized" by default, "reference" for oracle
    runs).
    """

    def __init__(self, cfg: Optional[NVMConfig] = None):
        self.cfg = cfg or NVMConfig()
        self.store = NVMStore(self.cfg)
        self.backend = make_backend(self.cfg.backend, self.store, self.cfg)
        self._truth: Dict[str, np.ndarray] = {}
        # truth-side mutation epochs (see NVMStore.image_epoch); every
        # content change flows through write()/crash()/restore()/
        # resync_truth(), each of which bumps
        self._truth_epoch: Dict[str, int] = {}
        # copy-on-write caches: name -> (epoch, frozen copy at that epoch)
        self._cow_truth: Dict[str, Tuple[int, np.ndarray]] = {}
        self._cow_image: Dict[str, Tuple[int, np.ndarray]] = {}
        # regions whose image was mutated from data NOT sourced from
        # truth (undo-log rollback): truth != image there even with a
        # clean cache, so crash() must reload them (see crash())
        self._truth_desynced: set = set()
        self.crashed = False
        # nested-crash trap: when armed (int), every completed emulator
        # action during recovery decrements it; reaching zero raises
        # NestedCrashFault. Never part of snapshots — it is armed only
        # transiently around a recovery attempt (see arm_nested_crash)
        self._nested_trap: Optional[int] = None

    # back-compat: the pre-backend attribute name for the cache layer
    @property
    def cache(self):
        return self.backend

    # region management ------------------------------------------------------
    def alloc(self, name: str, shape, dtype=np.float64,
              init: Optional[np.ndarray] = None, sector_lines: int = 1):
        from .regions import PersistentRegion  # local to avoid cycle

        shape = tuple(int(s) for s in shape)
        self.store.alloc(name, shape, dtype)
        truth = np.zeros(int(np.prod(shape)), dtype=np.dtype(dtype))
        self._truth[name] = truth
        self._truth_epoch[name] = 0
        self.backend.register(name, truth, sector_lines=sector_lines)
        region = PersistentRegion(self, name, shape, np.dtype(dtype))
        if init is not None:
            region[...] = np.asarray(init, dtype=dtype).reshape(shape)
        return region

    def free(self, name: str) -> None:
        self.backend.unregister(name)
        self.store.free(name)
        self._truth.pop(name, None)
        self._truth_epoch.pop(name, None)
        self._cow_truth.pop(name, None)
        self._cow_image.pop(name, None)
        self._truth_desynced.discard(name)

    # nested-crash trap (fault injection during recovery) ----------------------
    def arm_nested_crash(self, after_actions: int) -> None:
        """Arm the trap: the ``after_actions``-th completed emulator
        action from now raises :class:`NestedCrashFault` — power fails
        again while recovery is mutating state. An *action* is any
        completed facade operation (write/read/flush/drain), a
        recovery-path truth resync, or an undo-record application: the
        units in which a recovery procedure makes externally-visible
        progress, so the trap lands between two of them, exactly where
        a real second power loss could."""
        if after_actions < 1:
            raise ValueError("nested crash must fire after >= 1 actions")
        self._nested_trap = int(after_actions)

    def disarm_nested_crash(self) -> None:
        self._nested_trap = None

    def _trap_tick(self) -> None:
        if self._nested_trap is None:
            return
        self._nested_trap -= 1
        if self._nested_trap <= 0:
            self._nested_trap = None
            raise NestedCrashFault(
                "nested crash: power failed during recovery")

    # program-visible operations (facade over the backend) --------------------
    def write(self, name: str, lo: int, hi: int) -> None:
        """Program stored truth[lo:hi) of ``name``."""
        self._truth_epoch[name] += 1
        self.backend.write(name, lo, hi)
        self._trap_tick()

    def read(self, name: str, lo: int, hi: int) -> None:
        """Program loaded truth[lo:hi) of ``name``."""
        self.backend.read(name, lo, hi)
        self._trap_tick()

    def flush(self, name: str, lo: int = 0, hi: Optional[int] = None) -> None:
        """CLFLUSH the lines covering truth[lo:hi) of ``name``."""
        self.backend.flush(name, lo, hi)
        self._trap_tick()

    def drain(self) -> None:
        """Write back everything (normal program termination)."""
        self.backend.drain()
        self._trap_tick()

    # crash / recovery ---------------------------------------------------------
    def crash(self, survival=None) -> int:
        """Drop the volatile cache; reload every truth array from the NVM
        image (the program must now see only what survived).

        ``survival`` (a :class:`~repro_torch.core.backends.LineSurvival`)
        makes the crash *torn*: a deterministic subset of the dirty
        entries is written back to the image first — the crash-state
        space EasyCrash samples and WITCHER enumerates — instead of the
        all-or-nothing worst case."""
        # truth diverges from the image exactly where unwritten-back
        # dirty entries sit — plus any region whose image was rewritten
        # from non-truth data (undo-log rollback; see
        # note_image_divergence). Reloading only those regions makes a
        # crash O(diverged footprint), which dense measure-mode sweeps
        # (one crash per cell) rely on when big read-only inputs sit in
        # the emulator. Torn survivors only ever *narrow* the diverged
        # span (image moves toward truth), so the same region list is
        # still the superset to reload.
        changed = [name for name in self._truth
                   if name in self._truth_desynced
                   or self.backend.has_dirty(name)]
        lost = self.backend.crash(survival)
        for name in changed:
            self._truth[name][:] = self.store.image[name]
            self._truth_epoch[name] += 1
        self._truth_desynced.clear()
        self.crashed = True
        return lost

    def post_crash_view(self, name: str) -> np.ndarray:
        return self.store.read_view(name)

    def resync_truth(self, name: str) -> None:
        """Reload one region's truth from the (possibly rolled-back) NVM
        image — the undo-log recovery path. Routed through the emulator
        so snapshot epochs stay coherent."""
        self._truth[name][:] = self.store.image[name]
        self._truth_epoch[name] += 1
        self._truth_desynced.discard(name)
        self._trap_tick()

    def apply_undo(self, name: str, lo: int, hi: int,
                   old: np.ndarray) -> None:
        """Apply one undo-log record: rewrite image[lo:hi) of ``name``
        with pre-transaction values (element indices). The single
        emulator-mediated path for rollback image writes — epoch bump
        and divergence note happen BEFORE the nested-crash trap can
        fire, so a re-crash between two undo records still sees a
        coherent image/snapshot state and reloads truth from it."""
        self.store.image[name][lo:hi] = old
        self.store.mark_image_dirty(name)
        # the image now holds pre-tx values truth never saw — a further
        # crash() must reload truth even with a clean cache
        self.note_image_divergence(name)
        self.store.stats.charge_write(old.nbytes, self.cfg)
        self._trap_tick()

    def inject_media_fault(self, fault, region_names=None):
        """Silently corrupt the post-crash NVM image (a
        :class:`~repro_torch.core.backends.MediaFault`): seeded word poisoning
        or bit flips via the shared, backend-independent
        :func:`~repro_torch.core.backends.corrupt_image_words`. Only valid on
        a crashed emulator — media faults model what recovery *finds*,
        not in-flight corruption. Truth is reloaded for the affected
        regions (post-crash truth mirrors the image); nothing is charged
        (the hardware lied for free). Returns the corrupted
        ``(name, lo, hi)`` byte spans."""
        if not self.crashed:
            raise RuntimeError(
                "inject_media_fault requires a crashed emulator "
                "(call crash() first)")
        spans = corrupt_image_words(self.store.image, fault, region_names)
        for name in sorted({name for name, _lo, _hi in spans}):
            self.store.mark_image_dirty(name)
            self._truth[name][:] = self.store.image[name]
            self._truth_epoch[name] += 1
        return spans

    def note_image_divergence(self, name: str) -> None:
        """Record that ``name``'s NVM image was just rewritten from data
        NOT sourced from truth (undo-log rollback applying old values):
        truth != image there despite a clean cache. Without this, the
        clean-region fast path in :meth:`crash` would skip the reload
        if a second crash landed before :meth:`resync_truth`."""
        self._truth_desynced.add(name)

    # snapshot / fork ----------------------------------------------------------
    def snapshot(self) -> EmuSnapshot:
        """Capture the complete emulator state (truth arrays, NVM image,
        traffic stats, cache state) for later :meth:`restore`. The fork
        sweep engine uses this to evaluate many crash points off one
        shared prefix execution.

        Copy-on-write: regions whose mutation epoch is unchanged since
        the previous snapshot share that snapshot's frozen arrays.
        Mutating ``region.view`` directly bypasses epoch tracking the
        same way it bypasses cache accounting (regions.py) — all
        shipped workloads go through ``PersistentRegion.__setitem__``.
        """
        def _cow(arrays: Dict[str, np.ndarray], epochs: Dict[str, int],
                 cache: Dict[str, Tuple[int, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
            out = {}
            for name, arr in arrays.items():
                e = epochs[name]
                hit = cache.get(name)
                if hit is None or hit[0] != e:
                    c = arr.copy()
                    c.flags.writeable = False
                    cache[name] = hit = (e, c)
                out[name] = hit[1]
            return out

        return EmuSnapshot(
            truth=_cow(self._truth, self._truth_epoch, self._cow_truth),
            image=_cow(self.store.image, self.store.image_epoch,
                       self._cow_image),
            truth_epoch=dict(self._truth_epoch),
            image_epoch=dict(self.store.image_epoch),
            stats=self.store.stats.snapshot(),
            backend=self.backend.snapshot(),
            crashed=self.crashed,
            truth_desynced=frozenset(self._truth_desynced),
        )

    def restore(self, snap: EmuSnapshot) -> None:
        """Reset to a snapshot taken on this instance. In-place: every
        region keeps its identity (PersistentRegions, VersionedArrays
        and algorithm objects holding references stay valid). Regions
        whose epoch still matches the snapshot's are skipped — the big
        read-only inputs cost nothing to restore."""
        if set(snap.truth) != set(self._truth):
            raise ValueError(
                "snapshot regions do not match this emulator's regions "
                "(snapshots only restore into the instance that took them)")
        for name, arr in snap.truth.items():
            if self._truth_epoch[name] != snap.truth_epoch[name]:
                self._truth[name][:] = arr
                # epochs only move forward: a rewind could alias a cached
                # copy-on-write entry with different contents
                self._truth_epoch[name] += 1
        for name, arr in snap.image.items():
            if self.store.image_epoch[name] != snap.image_epoch[name]:
                self.store.image[name][:] = arr
                self.store.image_epoch[name] += 1
        self.store.stats = snap.stats.snapshot()
        self.backend.restore(snap.backend)
        self._truth_desynced = set(snap.truth_desynced)
        self.crashed = snap.crashed

    def truth_flat(self, name: str) -> np.ndarray:
        return self._truth[name]

    def truth_epoch(self, name: str) -> int:
        """Current truth-side mutation epoch of ``name``. Monotonic;
        equal epochs guarantee equal contents (the same copy-on-write
        predicate :meth:`snapshot` uses), so incremental consumers —
        the shadow-snapshot strategy's unchanged-region sharing — can
        skip recopying a region whose epoch they already hold."""
        return self._truth_epoch[name]

    # stats -------------------------------------------------------------------
    @property
    def stats(self) -> TrafficStats:
        return self.store.stats

    def modeled_seconds(self) -> float:
        return self.store.stats.modeled_seconds

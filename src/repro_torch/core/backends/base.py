"""The narrow protocol every NVM-cache emulation backend implements.

A backend models *which bytes of each registered region would still be
sitting dirty in a volatile CPU cache* — i.e. which bytes have NOT yet
reached the NVM image held by :class:`repro_torch.core.nvm.NVMStore`. The
program's latest values always live in the registered truth arrays;
backends only track occupancy/dirtiness metadata and copy truth spans
into the store's image on writeback.

Granularity: an *entry* covers ``sector_lines`` consecutive cache lines
of a region's flattened buffer (``sector_lines=1`` is exact per-line
tracking). Entries are weighted by their line count against the cache
capacity, so coarse sectors keep emulation cheap without losing the
capacity pressure that drives eviction behavior.

Cost-model invariants (every backend MUST uphold these so that modeled
mechanism overheads are backend-independent — see the paper §II/§III.A):

* evicting a dirty entry persists its clipped byte span at NVM write
  bandwidth and bumps ``lines_evicted`` by the entry's line weight,
  dirty or clean;
* a read miss charges one full entry (``elems_per_entry * itemsize``)
  at NVM read bandwidth;
* ``flush`` charges the CLFLUSH issue latency for every line in the
  range unconditionally (flushing clean or absent lines costs the same
  order as dirty ones), writes back dirty entries, and charges clean or
  absent entries one entry's bytes of write-pipeline occupancy;
* ``drain`` is a full eviction sweep: writebacks are charged and
  ``lines_evicted`` counts every drained entry;
* ``crash`` is free in modeled seconds: volatile contents simply
  vanish. A :class:`LineSurvival` spec makes the crash *torn* instead
  of all-or-nothing — a deterministic subset of the dirty entries is
  written back to the NVM image first (the writebacks that were
  already in flight when power failed), recorded via
  ``TrafficStats.note_torn_persist`` but never charged to
  ``modeled_seconds``;
* all charges for one program-visible operation are aggregated and
  applied through :meth:`TrafficStats.charge_batch` exactly once, so
  two backends replaying the same trace produce *identical* stats.

Line-survival selection is shared code (:func:`select_survivors`), so
the surviving subset — and therefore the post-crash NVM image — is
byte-identical between the reference and vectorized backends for the
same spec and dirty state (tests/test_torn_crashes.py enforces it on
randomized traces).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

__all__ = ["MemoryBackend", "OpAccumulator", "LineSurvival",
           "MediaFault", "corrupt_image_words",
           "select_survivors", "select_survivor_words", "entry_span",
           "word_spans", "WORD_BYTES"]

SURVIVAL_MODES = ("random", "eviction")
SURVIVAL_GRANULARITIES = ("line", "word")

# Sub-entry torn-write granularity: an 8-byte store is the natural
# failure-atomicity unit on persistent-memory hardware (WITCHER's
# sub-line crash states tear at machine-word boundaries, not cache-line
# boundaries).
WORD_BYTES = 8


@dataclasses.dataclass(frozen=True)
class LineSurvival:
    """Which dirty cache entries persist at a torn crash.

    ``fraction`` of the dirty entries (rounded to the nearest count)
    reach NVM before the lights go out; the rest vanish with the cache.

      mode="random"    a seeded uniform subset over the canonical
                       (region name, entry index) ordering — the
                       EasyCrash-style sampled crash state;
      mode="eviction"  the replacement-queue front persists first: the
                       entries the cache would have written back next
                       are exactly the ones that made it (WITCHER's
                       ordering-consistent crash states).

    Resolution is a pure function of (spec, dirty state): both backends
    derive the same survivor set from the same spec.

    ``granularity="word"`` tears at :data:`WORD_BYTES` boundaries inside
    each dirty entry instead of whole entries: the unit population
    becomes every machine word of every dirty entry (still in eviction
    order — an entry's words persist front-to-back within it), so the
    crash image can persist half a cache line (the WITCHER sub-line
    states a line-granularity model cannot produce).
    """

    fraction: float
    seed: int = 0
    mode: str = "random"
    granularity: str = "line"

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError("survival fraction must be in [0, 1]")
        if self.mode not in SURVIVAL_MODES:
            raise ValueError(f"unknown survival mode {self.mode!r} "
                             f"(choose from {SURVIVAL_MODES})")
        if self.granularity not in SURVIVAL_GRANULARITIES:
            raise ValueError(
                f"unknown survival granularity {self.granularity!r} "
                f"(choose from {SURVIVAL_GRANULARITIES})")

    def describe(self) -> str:
        base = f"{self.mode}:f{self.fraction:g}:s{self.seed}"
        # line granularity keeps the historical spelling byte-identical
        # (pinned by tests and serialized torn_survival fields)
        return base + (":word" if self.granularity == "word" else "")


def _select_units(units: Sequence[tuple],
                  survival: Optional[LineSurvival]) -> List[tuple]:
    """Survivor selection over an abstract unit population (dirty
    entries at line granularity, their words at word granularity).

    ``units`` is the population in replacement-queue order (front first
    — the next-to-be-written-back unit leads). ``survival=None`` (the
    classic all-or-nothing crash) selects nothing. The survivor count is
    ``round(fraction * n)`` (banker's rounding, as python's ``round``);
    "eviction" mode takes the queue-front prefix, "random" draws a
    seeded uniform subset over the canonical sorted unit ordering so the
    choice is independent of replacement state.
    """
    if survival is None or not units:
        return []
    n = len(units)
    k = int(round(survival.fraction * n))
    if k <= 0:
        return []
    if survival.mode == "eviction":
        return list(units[:k])
    canon = sorted(units)
    rng = np.random.default_rng(survival.seed)
    idx = rng.choice(n, size=k, replace=False)
    return [canon[i] for i in np.sort(idx)]


def select_survivors(eviction_order: Sequence[Tuple[str, int]],
                     survival: Optional[LineSurvival]
                     ) -> List[Tuple[str, int]]:
    """The one place the surviving dirty *entry* subset is chosen.

    ``eviction_order`` is every dirty entry as ``(region, entry)`` in
    replacement-queue order (front first — the next-to-be-evicted
    entry leads). See :func:`_select_units` for the selection rule;
    this is the ``granularity="line"`` path both backends call.
    """
    return _select_units(eviction_order, survival)


MEDIA_FAULT_KINDS = ("poison", "bitflip")


@dataclasses.dataclass(frozen=True)
class MediaFault:
    """Seeded silent media corruption of the persistent image.

    Models post-crash data corruption (EasyCrash's observation that
    restart safety is decided by *corrupted*, not merely truncated,
    state): ``words`` machine words (:data:`WORD_BYTES`-sized units of
    the NVM image) are corrupted after the crash image forms, with no
    traffic charged and no dirty-state interaction — the hardware lied,
    and nothing in the cache model saw it happen.

      kind="poison"   each selected word is overwritten with seeded
                      random bytes (a dead/poisoned line returning
                      garbage);
      kind="bitflip"  one seeded bit of each selected word flips (the
                      classic retention/ECC-escape fault).

    Selection and payloads are pure functions of (spec, image shape):
    :func:`corrupt_image_words` operates on the backend-independent
    image dict, so the corrupted image is byte-identical under the
    reference and vectorized backends by construction — the same
    contract ``select_survivors`` gives torn crashes.
    """

    words: int = 1
    seed: int = 0
    kind: str = "poison"

    def __post_init__(self):
        if self.words < 1:
            raise ValueError("fault words must be >= 1")
        if self.kind not in MEDIA_FAULT_KINDS:
            raise ValueError(f"unknown media-fault kind {self.kind!r} "
                             f"(choose from {MEDIA_FAULT_KINDS})")

    def describe(self) -> str:
        return f"{self.kind}:w{self.words}:s{self.seed}"


def corrupt_image_words(image, fault: MediaFault,
                        region_names: Optional[Sequence[str]] = None
                        ) -> List[Tuple[str, int, int]]:
    """Apply ``fault`` to the NVM image dict in place; returns the
    corrupted ``(name, lo, hi)`` byte spans (sorted canonical order).

    The unit population is every :data:`WORD_BYTES`-aligned byte span of
    every targeted region (``region_names`` restricts it; default = all
    regions), enumerated in sorted-name order so the selection — like
    :func:`_select_units`'s random mode — is canonical and
    backend-independent. When ``fault.words`` exceeds the population,
    every word is corrupted. Poison payloads are seeded random bytes,
    XORed with 0xFF if they happen to equal the current contents (a
    fault must *change* the word — a silent no-op would make detection
    gates vacuous); bitflips flip one seeded bit per word.
    """
    names = sorted(image) if region_names is None else sorted(region_names)
    units: List[Tuple[str, int, int]] = []
    for name in names:
        nbytes = image[name].nbytes
        for lo in range(0, nbytes, WORD_BYTES):
            units.append((name, lo, min(lo + WORD_BYTES, nbytes)))
    if not units:
        return []
    rng = np.random.default_rng(fault.seed)
    k = min(fault.words, len(units))
    idx = np.sort(rng.choice(len(units), size=k, replace=False))
    chosen = [units[i] for i in idx]
    for name, lo, hi in chosen:
        view = image[name].view(np.uint8)[lo:hi]
        if fault.kind == "poison":
            payload = rng.integers(0, 256, size=hi - lo, dtype=np.uint8)
            if np.array_equal(payload, view):
                payload = payload ^ np.uint8(0xFF)
            view[:] = payload
        else:  # bitflip
            byte = int(rng.integers(0, hi - lo))
            bit = int(rng.integers(0, 8))
            view[byte] ^= np.uint8(1 << bit)
    return chosen


def entry_span(entry: int, elems_per_entry: int, n_elems: int
               ) -> Tuple[int, int]:
    """Clipped [lo, hi) element span of one cache entry of a flattened
    region — the span a writeback persists (shared by both backends and
    the batched evaluators, so torn-byte accounting can never drift)."""
    lo = entry * elems_per_entry
    return lo, min(lo + elems_per_entry, n_elems)


def word_spans(entry: int, elems_per_entry: int, n_elems: int,
               itemsize: int) -> List[Tuple[int, int]]:
    """The :data:`WORD_BYTES`-sized element spans tiling one entry's
    clipped span, front first. Elements wider than a word get one span
    per element (a word can never split an element — region dtypes are
    at most 8 bytes wide)."""
    lo, hi = entry_span(entry, elems_per_entry, n_elems)
    epw = max(1, WORD_BYTES // itemsize)
    return [(w, min(w + epw, hi)) for w in range(lo, hi, epw)]


def select_survivor_words(eviction_order: Sequence[Tuple[str, int]],
                          survival: Optional[LineSurvival],
                          geometry) -> List[Tuple[str, int, int, int]]:
    """Word-granularity survivor selection: expand every dirty entry
    into its word spans (eviction order outer, front-to-back within an
    entry) and select over that population.

    ``geometry(name)`` returns ``(elems_per_entry, n_elems, itemsize)``
    for a region. Returns surviving ``(name, entry, lo, hi)`` element
    spans; the per-entry word index ordering makes random-mode
    selection canonical (sorted by (name, entry, lo))."""
    if survival is None or not eviction_order:
        return []
    units = []
    for name, entry in eviction_order:
        epe, n_elems, itemsize = geometry(name)
        for lo, hi in word_spans(entry, epe, n_elems, itemsize):
            units.append((name, entry, lo, hi))
    return _select_units(units, survival)


class OpAccumulator:
    """Per-operation charge accumulator (integers only).

    Backends fill one of these per program-visible operation and apply
    it through ``TrafficStats.charge_batch`` exactly once — keeping the
    charge arithmetic (and so the float ``modeled_seconds``) identical
    across backends.
    """

    __slots__ = ("wb_bytes", "evict_lines", "read_entries")

    def __init__(self):
        self.wb_bytes = 0
        self.evict_lines = 0
        self.read_entries = 0


@runtime_checkable
class MemoryBackend(Protocol):
    """Volatile-cache-over-NVM emulation strategy.

    Constructed as ``Backend(store, cfg)`` where ``store`` is the
    :class:`~repro_torch.core.nvm.NVMStore` holding the persistent image and
    traffic stats, and ``cfg`` the :class:`~repro_torch.core.nvm.NVMConfig`.
    """

    # -- region lifecycle --------------------------------------------------
    def register(self, name: str, truth_flat: np.ndarray,
                 sector_lines: int = 1) -> None:
        """Start tracking ``name``; ``truth_flat`` is the program-truth
        buffer whose spans will be persisted on writeback."""
        ...

    def unregister(self, name: str) -> None:
        """Drop all state for ``name`` without writing anything back."""
        ...

    # -- program-visible operations ---------------------------------------
    def write(self, name: str, lo: int, hi: int) -> None:
        """Program stored truth[lo:hi): allocate entries, mark dirty."""
        ...

    def read(self, name: str, lo: int, hi: int) -> None:
        """Program loaded truth[lo:hi): allocate entries (miss charges an
        NVM read), do not dirty."""
        ...

    def flush(self, name: str, lo: int = 0, hi=None) -> None:
        """CLFLUSH truth[lo:hi): write back dirty entries, invalidate."""
        ...

    def drain(self) -> None:
        """Write back everything (normal program termination)."""
        ...

    def crash(self, survival: Optional[LineSurvival] = None) -> int:
        """Power loss: volatile contents vanish. With a
        :class:`LineSurvival` spec, the selected dirty entries are
        written back to the NVM image first (torn crash) and reported
        through ``TrafficStats.note_torn_persist``. Returns #dirty
        entries lost (dirty minus survivors)."""
        ...

    # -- snapshot / fork ----------------------------------------------------
    def snapshot(self) -> object:
        """Capture the backend's volatile-cache state (occupancy, dirty
        sets, replacement order) as an opaque, immutable value.

        The snapshot must be restorable any number of times into the
        *same* backend instance (same registered regions), and a
        restored backend must replay any subsequent trace with charges,
        images, and eviction decisions bit-identical to a from-scratch
        run of prefix+trace — the contract the fork sweep engine and
        tests/test_backend_equivalence.py rely on."""
        ...

    def restore(self, snap: object) -> None:
        """Reset the cache state to a value captured by :meth:`snapshot`
        on this instance. Registered truth arrays are NOT touched —
        callers restore them separately (see CrashEmulator.restore)."""
        ...

    # -- introspection ------------------------------------------------------
    @property
    def occupancy_lines(self) -> int:
        """Line-weighted cache occupancy."""
        ...

    def dirty_entries(self, name: str) -> np.ndarray:
        """Sorted entry indices of ``name`` currently dirty in cache."""
        ...

    def has_dirty(self, name: str) -> bool:
        """Whether ANY entry of ``name`` is dirty in cache — the cheap
        predicate crash() uses per region per cell (dense measure-mode
        sweeps crash thousands of times; materializing the index array
        of every clean region there is pure waste)."""
        ...

    def dirty_eviction_order(self) -> List[Tuple[str, int]]:
        """Every dirty entry as ``(region, entry)`` in replacement-queue
        order (front = next victim) — the exact ``eviction_order`` input
        :func:`select_survivors` consumes at crash time. The batched
        sweep engine captures this alongside snapshots so survivor
        selection can replay host-side without re-running ``crash()``."""
        ...

    def entry_geometry(self, name: str) -> Tuple[int, int, int]:
        """``(elems_per_entry, n_elems, itemsize)`` for a registered
        region — the span arithmetic shared with :func:`entry_span` /
        :func:`word_spans`."""
        ...

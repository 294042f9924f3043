"""Declarative crash plans — *where* a run dies, separated from *what*
runs and *how* it persists.

EasyCrash-style systematic crash-scenario sweeps need crash points to be
first-class values that can be enumerated, seeded, and serialized, not
``crash_at=...`` kwargs threaded through every driver. A
:class:`CrashPlan` names a family of crash points against an abstract
step axis; :meth:`CrashPlan.resolve` grounds it against a concrete
workload (which knows its step count and phase layout) into a list of
:class:`CrashPoint` s.

Supported kinds:

  no_crash()             run to completion
  at_step(k)             crash after step k completes (and, unless
                         torn, after the strategy's persistence hook
                         for step k ran)
  at_phase(name, i)      crash after the i-th step of a named workload
                         phase ("loop1" / "loop2" for ABFT-MM)
  at_fraction(f)         crash after step floor(f * (n_steps - 1))
  random(count, seed)    ``count`` seeded uniform crash points — the
                         batch axis sweep() expands into one cell each
  at_every_step()        one crash point per step — the exhaustive
                         recompute-vs-crash-point curve (figs 3/7);
                         dense, so pair it with the fork sweep engine

``torn`` models a crash *inside* the step boundary: the step's
computation happened but the consistency mechanism's end-of-step
persistence (undo-log commit, checkpoint, selective flush) did not —
the case that exercises rollback paths. Two spellings:

  torn=True              the all-or-nothing worst case: every dirty
                         cache line is lost (the pre-TornSpec
                         behavior, kept byte-identical);
  torn=TornSpec(...)     parameterized line survival: a seeded subset
                         of the dirty lines was already written back
                         when power failed, so the crash image is one
                         of the *torn-write* states WITCHER enumerates
                         and EasyCrash samples. ``samples`` expands
                         each crash step into that many cells, each
                         with its own derived survival seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union, TYPE_CHECKING

import numpy as np

from ..core.backends import LineSurvival, MediaFault

if TYPE_CHECKING:  # pragma: no cover
    from .workloads import Workload

__all__ = ["CrashPlan", "CrashPoint", "TornSpec", "FaultSpec"]


@dataclasses.dataclass(frozen=True)
class TornSpec:
    """Parameterized sub-step torn-write crash: which fraction of the
    dirty cache lines already persisted, chosen how, sampled how often.

    ``survival_for(j)`` derives sample j's :class:`LineSurvival`
    (effective seed = ``seed + j``), so resolution is a pure, replayable
    function of the spec — the property tests rely on it.
    """

    fraction: float = 0.0
    seed: int = 0
    mode: str = "random"     # "random" | "eviction" (see LineSurvival)
    samples: int = 1
    granularity: str = "line"  # "line" | "word" (WITCHER sub-line states)

    def __post_init__(self):
        # LineSurvival owns fraction/mode/granularity validation
        LineSurvival(self.fraction, self.seed, self.mode, self.granularity)
        if self.samples < 1:
            raise ValueError("samples must be >= 1")

    def survival_for(self, sample: int) -> LineSurvival:
        return LineSurvival(self.fraction, self.seed + int(sample), self.mode,
                            self.granularity)

    def describe(self) -> str:
        base = f"{self.mode}:f{self.fraction:g}:s{self.seed}"
        if self.granularity == "word":
            base += ":word"
        return base + (f":x{self.samples}" if self.samples > 1 else "")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Recovery-time fault injection attached to a crash point — what
    goes wrong *after* the crash, while (or before) recovery runs.

    Two orthogonal fault families (combinable in principle, but the
    shipped campaigns keep them separate so the golden-comparison
    classes stay unambiguous):

    * **Nested crash** (``nested_after`` set): power fails again after
      the ``nested_after``-th recovery action (see
      :meth:`CrashEmulator.arm_nested_crash`), ``nested_crashes`` times
      in total, each re-crash with its own derived torn line survival
      (``nested_fraction`` / ``nested_mode``; fraction 0 = the classic
      all-or-nothing re-crash). The scenario layer retries recovery up to
      ``max_attempts`` times; strategies whose recovery performs no
      emulator actions (a post-commit undo-log boundary, XSBench's
      read-only pointer recovery) never trip the trap and classify
      through the base path.
    * **Media fault** (``poison_words`` > 0): the post-crash image is
      silently corrupted (:class:`~repro_torch.core.backends.MediaFault`)
      before recovery runs — ``poison_regions`` restricts targets to
      exact live-region names or ``"prefix*"`` globs (None = every
      live region); an empty match injects nothing.
    """

    nested_after: Optional[int] = None
    nested_fraction: float = 0.0
    nested_mode: str = "random"
    nested_crashes: int = 1
    max_attempts: int = 3
    seed: int = 0
    poison_words: int = 0
    poison_kind: str = "poison"
    poison_regions: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.nested_after is None and self.poison_words <= 0:
            raise ValueError(
                "FaultSpec must inject something: set nested_after "
                "and/or poison_words")
        if self.nested_after is not None:
            if self.nested_after < 1:
                raise ValueError("nested_after must be >= 1")
            if self.nested_crashes < 1:
                raise ValueError("nested_crashes must be >= 1")
            if self.max_attempts <= self.nested_crashes:
                raise ValueError(
                    "max_attempts must exceed nested_crashes (the final "
                    "attempt must be allowed to complete)")
            # LineSurvival owns fraction/mode validation
            LineSurvival(self.nested_fraction, self.seed, self.nested_mode)
        if self.poison_words > 0:
            MediaFault(self.poison_words, self.seed, self.poison_kind)
        if self.poison_regions is not None:
            object.__setattr__(self, "poison_regions",
                               tuple(self.poison_regions))

    def nested_survival(self, firing: int) -> Optional[LineSurvival]:
        """Line survival of re-crash number ``firing`` (1-based). Pure
        in (spec, firing): retried resolutions replay identically."""
        if self.nested_fraction <= 0.0:
            return None
        return LineSurvival(self.nested_fraction,
                            self.seed + 101 * int(firing),
                            self.nested_mode)

    def media_fault(self) -> Optional[MediaFault]:
        if self.poison_words <= 0:
            return None
        return MediaFault(self.poison_words, self.seed, self.poison_kind)

    def resolve_poison_regions(self, live_names) -> List[str]:
        """Ground ``poison_regions`` against a workload's live-region
        names: exact matches plus ``"prefix*"`` glob expansion, in
        sorted order (the canonical ordering corrupt_image_words
        selects over)."""
        live = sorted(live_names)
        if self.poison_regions is None:
            return live
        out = set()
        for pat in self.poison_regions:
            if pat.endswith("*"):
                out.update(n for n in live if n.startswith(pat[:-1]))
            elif pat in live:
                out.add(pat)
        return sorted(out)

    def describe(self) -> str:
        parts = []
        if self.nested_after is not None:
            p = f"nested:a{self.nested_after}:f{self.nested_fraction:g}"
            p += f":s{self.seed}"
            if self.nested_mode != "random":
                p += f":{self.nested_mode}"
            if self.nested_crashes > 1:
                p += f":x{self.nested_crashes}"
            parts.append(p)
        if self.poison_words > 0:
            p = f"{self.poison_kind}:w{self.poison_words}:s{self.seed}"
            if self.poison_regions is not None:
                p += ":" + ",".join(self.poison_regions)
            parts.append(p)
        return "+".join(parts)


@dataclasses.dataclass(frozen=True)
class CrashPoint:
    """A concrete, grounded crash point for one scenario run."""

    step: Optional[int]          # None => never crash
    torn: bool = False
    # line-survival subset for sub-step torn crashes; None = the
    # classic all-or-nothing crash (every dirty line lost)
    survival: Optional[LineSurvival] = None
    # recovery-time fault injection (nested crash / media fault); None
    # = the classic crash-once-recover-once cell
    fault: Optional[FaultSpec] = None

    def describe(self) -> str:
        if self.step is None:
            return "no_crash"
        fault = (f":fault[{self.fault.describe()}]"
                 if self.fault is not None else "")
        if self.survival is not None:
            return (f"step={self.step}:torn[{self.survival.describe()}]"
                    + fault)
        return f"step={self.step}" + (":torn" if self.torn else "") + fault


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    kind: str                    # "none" | "step" | "phase" | "fraction" | "random"
    step: Optional[int] = None
    phase: Optional[str] = None
    index: Optional[int] = None
    fraction: Optional[float] = None
    count: int = 1
    seed: int = 0
    torn: Union[bool, TornSpec] = False
    # recovery-time fault injection, applied to every crash point the
    # plan resolves (no_crash plans never carry one)
    fault: Optional[FaultSpec] = None

    # -- constructors ---------------------------------------------------------
    @classmethod
    def no_crash(cls) -> "CrashPlan":
        return cls(kind="none")

    @classmethod
    def at_step(cls, step: int, torn: Union[bool, TornSpec] = False,
                fault: Optional[FaultSpec] = None) -> "CrashPlan":
        if step < 0:
            raise ValueError("crash step must be >= 0")
        return cls(kind="step", step=int(step), torn=torn, fault=fault)

    @classmethod
    def at_phase(cls, phase: str, index: int,
                 torn: Union[bool, TornSpec] = False,
                 fault: Optional[FaultSpec] = None) -> "CrashPlan":
        return cls(kind="phase", phase=phase, index=int(index), torn=torn,
                   fault=fault)

    @classmethod
    def at_fraction(cls, fraction: float,
                    torn: Union[bool, TornSpec] = False,
                    fault: Optional[FaultSpec] = None) -> "CrashPlan":
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        return cls(kind="fraction", fraction=float(fraction), torn=torn,
                   fault=fault)

    @classmethod
    def random(cls, count: int = 1, seed: int = 0,
               torn: Union[bool, TornSpec] = False,
               fault: Optional[FaultSpec] = None) -> "CrashPlan":
        if count < 1:
            raise ValueError("count must be >= 1")
        return cls(kind="random", count=int(count), seed=int(seed),
                   torn=torn, fault=fault)

    @classmethod
    def at_every_step(cls, torn: Union[bool, TornSpec] = False,
                      fault: Optional[FaultSpec] = None) -> "CrashPlan":
        return cls(kind="every", torn=torn, fault=fault)

    # -- grounding ------------------------------------------------------------
    def _points_at(self, step: int) -> List[CrashPoint]:
        """Expand one grounded step into its crash points: a single
        point for boolean ``torn``, one per survival sample for a
        :class:`TornSpec` (each with its own derived seed)."""
        if isinstance(self.torn, TornSpec):
            return [CrashPoint(step, True, self.torn.survival_for(j),
                               self.fault)
                    for j in range(self.torn.samples)]
        return [CrashPoint(step, bool(self.torn), None, self.fault)]

    def resolve(self, workload: "Workload") -> List[CrashPoint]:
        """Ground this plan against a set-up workload. Returns one
        :class:`CrashPoint` per scenario cell (>1 for ``random`` /
        ``every`` / multi-sample :class:`TornSpec` plans).

        Contract (property-tested in tests/test_crashplan_properties.py):
        every resolved step lies in ``[0, n_steps)``, the returned steps
        are sorted and deduplicated across *steps* (``random`` samples
        without replacement and sorts; a TornSpec with ``samples=k``
        repeats each step k times with k distinct survival seeds), and
        resolution is a pure function of (plan, workload step/phase
        layout): resolving twice, or against another workload with the
        same layout, yields the same points. Plans that cannot be
        grounded raise ``ValueError`` (``sweep()`` records these cells
        as skipped)."""
        n = workload.n_steps
        if self.kind == "none":
            return [CrashPoint(None)]
        if self.kind == "step":
            if not 0 <= self.step < n:
                raise ValueError(
                    f"crash step {self.step} outside [0, {n}) for "
                    f"workload {workload.name!r}")
            return self._points_at(self.step)
        if self.kind == "phase":
            phases = workload.phases()
            if self.phase not in phases:
                raise ValueError(
                    f"workload {workload.name!r} has no phase "
                    f"{self.phase!r} (has {sorted(phases)})")
            rng = phases[self.phase]
            if not 0 <= self.index < len(rng):
                raise ValueError(
                    f"phase {self.phase!r} has {len(rng)} steps, "
                    f"index {self.index} out of range")
            return self._points_at(rng[self.index])
        if self.kind == "fraction":
            return self._points_at(min(n - 1, int(self.fraction * (n - 1))))
        if self.kind == "random":
            if self.count > n:
                raise ValueError(
                    f"random plan requests {self.count} distinct crash "
                    f"points but workload {workload.name!r} has only "
                    f"{n} steps")
            rng = np.random.default_rng(self.seed)
            steps = sorted(int(s) for s in
                           rng.choice(n, size=self.count, replace=False))
            return [p for s in steps for p in self._points_at(s)]
        if self.kind == "every":
            return [p for s in range(n) for p in self._points_at(s)]
        raise ValueError(f"unknown crash plan kind {self.kind!r}")

    def describe(self) -> str:
        if isinstance(self.torn, TornSpec):
            torn = f":torn[{self.torn.describe()}]"
        else:
            torn = ":torn" if self.torn else ""
        if self.fault is not None:
            torn += f":fault[{self.fault.describe()}]"
        if self.kind == "none":
            return "no_crash"
        if self.kind == "step":
            return f"step:{self.step}{torn}"
        if self.kind == "phase":
            return f"phase:{self.phase}:{self.index}{torn}"
        if self.kind == "fraction":
            return f"frac:{self.fraction:g}{torn}"
        if self.kind == "random":
            return f"rand:n{self.count}:s{self.seed}{torn}"
        if self.kind == "every":
            return f"every{torn}"
        return self.kind

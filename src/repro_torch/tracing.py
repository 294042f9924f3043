"""Spans and counters of the port, in memory, on the profiler's clock.

    with tracing.collect() as c:
        trainer.run(steps)
    c.self_seconds("train.forward"), c.counters["slot.bytes"]

:func:`span` marks a phase (``with tracing.span("train.forward"):``) and
:func:`count` adds to a named counter. Both record only while a
collector is active (:func:`collect`); nothing is written to disk. With
no collector and no profiler running, :func:`span` returns one shared
no-op context. A span on the main thread also enters
``torch.profiler.record_function(name)`` while a ``torch.profiler`` run
is active, so that the phase lies in the profiler's trace and the
device operations its launches start are tied to it by their
correlation ids. Spans of other threads (the slot writer's) stay in the
collector: a long range there would cover the main thread's idle
stretches in the trace and name them.

Stamps are nanoseconds on the clock of the profiler's host events
(kineto's, the Unix epoch's), read through the monotonic counter.

A span made with ``timed=True`` measures itself whether or not anything
records it, and holds its length in ``seconds`` once it has closed: the
trainer's ``timings`` and ``step_seconds`` and the slot writer's
``write_seconds`` are fed so.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Union

import torch

__all__ = ["Span", "Collector", "span", "count", "collect"]

# the profiler's host clock (Unix epoch ns), read through the monotonic one
_EPOCH_OFFSET = time.time_ns() - time.perf_counter_ns()


def _now_ns() -> int:
    """Now, in the stamps' clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]   # id of the enclosing span on the same thread
    step: Optional[int]
    thread: int             # ``threading.get_ident()``

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


Names = Union[str, Iterable[str]]


def _name_set(names: Names) -> frozenset:
    return frozenset([names] if isinstance(names, str) else names)


class Collector:
    """The spans and counters recorded while it was active."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, s: Span) -> None:
        self.spans.append(s)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def of(self, names: Names) -> List[Span]:
        want = _name_set(names)
        return [s for s in self.spans if s.name in want]

    def seconds(self, names: Names) -> float:
        """The summed durations of the spans named ``names``."""
        return sum(s.seconds for s in self.of(names))

    def self_seconds(self, names: Names) -> float:
        """The summed self times of the spans named ``names``: each
        span's duration less the part of it that its child spans (on its
        thread) cover."""
        spans = self.of(names)
        ids = {s.id for s in spans}
        kids: Dict[int, List[Span]] = {}
        for c in self.spans:
            if c.parent in ids:
                kids.setdefault(c.parent, []).append(c)
        total = 0
        for s in spans:
            total += s.end_ns - s.start_ns - _covered(
                kids.get(s.id, ()), s.start_ns, s.end_ns)
        return total / 1e9


def _covered(spans: Iterable[Span], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the union of ``spans`` covers."""
    iv = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans)
    out, end = 0, lo
    for a, b in iv:
        a = max(a, end)
        if b > a:
            out += b - a
            end = b
    return out


_active: Optional[Collector] = None
_ids = itertools.count(1)
_local = threading.local()
_NOOP = contextlib.nullcontext()


def _stack() -> List[int]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "step", "coll", "rf", "id", "parent", "t0",
                 "seconds")

    def __init__(self, name, step, coll, rf):
        self.name, self.step, self.coll, self.rf = name, step, coll, rf
        self.seconds: Optional[float] = None

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_ids)
        st.append(self.id)
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t1 = _now_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        self.seconds = (t1 - self.t0) / 1e9
        if self.coll is not None:
            self.coll.add(Span(self.id, self.name, self.t0, t1, self.parent,
                               self.step, threading.get_ident()))
        return False


def span(name: str, step: Optional[int] = None, timed: bool = False):
    """A context for the phase ``name`` (of training step ``step``).

    It records into the active collector, and on the main thread enters
    ``record_function(name)`` while a profiler runs; with neither, and
    without ``timed``, it is one shared no-op context."""
    coll = _active
    mirror = (torch.autograd._profiler_enabled()
              and threading.current_thread() is threading.main_thread())
    if coll is None and not mirror and not timed:
        return _NOOP
    return _Span(name, step, coll,
                 torch.profiler.record_function(name) if mirror else None)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` of the active collector."""
    coll = _active
    if coll is not None:
        coll.count(name, int(n))


@contextlib.contextmanager
def collect() -> Iterator[Collector]:
    """Record every thread's spans and counters into a new collector
    while the block runs; the one active before is restored after."""
    global _active
    prev, _active = _active, Collector()
    try:
        yield _active
    finally:
        _active = prev

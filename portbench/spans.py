"""The program's spans as the profiled stretch's trace holds them.

On the main thread the program's spans (``repro_torch.tracing``) enter
``torch.profiler.record_function`` while a profiler runs, so the trace
of the profiled stretch after the window (``Trace.host``) holds each
``train.step`` and each phase inside it as a host range of that name.
The readers of ``metrics/`` divide those ranges' seconds by the
stretch's, or count the device operations and the blocking runtime
calls that lie in the steps; where the program marks no such range (a
program without spans) they find nothing to read. The slot writer's
spans and the program's counters never reach a trace.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from .trace import Event


def ranges(ctx, names: Iterable[str]) -> List[Event]:
    """The host ranges named ``names`` inside the profiled stretch of a
    training run, or ``[]``."""
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None:
        return []
    want = set(names)
    return [e for e in tr.host if e[0] in want
            and e[1] >= tr.w0 and e[2] <= tr.w1]


def share(ctx, *names: str) -> Optional[float]:
    """The summed seconds of the ranges named ``names`` as a share (%) of
    the profiled stretch, or None where the trace has none."""
    evs = ranges(ctx, names)
    if not evs:
        return None
    return 100.0 * sum(e[2] - e[1] for e in evs) / 1e9 \
        / ctx["trace"].window_s


# runtime calls that return only once the card has run what was queued
# before them; a copy to or from pageable memory does so too
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def _in_steps(ctx, events):
    """``events`` that start inside one of the ``train.step`` ranges, and
    the number of those ranges."""
    steps = sorted(ranges(ctx, ["train.step"]), key=lambda e: e[1])
    if not steps or not events:
        return [], len(steps)
    lo = np.array([e[1] for e in steps], np.int64)
    hi = np.array([e[2] for e in steps], np.int64)
    start = np.array([e[1] for e in events], np.int64)
    i = np.searchsorted(lo, start, side="right") - 1
    inside = (i >= 0) & (start <= hi[np.maximum(i, 0)])
    return [events[k] for k in np.flatnonzero(inside)], len(steps)


def ops_per_step(ctx) -> Optional[float]:
    """Device operations launched inside the ``train.step`` ranges (tied
    to the host events that launched them by correlation id) over the
    number of those ranges, or None where there are no steps or no
    device operations."""
    tr = ctx.get("trace")
    if tr is None or not tr.device:
        return None
    launches, n = _in_steps(ctx, [e for e in tr.host if e[3] > 0])
    if not n:
        return None
    ids = {e[3] for e in launches}
    return sum(1 for e in tr.device if e[3] in ids) / n


def wait_share(ctx) -> Optional[float]:
    """The seconds in which the host was blocked on the card inside the
    ``train.step`` ranges, as a share (%) of the profiled stretch: the
    runtime calls that wait for the card's queue (``SYNCS``, and a
    ``cudaMemcpy*`` whose copy touches pageable memory, tied to it by
    correlation id). None where there are no steps or no device
    operations."""
    tr = ctx.get("trace")
    if tr is None or not tr.device:
        return None
    pageable = {e[3] for e in tr.device if "Pageable" in e[0]}
    waits, n = _in_steps(ctx, [
        e for e in tr.host if e[0] in SYNCS
        or (e[0].startswith("cudaMemcpy") and e[3] in pageable)])
    if not n:
        return None
    return 100.0 * sum(e[2] - e[1] for e in waits) / 1e9 / tr.window_s

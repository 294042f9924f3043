"""Reading a ``torch.profiler`` trace of the measured window.

A :class:`Trace` holds two kinds of events, each (name, start ns, end
ns, correlation id): operations that ran on the device (kernels, copies,
sets) and the host's events (operators, runtime calls, the benchmark's
own ``record_function`` ranges, whose device-side copies are no device
operations and are dropped). The window is the host range named
``portbench.window``. Everything
else is arithmetic on intervals, which the CPU tests drive with made-up
events.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

import numpy as np

WINDOW = "portbench.window"
Event = Tuple[str, int, int, int]


def _arrays(evs: List[Event]):
    if not evs:
        z = np.zeros(0, np.int64)
        return z, z, z
    s = np.fromiter((e[1] for e in evs), np.int64, len(evs))
    t = np.fromiter((e[2] for e in evs), np.int64, len(evs))
    c = np.fromiter((e[3] for e in evs), np.int64, len(evs))
    return s, t, c


def _union(s: np.ndarray, t: np.ndarray):
    """Merged intervals (starts, ends) of [s, t)."""
    if not len(s):
        return s, t
    o = np.argsort(s, kind="stable")
    s, t = s[o], t[o]
    run = np.maximum.accumulate(t)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run[:-1]
    idx = np.flatnonzero(new)
    ends = np.append(run[idx[1:] - 1], run[-1])
    return s[idx], ends


class Trace:
    def __init__(self, device: List[Event], host: List[Event]):
        win = [e for e in host if e[0] == WINDOW]
        if not win:
            raise ValueError(f"no {WINDOW!r} range in the trace")
        self.w0, self.w1 = win[0][1], win[0][2]
        self.device = [e for e in device
                       if e[2] > self.w0 and e[1] < self.w1]
        self.host = host
        s, t, _ = _arrays(self.device)
        self._s = np.clip(s, self.w0, self.w1)
        self._t = np.clip(t, self.w0, self.w1)
        self._others = [e for e in host if e[0] != WINDOW]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """From a finished ``torch.profiler.profile`` with CPU and CUDA
        activities (its kineto results)."""
        host = []
        events = prof.profiler.kineto_results.events()
        host_names = set()
        raw = []
        for e in events:
            on_dev = "CUDA" in str(e.device_type())
            item = (e.name(), int(e.start_ns()),
                    int(e.start_ns()) + int(e.duration_ns()),
                    int(e.correlation_id()))
            if on_dev:
                raw.append((item, bool(e.is_user_annotation())))
            else:
                host.append(item)
                if e.is_user_annotation():
                    host_names.add(e.name())
        dev = [item for item, note in raw
               if not note and item[0] not in host_names]
        return cls(dev, host)

    # -- the device's time ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device (the union of their intervals)."""
        s, t = _union(self._s, self._t)
        return float(np.sum(t - s)) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by = defaultdict(int)
        for (name, _, _, _), s, t in zip(self.device, self._s, self._t):
            by[name] += int(t - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], v / 1e9] for name, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches of the window in which nothing ran
        on the device, each named by the innermost host event running at
        its middle, and their seconds."""
        s, t = _union(self._s, self._t)
        starts = np.concatenate([[self.w0], t])
        ends = np.concatenate([s, [self.w1]])
        gaps = ends - starts
        keep = np.argsort(-gaps, kind="stable")[:k]
        hs, ht, _ = _arrays(self._others)
        out = []
        for i in keep:
            if gaps[i] <= 0:
                break
            mid = (starts[i] + ends[i]) // 2
            cover = np.flatnonzero((hs <= mid) & (ht >= mid))
            if len(cover):
                j = cover[np.argmin(ht[cover] - hs[cover])]
                label = self._others[j][0]
            else:
                label = "host: no profiled operation (python)"
            out.append([label[:160], int(gaps[i]) / 1e9])
        return out

"""The port's spans and counters (``repro_torch.tracing``): nesting, self
time, the cost of tracing off, the profiler's clock, which spans reach
the profiler, and the phases of a reduced mamba2-130m ``ADCCTrainer``
run in each mode, with the trainer's own timings fed by the same spans.
Everything runs on the CPU."""

import contextlib
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tracing
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.train import ADCCTrainer
from repro_torch.models import get_config

MS = 1_000_000


def _span(i, name, a, b, parent=None, step=None, thread=1):
    return tracing.Span(i, name, a * MS, b * MS, parent, step, thread)


def test_nesting_parent_step_and_thread():
    with tracing.collect() as c:
        with tracing.span("outer", step=3):
            with tracing.span("inner"):
                tracing.count("bytes", 5)
            with tracing.span("inner"):
                tracing.count("bytes", 7)
    inner1, inner2, outer = c.spans
    assert [s.name for s in c.spans] == ["inner", "inner", "outer"]
    assert outer.parent is None and outer.step == 3
    assert inner1.parent == outer.id == inner2.parent
    assert inner1.step is None
    assert {s.thread for s in c.spans} == {threading.get_ident()}
    assert outer.start_ns <= inner1.start_ns <= inner1.end_ns \
        <= inner2.start_ns <= inner2.end_ns <= outer.end_ns
    assert c.counters == {"bytes": 12}
    assert c.seconds("inner") == pytest.approx(inner1.seconds
                                               + inner2.seconds)


def test_self_time_of_made_up_spans():
    c = tracing.Collector()
    # a: 0-100 ms with children 10-30 and 20-50 (overlapping: 40 covered)
    # and a grandchild 12-14 that is not a's child; b: 200-260, none
    for s in [_span(1, "a", 0, 100), _span(2, "k", 10, 30, parent=1),
              _span(3, "k", 20, 50, parent=1), _span(4, "g", 12, 14, 2),
              _span(5, "b", 200, 260)]:
        c.add(s)
    assert c.self_seconds("a") == pytest.approx(0.060)
    assert c.self_seconds("k") == pytest.approx(0.048)
    assert c.self_seconds(["a", "b"]) == pytest.approx(0.120)
    assert c.seconds(["a", "b"]) == pytest.approx(0.160)
    assert c.self_seconds("none") == 0


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    a, b = tracing.span("a"), tracing.span("b", step=1)
    assert a is b
    with a:
        tracing.count("n", 1)
    with tracing.span("t", timed=True) as t:
        pass
    assert t.seconds >= 0 and entered == []
    with tracing.collect() as c:
        pass
    assert c.spans == [] and c.counters == {}


def test_stamps_lie_on_the_profilers_clock():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.collect() as c:
            with tracing.span("warm"):
                pass
            with tracing.span("probe"):
                time.sleep(0.002)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe"]
    s = c.of("probe")[0]
    assert len(ev) == 1
    assert abs(ev[0].start_ns() - s.start_ns) < 0.5 * MS
    assert abs(ev[0].start_ns() + ev[0].duration_ns() - s.end_ns) < 0.5 * MS


def test_other_threads_are_collected_not_mirrored(monkeypatch):
    """Even where the profiler reads as running on every thread."""
    entered = []

    def spy(name):
        entered.append((name, threading.get_ident()))
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", spy)

    def work():
        with tracing.span("worker"):
            pass
    with tracing.collect() as c:
        with tracing.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(30)
    assert not th.is_alive()
    assert entered == [("main", threading.get_ident())]
    assert {s.name for s in c.spans} == {"main", "worker"}
    worker = c.of("worker")[0]
    assert worker.parent is None and worker.thread != threading.get_ident()


# -- the trainer ------------------------------------------------------------

STEPS, EVERY = 4, 2
STEP_KIDS = {"train.batch", "train.forward", "train.backward",
             "train.optimizer", "train.checksums", "train.loss_sync"}
TIMINGS = {"ledger_append", "host_copy", "slot_write", "recover_read",
           "recover_verify"}


def _trainer(workdir, mode):
    cfg = get_config("mamba2-130m").reduced()
    tcfg = TrainConfig(remat="dots", total_steps=40, warmup_steps=5)
    return ADCCTrainer(cfg, tcfg, workdir, batch=2, seq=16,
                       slot_every=EVERY, mode=mode)


def _kids(c, parent):
    return sorted((s for s in c.spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


@pytest.mark.parametrize("mode", ["adcc", "none", "sync"])
def test_trainer_phases(tmp_path, mode):
    with repro_torch.use_device("cpu"):
        tr = _trainer(str(tmp_path / mode), mode)
        with tracing.collect() as c:
            res = tr.run(STEPS, log_every=0)
        main = threading.get_ident()
        run, = c.of("train.run")
        steps = c.of("train.step")
        assert [s.step for s in steps] == list(range(STEPS))
        assert [s.seconds for s in steps] == res.step_seconds
        assert tr.monitor.times == res.step_seconds
        top = [s.name for s in _kids(c, run)]
        assert top == (["train.recover"] + ["train.step"] * STEPS
                       + (["adcc.drain"] if mode == "adcc" else []))
        for st in steps:
            slot_step = (st.step + 1) % EVERY == 0
            want = set(STEP_KIDS)
            if mode == "adcc" or (mode == "sync" and slot_step):
                want |= {"adcc.record", "adcc.ledger_append"}
            if slot_step and mode != "none":
                want |= {"adcc.host_copy",
                         "adcc.submit" if mode == "adcc"
                         else "adcc.sync_write"}
            kids = _kids(c, st)
            assert {k.name for k in kids} == want
            assert len(kids) == len(want)
            for k, nxt in zip(kids, kids[1:] + [None]):
                assert k.thread == main
                assert st.start_ns <= k.start_ns <= k.end_ns <= st.end_ns
                assert nxt is None or k.end_ns <= nxt.start_ns
            by = {k.name: k for k in kids}
            assert [s.name for s in _kids(c, by["train.forward"])] \
                == ["train.cast"]
            if "adcc.ledger_append" in by:
                assert [s.name for s in _kids(c, by["adcc.ledger_append"])] \
                    == ["adcc.fsync"]
        n_slots = STEPS // EVERY
        n_ledger = {"adcc": STEPS, "sync": n_slots, "none": 0}[mode]
        counts = {k: len(v) for k, v in tr.timings.items()}
        assert counts == {"ledger_append": n_ledger,
                          "host_copy": 0 if mode == "none" else n_slots,
                          "slot_write": n_slots if mode == "sync" else 0,
                          "recover_read": 0, "recover_verify": 0}
        assert [s.seconds for s in c.of("adcc.ledger_append")] \
            == tr.timings["ledger_append"]
        assert [s.seconds for s in c.of("adcc.host_copy")] \
            == tr.timings["host_copy"]
        if mode != "adcc":
            assert tr.writer is None and "slot.bytes" not in c.counters
            return
        writes = c.of("slot.write")
        assert [s.step for s in writes] == [EVERY - 1, 2 * EVERY - 1]
        assert [s.step for s in c.of("adcc.submit")] \
            == [s.step for s in writes]
        assert {s.thread for s in writes} != {main}
        assert [s.seconds for s in writes] == tr.writer.write_seconds
        slot_bytes = sum(np.load(f).nbytes for f in glob.glob(
            os.path.join(str(tmp_path / mode), "slots", "slot_0", "*.npy")))
        assert c.counters["slot.bytes"] == n_slots * slot_bytes > 0

        # a restart recovers from the newest slot
        tr2 = _trainer(str(tmp_path / mode), mode)
        with tracing.collect() as c:
            res2 = tr2.run(STEPS + 1, log_every=0)
        assert res2.resumed_from == STEPS - 1
        assert {k: len(v) for k, v in tr2.timings.items()} == {
            "ledger_append": 1, "host_copy": 0, "slot_write": 0,
            "recover_read": 1, "recover_verify": 1}
        rec, = c.of("train.recover")
        read, check = _kids(c, rec)
        assert (read.name, read.step, check.name, check.step) == (
            "recover.read", STEPS - 1, "recover.verify", STEPS - 1)
        assert tr2.timings["recover_read"] == [read.seconds]
        assert tr2.timings["recover_verify"] == [check.seconds]


class _Release(torch.autograd.Function):
    """The identity, whose graph node holds ``flag`` until the autograd
    graph is released."""

    @staticmethod
    def forward(ctx, x, flag):
        ctx.flag = flag
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Flag:
    def __init__(self, seen):
        self.seen = seen

    def __del__(self):
        self.seen.append(list(tracing._stack()))


def test_the_graph_is_released_inside_the_backward_span(tmp_path,
                                                         monkeypatch):
    """So that the host's time in freeing the graph carries the backward
    pass's name in a trace, not the step's."""
    seen = []
    with repro_torch.use_device("cpu"):
        tr = _trainer(str(tmp_path), "none")
        loss_fn = tr.api.loss_fn
        monkeypatch.setattr(tr.api, "loss_fn", lambda *a, **k:
                            _Release.apply(loss_fn(*a, **k), _Flag(seen)))
        with tracing.collect() as c:
            tr.run(2, log_every=0)
    backward = {s.id for s in c.of("train.backward")}
    assert len(seen) == 2 and len(backward) == 2
    assert all(open_spans and open_spans[-1] in backward
               for open_spans in seen)


def test_trainer_timings_are_fed_without_a_collector(tmp_path):
    with repro_torch.use_device("cpu"):
        tr = _trainer(str(tmp_path), "sync")
        res = tr.run(EVERY, log_every=0)
    assert set(tr.timings) == TIMINGS
    assert {k: len(v) for k, v in tr.timings.items()} == {
        "ledger_append": 1, "host_copy": 1, "slot_write": 1,
        "recover_read": 0, "recover_verify": 0}
    assert len(res.step_seconds) == EVERY == len(tr.monitor.times)
    assert min(res.step_seconds) > 0 and min(tr.timings["slot_write"]) > 0

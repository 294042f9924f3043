"""The train driver: the program's ADCC trainer (``launch/train.py::
ADCCTrainer``) on the benchmark's weights and batches.

Set-up builds one trainer, drives it from the seed through the first
``check_steps`` steps with its own ``run`` (one step, then the rest, so
that the optimizer's state after the first step can be read), and hands
that same trainer, model and optimizer state to the window: one ``run``
call of ``2 K`` further steps, ``K`` chosen from the step time that
set-up measured so that the call lasts about ``--seconds``. With
``slot_every = K`` the window holds exactly two slot steps, whatever the
program's speed (the slot rule of the traffic file). The trainer's
recovery scan is replaced by the hand-over of the set-up's state, and its
data pipeline by the benchmark's feed: the trainer takes neither from
outside otherwise.

The reference follows the first ``check_steps`` steps from the same
weights and batches. Compared: the norm of each leaf's first gradient
(the program's as AdamW holds it after one step, ``m / (1 - beta1)``)
and of each leaf's change over those steps, against the reference's, by
the median leaf; the worst leaf's gaps and each step's loss are printed
beside them. In the ``adcc`` mode the slots the window wrote are read
back from disk and each leaf's sum compared with the ledger's checksum
of its step. The window's later steps are not followed by the reference
(PERF.md says which faults the limits therefore cannot see).

With ``--trace 1`` the window runs as without, and the per-layer readers
that need no trace (the rates and the trainer's timings) read it; then
``K`` further steps, one slot step among them, run under the profiler,
and the device's readers and the breakdown read that stretch, so that
the profiler's cost on the host reaches none of the other numbers.
"""

from __future__ import annotations

import copy
import gc
import glob
import json
import math
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from .. import bench, flops, weights
from ..reference import train as RT
from ..trace import WINDOW, Trace
from ..traffic import TrainFeed, check_keys

# every key a train traffic file may hold (``slot_rule`` is its prose)
KEYS = ("driver", "mode", "batch", "seq", "tokens", "remat", "optimizer",
        "check_steps", "reference_rows", "n_slots", "slot_rule",
        "slot_every_min")
OPTIMIZER = ("name", "lr", "weight_decay", "beta1", "beta2", "eps",
             "warmup_steps", "total_steps")
MODES = ("adcc", "none")


def check(traffic: Dict) -> None:
    """Refuse a train traffic file with a key nothing reads, or a value
    that this driver or the reference does not implement."""
    check_keys(traffic, KEYS, "train traffic")
    check_keys(traffic["optimizer"], OPTIMIZER, "train traffic's optimizer")
    check_keys(traffic["tokens"], ("exponent", "copy_share"),
               "train traffic's tokens")
    if traffic["optimizer"]["name"] != "adamw":
        raise ValueError("the reference implements AdamW only")
    if traffic["mode"] not in MODES:
        raise ValueError(f"mode {traffic['mode']!r}: one of {MODES}")


class HalfFeed:
    """A planted fault: the first half of each batch's rows only."""

    def __init__(self, feed):
        self.feed = feed

    def batch_at(self, step: int):
        b = self.feed.batch_at(step)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}


def _unchanged(step_fn):
    """A planted fault: a step that returns its state unchanged."""
    def step(lm, opt, err, batch, gen):
        _, _, _, metrics, cks = step_fn(copy.deepcopy(lm),
                                        copy.deepcopy(opt), err, batch, gen)
        return lm, opt, err, metrics, cks
    return step


def _altered_slots(submit):
    """A planted fault: each slot's state altered where the host copy
    hands it to the writer (its second moments doubled)."""
    def altered(step, flat):
        for k in flat:
            if k.startswith("opt/v/"):
                flat[k] = flat[k] * 2
        return submit(step, flat)
    return altered


def _hand_over(trainer, lm, opt, start: int) -> None:
    """The trainer's next ``run`` starts at ``start`` from ``lm`` and
    ``opt`` instead of recovering from its files."""
    trainer._try_recover = lambda: (lm, opt, start,
                                    f"handed over at step {start}")


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    return {n: float(torch.linalg.vector_norm(t.detach().double())) * scale
            for n, t in tensors.items()}


def _slot_gap(workdir: str, offset: int = 0) -> float:
    """Each slot on disk against the ledger's record of its step: the
    largest |ledger checksum - float64 sum of the leaf| / sum |leaf| over
    leaves and slots (the ledger lists the parameters' paths sorted, then
    the optimizer's step, first moments and second moments). Infinity
    where a slot, a leaf or its record is missing. With ``offset`` 1, the
    record of the step after: what a slot one step stale would read."""
    with open(os.path.join(workdir, "ledger.jsonl")) as fh:
        recs = {r["step"]: r for r in map(json.loads, fh)}
    slots = sorted(glob.glob(os.path.join(workdir, "slots", "slot_*")))
    if not slots:
        return math.inf
    worst = 0.0
    for d in slots:
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        rec = recs.get(meta["step"] + offset)
        if rec is None or not meta.get("complete"):
            return math.inf
        leaves = {os.path.basename(f)[:-4].replace("__", "/"): f
                  for f in glob.glob(os.path.join(d, "*.npy"))}
        params = sorted(k[len("params/"):] for k in leaves
                        if k.startswith("params/"))
        order = ([f"params/{k}" for k in params] + ["opt/step"]
                 + [f"opt/m/{k}" for k in params]
                 + [f"opt/v/{k}" for k in params])
        want = rec["cks_params"] + rec["cks_opt"]
        if len(order) != len(want) or any(k not in leaves for k in order):
            return math.inf
        for k, c in zip(order, want):
            if offset and k == "opt/step":
                continue
            a = np.load(leaves[k])
            s = float(np.sum(a, dtype=np.float64))
            mag = float(np.sum(np.abs(a), dtype=np.float64))
            worst = max(worst, abs(c - s) / max(mag, 1e-30))
    return worst


def run(r: bench.Run) -> Dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import ADCCTrainer
    from repro_torch.models.registry import model_class

    m, t = r.model, r.traffic
    dev, cfg = r.device, r.port_cfg
    B, S = t["batch"], t["seq"]
    h = t["optimizer"]
    feed = TrainFeed(t, m["vocab_size"], r.seed)
    tcfg = TrainConfig(
        learning_rate=h["lr"], weight_decay=h["weight_decay"],
        beta1=h["beta1"], beta2=h["beta2"], eps=h["eps"],
        warmup_steps=h["warmup_steps"], total_steps=h["total_steps"],
        optimizer=h["name"], remat=t["remat"], seed=r.seed)
    lm = model_class(cfg)(cfg, device=dev)
    weights.load_into(lm, weights.make(m, r.seed, dev))
    n_check = t["check_steps"]
    workdir = tempfile.mkdtemp(prefix="portbench_train_")
    out: Dict = {}
    try:
        trainer = ADCCTrainer(cfg, tcfg, workdir, batch=B, seq=S,
                              slot_every=1 << 62, n_slots=t["n_slots"],
                              mode=t["mode"])
        trainer.pipeline = HalfFeed(feed) if r.fault == "half_batch" else feed
        if r.fault == "unchanged":
            trainer.step_fn = _unchanged(trainer.step_fn)
        if r.fault == "slot" and trainer.writer is not None:
            trainer.writer.submit = _altered_slots(trainer.writer.submit)
        # set-up: the first steps, through the window's own call and feed
        _hand_over(trainer, lm, trainer.opt_init(lm), 0)
        losses = list(trainer.run(1, log_every=0).losses)
        lm, opt = trainer._final_params, trainer._final_opt
        grad1 = _norms(opt.m, 1.0 / (1.0 - h["beta1"]))
        _hand_over(trainer, lm, opt, 1)
        res = trainer.run(n_check, log_every=0)
        losses += res.losses
        lm, opt = trainer._final_params, trainer._final_opt
        w0 = weights.make(m, r.seed, dev)
        change = {n: float(torch.linalg.vector_norm((p.detach() - w0[n])
                                                    .double()))
                  for n, p in lm.named_parameters()}
        del w0
        step_s = statistics.median(res.step_seconds)
        K = max(t["slot_every_min"], round(r.seconds / (2.0 * step_s)))
        n = 2 * K
        trainer.slot_every = K
        _hand_over(trainer, lm, opt, n_check)
        slot_bytes = sum(3 * 4 * p.numel() for p in lm.parameters()) + 4
        del lm, opt
        marks = {k: len(v) for k, v in trainer.timings.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - r.t0

        w0_ = time.perf_counter()
        res = trainer.run(n_check + n, log_every=0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - w0_
        timings = {k: v[marks[k]:] for k, v in trainer.timings.items()}
        losses_run = list(res.losses)
        trace = None
        if r.trace:
            # K more steps, one slot step among them, under the profiler
            _hand_over(trainer, trainer._final_params, trainer._final_opt,
                       n_check + n)
            with _profiler(dev) as prof:
                with torch.profiler.record_function(WINDOW):
                    res = trainer.run(n_check + n + K, log_every=0)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            losses_run += res.losses
            trace = Trace.from_profiler(prof)
            del prof
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        failed = sum(1 for x in losses_run if not math.isfinite(x))
        if t["mode"] == "adcc":
            out["slot_gap"] = _slot_gap(workdir)
            stale = _slot_gap(workdir, 1)
        del trainer, res
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    p0 = weights.make(m, r.seed, dev)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in feed.batch_at(s).items()}
               for s in range(n_check)]
    ref = RT.steps(m, p0, batches, h, rows=t["reference_rows"])
    del p0, batches
    norms = {"grad1": (grad1, _norms(ref["grad1"])),
             "change": (change, _norms(ref["change"]))}
    out["grad_gap_median"] = bench.median_leaf_gap(*norms["grad1"])
    out["change_gap_median"] = bench.median_leaf_gap(*norms["change"])
    checks = bench.checks_block(out, r.limits)
    # read and printed, not compared (PERF.md §2 gives the reasons)
    shown = {"loss_gap": max(abs(a - b) / abs(b)
                             for a, b in zip(losses, ref["losses"])),
             "grad_gap_worst": bench.worst_leaf_gap(*norms["grad1"]),
             "change_gap_worst": bench.worst_leaf_gap(*norms["change"])}

    tokens = n * B * S
    ctx = {"kind": "train", "window_s": window_s, "steps": n,
           "tokens": tokens, "flops": n * flops.train_step(m, B, S),
           "timings": timings, "slot_bytes": slot_bytes, "trace": trace}
    return {"e2e": {"train_tokens_per_s": tokens / window_s,
                    "setup_s": setup_s},
            "ctx": ctx, "checks": checks, "attempted": len(losses_run),
            "failed": failed,
            "peak": peak, "losses": losses, "ref_losses": ref["losses"],
            "leaf_norms": norms, **shown,
            "slot_every": K, "step_s": step_s,
            **({"slot_gap_stale": stale} if t["mode"] == "adcc" else {})}


def _profiler(dev):
    """A profiler of the host and, on a card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)

"""ADCC trainer + launcher (``python -m repro_torch.launch.train --arch ...``).

The JAX package's ``launch/train.py`` on one card. Per step the trainer:
  1. pulls batch t from the counter-based pipeline (pure function of t),
  2. runs the train step (launch/steps.py),
  3. synchronously appends the few-KB checksum ledger record — the
     paper's "flush one cache line per iteration",
  4. every ``slot_every`` steps copies the heavy state to the host (on
     this thread, as the reference does) and hands it to the async,
     fence-free slot writer (torn on crash, like cache-eviction residue).

On start it attempts ADCC recovery: ledger linearity-chain validation,
then a newest-first slot scan with per-tensor checksum verification
(core/acc_state.py). The accepted step restores the data cursor, which
makes recovery bitwise-reproducible on the card as on the CPU (the step
runs with deterministic algorithms; see launch/steps.py).

Also includes the step-time straggler monitor (flags slow hosts for the
controller to replace — simulated single-host here, interface real).

The trainer runs on :func:`repro_torch.get_device` (the card; the CPU
only inside ``use_device("cpu")``) and marks its phases with spans
(``repro_torch.tracing``): ``train.run``, its ``train.recover`` (with
``recover.read`` and ``recover.verify``) and one ``train.step`` a step,
whose children are ``train.batch``, the step's own (``train.forward``,
``train.backward``, ``train.optimizer``, ``train.checksums``: see
launch/steps.py), ``train.loss_sync`` (the host waits for the card), and
the ADCC layer's ``adcc.record``, ``adcc.ledger_append`` (with
``adcc.fsync``), ``adcc.host_copy``, ``adcc.submit`` and
``adcc.sync_write``; then ``adcc.drain``. The spans of the same regions
feed ``timings`` (seconds of each ledger append, each host copy of the
state, each synchronous slot write, and the recovery's reads and checks
of the slots it verified), ``step_seconds`` and the straggler monitor,
whether or not a collector records them.

Across the ranks of a ``DeviceMesh`` (``mesh=``, from Python in every
spawned rank, as the reference's trainer takes its mesh) every rank runs
the same loop on the same batches. The parameters and the optimizer
state are placed by the partition rules (``launch.steps``); the host
copy of a slot gathers the global arrays on every rank's main thread
(``core.slots.flatten_state``), and rank 0 alone appends the ledger and
writes the slots. Every rank reads the same ledger and slot files at
recovery, verifies them the same way, takes the same decision (checked
across the ranks), and places the recovered global arrays on the mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, TrainConfig
from ..core.acc_state import (ChecksumLedger, LedgerRecord, flatten_checksums,
                              verify_state_against_record)
from ..core.slots import (AsyncSlotWriter, SlotStore, flatten_state,
                          unflatten_state)
from ..data.pipeline import SyntheticPipeline
from ..device import get_device
from .. import tracing
from ..models.registry import build_model, get_config
from ..optim import init_error_state
from .mesh import is_ranked, single_device_mesh
from .steps import (build_train_step, place_model, place_opt_state,
                    train_rules)

__all__ = ["ADCCTrainer", "StragglerMonitor", "TrainerResult", "main",
           "CUBLAS_WORKSPACE"]

# cuBLAS's fixed workspace, which deterministic algorithms require on CUDA;
# it must be in the environment before the process's first cuBLAS call
CUBLAS_WORKSPACE = ":4096:8"


class StragglerMonitor:
    """Step-time outlier detection. At fleet scale each host reports its
    step wall-time; hosts persistently above ``threshold`` x median get
    flagged for hot-spare replacement. Single-host here, interface real."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.flagged_steps: List[int] = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        recent = self.times[-self.window:]
        if len(recent) >= 8:
            med = float(np.median(recent))
            if seconds > self.threshold * med:
                self.flagged_steps.append(step)
                return True
        return False


@dataclasses.dataclass
class TrainerResult:
    final_step: int
    losses: List[float]
    resumed_from: Optional[int]
    recovery_report: str
    step_seconds: List[float]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator (int8 compression noise): a pure function of
    (seed, step), so a replayed step draws what the first run drew."""
    s = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


class ADCCTrainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, workdir: str, *,
                 batch: int = 8, seq: int = 64, mesh=None,
                 slot_every: int = 8, n_slots: int = 3,
                 mode: str = "adcc", deterministic: bool = True):
        """mode: 'adcc' (paper technique) | 'sync' (traditional blocking
        checkpoint baseline) | 'none' (no fault tolerance).
        ``mesh``: ``None`` (a mesh of one card is built, as the reference
        builds its one-device mesh), a mesh of one card, or a
        ``DeviceMesh`` to train across its ranks (every rank builds the
        trainer with the same arguments).
        ``deterministic``: run each step with deterministic algorithms
        (needed for bitwise recovery on the card; launch/steps.py)."""
        if mode not in ("adcc", "sync", "none"):
            raise ValueError(f"mode {mode!r}: adcc, sync or none")
        # the reference's trainer builds a one-device mesh when given none,
        # and its step runs the model on it (MoE: the expert-parallel path)
        mesh, self.rules = train_rules(tcfg, mesh)
        self.mesh = single_device_mesh() if mesh is None else mesh
        self.ranked = is_ranked(self.mesh)
        # rank 0 appends the ledger and writes the slots
        self.writes = not self.ranked or dist.get_rank() == 0
        self.cfg, self.tcfg = cfg, tcfg
        self.workdir = workdir
        self.batch, self.seq = batch, seq
        self.slot_every, self.mode = slot_every, mode
        self.device = get_device()
        os.makedirs(workdir, exist_ok=True)

        self.api = build_model(cfg)
        self.pipeline = SyntheticPipeline(cfg, batch, seq, seed=tcfg.seed)
        self.step_fn, self.info, self.opt_init = build_train_step(
            self.api, tcfg, self.rules or self.mesh, donate=True,
            deterministic=deterministic)
        self.ledger = ChecksumLedger(os.path.join(workdir, "ledger.jsonl"))
        self.store = SlotStore(os.path.join(workdir, "slots"), n_slots)
        self.writer = (AsyncSlotWriter(self.store)
                       if mode == "adcc" and self.writes else None)
        self.monitor = StragglerMonitor()
        self.timings: Dict[str, List[float]] = {
            "ledger_append": [], "host_copy": [], "slot_write": [],
            "recover_read": [], "recover_verify": []}
        # (slot, step, mismatching leaves) of each slot the recovery checked
        self.recovery_checks: List[tuple] = []
        self._crashed = False

    # -- recovery ---------------------------------------------------------------
    def _try_recover(self):
        """-> (params, opt_state, resume_step, report) or Nones."""
        params, opt, start, report = self._scan_slots()
        if self.ranked:
            seen = [None] * dist.get_world_size()
            dist.all_gather_object(seen, start)
            if len(set(seen)) != 1:
                raise RuntimeError(f"ranks recover at different steps "
                                   f"{seen}: their files differ")
            if params is not None:
                params = place_model(params, self.rules)
                opt = place_opt_state(self.tcfg, self.rules, opt, params)
        return params, opt, start, report

    def _scan_slots(self):
        recs = {r.step: r for r in self.ledger.validated_records()}
        if not recs:
            return None, None, 0, "no ledger"
        abstract = self.api.abstract_init()
        template = {"params": abstract, "opt": self.opt_init(abstract)}
        for slot, step in self.store.slots_by_recency():
            rec = recs.get(step)
            if rec is None:
                continue
            with tracing.span("recover.read", step, timed=True) as read:
                state = self._read_state(slot, template)
            if state is None:
                continue  # torn slot: missing/short leaves
            with tracing.span("recover.verify", step, timed=True) as check:
                ok, bad = verify_state_against_record(
                    state["params"], state["opt"], rec)
            self.timings["recover_read"].append(read.seconds)
            self.timings["recover_verify"].append(check.seconds)
            self.recovery_checks.append((slot, step, bad))
            if ok:
                return (state["params"], state["opt"], step + 1,
                        f"slot {slot} @ step {step} verified")
            del state
        newest = max(recs)
        return None, None, 0, (f"no slot verified (ledger reaches step "
                               f"{newest}); restart from scratch")

    def _read_state(self, slot: int, template):
        """The slot's state on the device, or None where it is torn."""
        flat = self.store.read_slot(slot)
        if flat is None:
            return None
        try:
            return unflatten_state(template, flat, device=self.device)
        except (KeyError, ValueError):
            return None

    def _record(self, t: int, loss: float, cks) -> LedgerRecord:
        return LedgerRecord(
            step=t, rng_seed=self.tcfg.seed, cursor=[self.tcfg.seed, t + 1, 0],
            cks_params=flatten_checksums(cks["params"]),
            cks_opt=flatten_checksums(cks["opt"]),
            cks_updates=flatten_checksums(cks["updates"]), loss=loss)

    def _host_state(self, params, opt_state, t: int):
        with tracing.span("adcc.host_copy", t, timed=True) as sp:
            flat = flatten_state({"params": params, "opt": opt_state},
                                 keep=self.writes)
        self.timings["host_copy"].append(sp.seconds)
        return flat

    # -- main loop ------------------------------------------------------------------
    def run(self, steps: int, crash_at_step: Optional[int] = None,
            log_every: int = 10) -> TrainerResult:
        with tracing.span("train.run"):
            return self._run(steps, crash_at_step, log_every)

    def _run(self, steps: int, crash_at_step: Optional[int],
             log_every: int) -> TrainerResult:
        with tracing.span("train.recover"):
            params, opt_state, start, report = self._try_recover()
        resumed_from = start - 1 if start > 0 else None
        if params is None:
            params = self.api.init(torch.Generator(device=self.device)
                                   .manual_seed(self.tcfg.seed))
            if self.ranked:
                params = place_model(params, self.rules)
            opt_state = self.opt_init(params)
        err_state = (init_error_state(dict(params.named_parameters()))
                     if self.tcfg.grad_compression == "int8" else {})

        losses: List[float] = []
        times: List[float] = []
        t = start
        while t < steps:
            with tracing.span("train.step", t, timed=True) as step:
                with tracing.span("train.batch", t):
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in self.pipeline.batch_at(t).items()}
                params, opt_state, err_state, metrics, cks = self.step_fn(
                    params, opt_state, err_state, batch,
                    step_generator(self.tcfg.seed, t, self.device))
                with tracing.span("train.loss_sync", t):
                    loss = float(metrics["loss"])
                losses.append(loss)
                self._adcc(t, loss, cks, params, opt_state)

            times.append(step.seconds)
            self.monitor.record(t, step.seconds)
            if log_every and t % log_every == 0:
                print(f"step {t:5d} loss {loss:.4f} "
                      f"({step.seconds*1e3:.0f} ms)", flush=True)

            if crash_at_step is not None and t == crash_at_step:
                self.crash()
                return TrainerResult(t, losses, resumed_from, report, times)
            t += 1

        if self.writer is not None:
            with tracing.span("adcc.drain"):
                self.writer.drain()
        self.ledger.close()
        self._barrier()
        self._final_params = params  # for tests
        self._final_opt = opt_state
        return TrainerResult(steps - 1, losses, resumed_from, report, times)

    def _adcc(self, t: int, loss: float, cks, params, opt_state) -> None:
        """The ADCC layer's work after step ``t``: per the mode, the
        ledger record and a slot step's host copy and write."""
        slot_step = (t + 1) % self.slot_every == 0
        # (3) synchronous tiny ledger write — the "one cache line"
        if self.writes and (self.mode == "adcc"
                            or (self.mode == "sync" and slot_step)):
            with tracing.span("adcc.record", t):
                rec = self._record(t, loss, cks)
            with tracing.span("adcc.ledger_append", t, timed=True) as sp:
                self.ledger.append(rec)
            self.timings["ledger_append"].append(sp.seconds)
        if self.mode == "adcc" and slot_step:
            # (4) async fence-free heavy-state write
            flat = self._host_state(params, opt_state, t)
            if self.writes:
                with tracing.span("adcc.submit", t):
                    self.writer.submit(t, flat)
            del flat
        elif self.mode == "sync" and slot_step:
            # traditional checkpoint: blocking full copy + ledger
            flat = self._host_state(params, opt_state, t)
            with tracing.span("adcc.sync_write", t, timed=True) as sp:
                if self.writes:
                    self.store.write_slot(
                        self.store.slot_for_step((t + 1) // self.slot_every),
                        t, flat)
                del flat
            self.timings["slot_write"].append(sp.seconds)

    def crash(self) -> None:
        """Simulated node failure: in-flight async writes torn, process
        state dropped. (Real deployment: the job simply dies.)"""
        if self.writer is not None:
            self.writer.crash()
        self.ledger.close()
        self._crashed = True
        self._barrier()

    def _barrier(self) -> None:
        """Across ranks, wait until rank 0's files are final."""
        if self.ranked:
            dist.barrier()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ADCC trainer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-scale config")
    ap.add_argument("--mode", default="adcc",
                    choices=["adcc", "sync", "none"])
    ap.add_argument("--slot-every", type=int, default=8)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    args = ap.parse_args(argv)
    # before the first cuBLAS call of the process (launch/steps.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(optimizer=args.optimizer, remat=args.remat,
                       grad_compression=args.grad_compression)
    trainer = ADCCTrainer(cfg, tcfg, args.workdir, batch=args.batch,
                          seq=args.seq, slot_every=args.slot_every,
                          mode=args.mode)
    res = trainer.run(args.steps, crash_at_step=args.crash_at)
    print(f"done: final step {res.final_step}, resumed_from="
          f"{res.resumed_from}, recovery: {res.recovery_report}")
    if res.losses:
        print(f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")


if __name__ == "__main__":
    main()

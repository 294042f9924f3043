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
only inside ``use_device("cpu")``) and records where its time goes in
``timings``: seconds of each ledger append, each host copy of the state,
each synchronous slot write, and the recovery's reads and checks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core.acc_state import (ChecksumLedger, LedgerRecord, flatten_checksums,
                              verify_state_against_record)
from ..core.slots import (AsyncSlotWriter, SlotStore, flatten_state,
                          unflatten_state)
from ..data.pipeline import SyntheticPipeline
from ..device import get_device
from ..models.registry import build_model, get_config
from ..optim import init_error_state
from .mesh import one_card, single_device_mesh
from .steps import build_train_step

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
        builds its one-device mesh) or a mesh of one card; training
        across ranks raises (ROADMAP A10b.7b).
        ``deterministic``: run each step with deterministic algorithms
        (needed for bitwise recovery on the card; launch/steps.py)."""
        if mode not in ("adcc", "sync", "none"):
            raise ValueError(f"mode {mode!r}: adcc, sync or none")
        # the reference's trainer builds a one-device mesh when given none,
        # and its step runs the model on it (MoE: the expert-parallel path)
        self.mesh = one_card(mesh) or single_device_mesh()
        self.cfg, self.tcfg = cfg, tcfg
        self.workdir = workdir
        self.batch, self.seq = batch, seq
        self.slot_every, self.mode = slot_every, mode
        self.device = get_device()
        os.makedirs(workdir, exist_ok=True)

        self.api = build_model(cfg)
        self.pipeline = SyntheticPipeline(cfg, batch, seq, seed=tcfg.seed)
        self.step_fn, self.info, self.opt_init = build_train_step(
            self.api, tcfg, self.mesh, donate=True,
            deterministic=deterministic)
        self.ledger = ChecksumLedger(os.path.join(workdir, "ledger.jsonl"))
        self.store = SlotStore(os.path.join(workdir, "slots"), n_slots)
        self.writer = AsyncSlotWriter(self.store) if mode == "adcc" else None
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
        recs = {r.step: r for r in self.ledger.validated_records()}
        if not recs:
            return None, None, 0, "no ledger"
        abstract = self.api.abstract_init()
        template = {"params": abstract, "opt": self.opt_init(abstract)}
        for slot, step in self.store.slots_by_recency():
            rec = recs.get(step)
            if rec is None:
                continue
            t0 = time.perf_counter()
            flat = self.store.read_slot(slot)
            if flat is None:
                continue
            try:
                state = unflatten_state(template, flat, device=self.device)
            except (KeyError, ValueError):
                continue  # torn slot: missing/short leaves
            del flat
            t1 = time.perf_counter()
            ok, bad = verify_state_against_record(
                state["params"], state["opt"], rec)
            t2 = time.perf_counter()
            self.timings["recover_read"].append(t1 - t0)
            self.timings["recover_verify"].append(t2 - t1)
            self.recovery_checks.append((slot, step, bad))
            if ok:
                return (state["params"], state["opt"], step + 1,
                        f"slot {slot} @ step {step} verified")
            del state
        newest = max(recs)
        return None, None, 0, (f"no slot verified (ledger reaches step "
                               f"{newest}); restart from scratch")

    def _record(self, t: int, loss: float, cks) -> LedgerRecord:
        return LedgerRecord(
            step=t, rng_seed=self.tcfg.seed, cursor=[self.tcfg.seed, t + 1, 0],
            cks_params=flatten_checksums(cks["params"]),
            cks_opt=flatten_checksums(cks["opt"]),
            cks_updates=flatten_checksums(cks["updates"]), loss=loss)

    def _host_state(self, params, opt_state):
        t0 = time.perf_counter()
        flat = flatten_state({"params": params, "opt": opt_state})
        self.timings["host_copy"].append(time.perf_counter() - t0)
        return flat

    # -- main loop ------------------------------------------------------------------
    def run(self, steps: int, crash_at_step: Optional[int] = None,
            log_every: int = 10) -> TrainerResult:
        params, opt_state, start, report = self._try_recover()
        resumed_from = start - 1 if start > 0 else None
        if params is None:
            params = self.api.init(torch.Generator(device=self.device)
                                   .manual_seed(self.tcfg.seed))
            opt_state = self.opt_init(params)
        err_state = (init_error_state(dict(params.named_parameters()))
                     if self.tcfg.grad_compression == "int8" else {})

        losses: List[float] = []
        times: List[float] = []
        t = start
        while t < steps:
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(t).items()}
            params, opt_state, err_state, metrics, cks = self.step_fn(
                params, opt_state, err_state, batch,
                step_generator(self.tcfg.seed, t, self.device))
            loss = float(metrics["loss"])
            losses.append(loss)
            slot_step = (t + 1) % self.slot_every == 0

            # (3) synchronous tiny ledger write — the "one cache line"
            if self.mode == "adcc" or (self.mode == "sync" and slot_step):
                rec = self._record(t, loss, cks)
                ta = time.perf_counter()
                self.ledger.append(rec)
                self.timings["ledger_append"].append(time.perf_counter() - ta)
            if self.mode == "adcc" and slot_step:
                # (4) async fence-free heavy-state write
                self.writer.submit(t, self._host_state(params, opt_state))
            elif self.mode == "sync" and slot_step:
                # traditional checkpoint: blocking full copy + ledger
                flat = self._host_state(params, opt_state)
                tw = time.perf_counter()
                self.store.write_slot(
                    self.store.slot_for_step((t + 1) // self.slot_every),
                    t, flat)
                del flat
                self.timings["slot_write"].append(time.perf_counter() - tw)

            dt_step = time.perf_counter() - t0
            times.append(dt_step)
            self.monitor.record(t, dt_step)
            if log_every and t % log_every == 0:
                print(f"step {t:5d} loss {loss:.4f} "
                      f"({dt_step*1e3:.0f} ms)", flush=True)

            if crash_at_step is not None and t == crash_at_step:
                self.crash()
                return TrainerResult(t, losses, resumed_from, report, times)
            t += 1

        if self.writer is not None:
            self.writer.drain()
        self.ledger.close()
        self._final_params = params  # for tests
        self._final_opt = opt_state
        return TrainerResult(steps - 1, losses, resumed_from, report, times)

    def crash(self) -> None:
        """Simulated node failure: in-flight async writes torn, process
        state dropped. (Real deployment: the job simply dies.)"""
        if self.writer is not None:
            self.writer.crash()
        self.ledger.close()
        self._crashed = True


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

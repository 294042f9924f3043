"""Multi-slot asynchronous state store with verified recovery.

A copy of the JAX package's ``core/slots.py``. ``SlotStore`` and
``AsyncSlotWriter`` are numpy and threads, unchanged but for the writer's
span ``slot.write`` (``repro_torch.tracing``) for each slot (its
``step`` the state's, fed into ``write_seconds`` when the slot is
complete) and its counter ``slot.bytes`` of the arrays it saves.
``flatten_state`` / ``unflatten_state`` take the port's state
``{"params": LM, "opt": ...}`` to and from the keys and stacked layout
that the reference's ``flatten_state`` gives for its own state
(``params/layers/attn/wq`` as (L, in, out), ``opt/m/...``, ``opt/step``
int32), so a slot written by either package restores in the other. The
copy to the host is synchronous, on the caller's thread, as in the
reference.

The heavy training state (params + optimizer state) is written
round-robin into K slots with **no synchronous barrier** — the
accelerator analogue of the paper's reliance on hardware cache eviction:
writes drain opportunistically; a crash mid-write tears the slot. Recovery
backward-scans slots newest-first (paper §III.B) and accepts the first
slot whose every tensor verifies against the synchronously-persisted
checksum ledger (core/acc_state.py).

Format per slot directory:
    meta.json            {"step": int, "complete": bool}
    <flat-key>.npy       one file per pytree leaf (numpy, host layout)

``complete`` is written LAST — but recovery must not trust it (a torn
filesystem can persist meta before data); it is only a fast-path hint.
Verification is always checksum-based.

``AsyncSlotWriter`` runs writes on a daemon thread; ``crash()`` abandons
the queue mid-flight exactly like a real power loss would.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import tracing
from ..models.carry import (global_tensor, nest, opt_from_reference,
                            opt_tree, params_from_reference, reference_tree,
                            to_host, tree_items)

__all__ = ["SlotStore", "AsyncSlotWriter", "flatten_state", "unflatten_state"]


def flatten_state(state, keep: bool = True
                  ) -> Optional[Dict[str, np.ndarray]]:
    """{"params": LM, "opt": optimizer state} -> {path: ndarray} with the
    reference's '/'-joined keys and stacked layers. DTensor leaves (state
    across the ranks of a DeviceMesh) become their global arrays, as the
    reference stores them: every rank must call this on its main thread,
    leaf for leaf in the same order, for the gathers to pair up; with
    ``keep`` False it runs the gathers and keeps nothing (None)."""
    lm = state["params"]
    cfg = lm.cfg
    tree = {"params": reference_tree(cfg, dict(lm.named_parameters())),
            "opt": opt_tree(cfg, state["opt"])}
    if keep:
        return {path: to_host(leaf) for path, leaf in tree_items(tree)}
    for _, leaf in tree_items(tree):
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            global_tensor(t.detach())
    return None


def unflatten_state(template, flat: Dict[str, np.ndarray], device=None):
    """Rebuild ``{"params": LM, "opt": state}`` on ``device`` (default
    :func:`repro_torch.get_device`) from the flat dict. ``template`` is a
    state of the same configuration and optimizer (its LM may lie on the
    ``meta`` device). Raises KeyError or ValueError for a missing or
    short leaf, as a torn slot gives."""
    cfg = template["params"].cfg
    tree = nest(flat)
    opt = opt_from_reference(cfg, tree["opt"], device=device)
    if type(opt) is not type(template["opt"]):
        raise ValueError(f"slot holds {type(opt).__name__}, template "
                         f"{type(template['opt']).__name__}")
    return {"params": params_from_reference(cfg, tree["params"],
                                            device=device),
            "opt": opt}


class SlotStore:
    def __init__(self, root: str, n_slots: int = 3):
        self.root = root
        self.n_slots = n_slots
        os.makedirs(root, exist_ok=True)

    def slot_dir(self, k: int) -> str:
        return os.path.join(self.root, f"slot_{k}")

    def slot_for_step(self, step: int) -> int:
        return (step // 1) % self.n_slots  # round-robin by write index

    # -- write (synchronous core; async wrapper below) -------------------------
    def write_slot(self, k: int, step: int, state_flat: Dict[str, np.ndarray],
                   tear_after: Optional[int] = None) -> None:
        """Write slot k. ``tear_after`` (tests only) aborts after N leaves,
        emulating a crash mid-write."""
        d = self.slot_dir(k)
        tmp_meta = {"step": step, "complete": False}
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump(tmp_meta, fh)
        for i, (key, arr) in enumerate(sorted(state_flat.items())):
            if tear_after is not None and i >= tear_after:
                return  # torn: remaining leaves keep their old bytes
            np.save(os.path.join(d, key.replace("/", "__") + ".npy"), arr)
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump({"step": step, "complete": True}, fh)

    # -- read -------------------------------------------------------------------
    def read_meta(self, k: int) -> Optional[Dict]:
        try:
            with open(os.path.join(self.slot_dir(k), "meta.json")) as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None

    def read_slot(self, k: int) -> Optional[Dict[str, np.ndarray]]:
        d = self.slot_dir(k)
        if not os.path.isdir(d):
            return None
        out = {}
        for fn in os.listdir(d):
            if fn.endswith(".npy"):
                try:
                    out[fn[:-4].replace("__", "/")] = np.load(
                        os.path.join(d, fn))
                except (OSError, ValueError):
                    return None  # torn file
        return out or None

    def slots_by_recency(self) -> List[Tuple[int, int]]:
        """[(slot, step)] sorted newest first."""
        metas = []
        for k in range(self.n_slots):
            m = self.read_meta(k)
            if m is not None and "step" in m:
                metas.append((k, int(m["step"])))
        return sorted(metas, key=lambda t: -t[1])

    def wipe(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(self.root, exist_ok=True)


class AsyncSlotWriter:
    """Daemon-thread writer: enqueue state snapshots; crash() drops the
    queue and kills the in-flight write at the next leaf boundary."""

    def __init__(self, store: SlotStore):
        self.store = store
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._crashed = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._busy = threading.Lock()
        self._write_idx = 0
        self.write_seconds: List[float] = []   # per completed slot
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, step: int, state_flat: Dict[str, np.ndarray]) -> None:
        slot = self._write_idx % self.store.n_slots
        self._write_idx += 1
        self._idle.clear()
        self._q.put((slot, step, state_flat))

    def _run(self) -> None:
        while True:
            slot, step, flat = self._q.get()
            with self._busy:
                if not self._crashed.is_set():
                    with tracing.span("slot.write", step, timed=True) as sp:
                        done = self._write(slot, step, flat)
                    if done:
                        self.write_seconds.append(sp.seconds)
            del flat    # the host copy is not held while the queue waits
            if self._q.empty():
                self._idle.set()

    def _write(self, slot: int, step: int, flat) -> bool:
        """Whether the slot was written whole."""
        d = self.store.slot_dir(slot)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump({"step": step, "complete": False}, fh)
        for key, arr in sorted(flat.items()):
            if self._crashed.is_set():
                return False  # power loss mid-write: slot is torn
            np.save(os.path.join(d, key.replace("/", "__") + ".npy"), arr)
            tracing.count("slot.bytes", arr.nbytes)
        if self._crashed.is_set():
            return False
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump({"step": step, "complete": True}, fh)
        return True

    def drain(self, timeout: float = 60.0) -> None:
        self._idle.wait(timeout)

    def crash(self) -> None:
        """Simulated power loss: abandon queued + in-flight writes. Returns
        once the thread has stopped at a leaf boundary, so the files on
        disk no longer change (ranks that read them next read the
        same)."""
        self._crashed.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        with self._busy:
            pass

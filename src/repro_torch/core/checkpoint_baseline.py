"""Traditional checkpoint baselines (paper test cases 2-4).

Checkpoint = copy every critical data object to a persistent target.
For memory-based targets (NVM-only / heterogeneous NVM+DRAM) checkpoint
is "data copy + cache flush" (paper §III.A); for the hard-drive target
it is a file-speed copy. Costs are charged through the emulator's
bandwidth model so the paper's Figure 4/8/13 comparisons reproduce.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from .nvm import CrashEmulator
from .regions import PersistentRegion

__all__ = ["CheckpointBaseline", "CHECKPOINT_TARGETS"]

CHECKPOINT_TARGETS = ("hdd", "nvm_only", "nvm_dram")


class CheckpointBaseline:
    """Synchronous full-copy checkpoint of a set of regions."""

    def __init__(self, emu: CrashEmulator, target: str = "nvm_only"):
        if target not in CHECKPOINT_TARGETS:
            raise ValueError(f"target must be one of {CHECKPOINT_TARGETS}")
        self._emu = emu
        self.target = target
        # checkpoint area: name -> (step, array)
        self._area: Dict[str, np.ndarray] = {}
        self.last_step: int = -1

    def checkpoint(self, step: int, regions: Iterable[PersistentRegion]) -> float:
        """Copy all regions; returns modeled seconds charged."""
        cfg = self._emu.cfg
        stats = self._emu.store.stats
        before = stats.modeled_seconds
        for r in regions:
            data = r.view.copy()  # the copy itself (read side)
            nbytes = data.nbytes
            if self.target == "hdd":
                stats.modeled_seconds += nbytes / cfg.hdd_bw
            elif self.target == "nvm_only":
                # CPU-cache flush of the data object + copy into NVM area
                self._emu.flush(r.name)
                stats.charge_write(nbytes, cfg)
            else:  # nvm_dram: flush CPU caches AND copy through DRAM cache
                self._emu.flush(r.name)
                stats.charge_write(nbytes, cfg)
            self._area[r.name] = data
        if self.target == "nvm_dram":
            # the heterogeneous system must also flush its DRAM cache once
            # per checkpoint (memory copy of the DRAM-cache contents into
            # NVM — paper §III.A; this is what makes the small-object
            # XSBench checkpoints cost 13% on NVM/DRAM, Fig. 13)
            stats.modeled_seconds += cfg.dram_cache_bytes / cfg.dram_bw
            stats.charge_write(cfg.dram_cache_bytes, cfg)
        self.last_step = step
        return stats.modeled_seconds - before

    def restore(self) -> Dict[str, np.ndarray]:
        """Recovery: the checkpointed copies (always consistent)."""
        cfg = self._emu.cfg
        for data in self._area.values():
            self._emu.store.stats.charge_read(data.nbytes, cfg)
        return {k: v.copy() for k, v in self._area.items()}

    # -- snapshot / fork ------------------------------------------------------
    def state_snapshot(self) -> Dict[str, object]:
        # checkpoint() replaces area arrays wholesale and restore()
        # hands out copies, so a shallow dict copy is a true capture
        return {"last_step": self.last_step, "area": dict(self._area)}

    def restore_state(self, state: Dict[str, object]) -> None:
        self.last_step = state["last_step"]
        self._area = dict(state["area"])

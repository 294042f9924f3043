"""Iteration-versioned persistent arrays — the paper's CG extension.

The paper adds an iteration dimension to CG's four hot vectors so that
each iteration's values land in distinct cache lines / NVM locations and
are never overwritten (Fig. 2). :class:`VersionedArray` wraps a
``(versions, n)`` PersistentRegion with iteration-indexed access, and
:class:`FlushedCounter` is the "flush the cache line containing i"
primitive used by all three algorithms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .nvm import CrashEmulator
from .regions import PersistentRegion

__all__ = ["VersionedArray", "FlushedCounter"]


class VersionedArray:
    """A vector with an added iteration dimension, stored in NVM."""

    def __init__(self, emu: CrashEmulator, name: str, versions: int, n: int,
                 dtype=np.float64, sector_lines: int = 1):
        self.region: PersistentRegion = emu.alloc(
            name, (versions, n), dtype, sector_lines=sector_lines)
        self.versions = versions
        self.n = n

    def set(self, i: int, value: np.ndarray) -> None:
        self.region[i, :] = value

    def get(self, i: int) -> np.ndarray:
        return self.region[i, :]

    def nvm_version(self, i: int) -> np.ndarray:
        """Post-crash NVM view of version i (no cache interaction)."""
        return self.region.nvm[i]

    def flush_version(self, i: int) -> None:
        self.region.flush((i, slice(None)))


class FlushedCounter:
    """A persistent scalar counter whose cache line is flushed on every
    update — the paper's single-cache-line-per-iteration overhead."""

    def __init__(self, emu: CrashEmulator, name: str):
        self.region = emu.alloc(name, (1,), np.int64)

    def set(self, value: int) -> None:
        self.region[0] = value
        self.region.flush()

    def nvm_value(self) -> int:
        return int(self.region.nvm[0])

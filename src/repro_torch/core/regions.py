"""ndarray facade over the crash emulator.

A :class:`PersistentRegion` behaves like a numpy array whose loads and
stores are routed through the emulated volatile cache, so that after
``CrashEmulator.crash()`` the region's contents silently revert to
whatever had reached NVM. Slicing covers the common access shapes used
by the paper's three algorithms (whole-array, 1-D ranges, row blocks of
2-D arrays, scalar elements).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["PersistentRegion"]


def _flat_span(shape: Tuple[int, ...], index) -> Tuple[int, int]:
    """Map a (supported) index into a [lo, hi) span over the flattened
    buffer. Supported: Ellipsis/':', int, slice, and tuples thereof where
    only the *leading* axes are restricted (row-major contiguity)."""
    if index is Ellipsis:
        return 0, int(np.prod(shape))
    if not isinstance(index, tuple):
        index = (index,)
    lo = 0
    span = int(np.prod(shape))
    for ax, idx in enumerate(index):
        extent = shape[ax]
        span //= extent
        if isinstance(idx, (int, np.integer)):
            lo += (int(idx) % extent) * span
        elif isinstance(idx, slice):
            start, stop, step = idx.indices(extent)
            if step != 1:
                raise IndexError("strided slices unsupported on PersistentRegion")
            lo += start * span
            # a slice freezes the span to (stop-start) * inner; further
            # restriction only allowed if this slice is the last axis given
            if ax != len(index) - 1 and (stop - start) != extent and any(
                not (isinstance(j, slice) and j == slice(None)) for j in index[ax + 1:]
            ):
                raise IndexError("non-contiguous multi-axis slicing unsupported")
            return lo, lo + (stop - start) * span
        elif idx is Ellipsis:
            return lo, lo + span * extent
        else:
            raise IndexError(f"unsupported index component {idx!r}")
    # all given axes were ints
    return lo, lo + span


class PersistentRegion:
    """An array living in emulated NVM behind an emulated volatile cache."""

    def __init__(self, emu, name: str, shape: Tuple[int, ...], dtype: np.dtype):
        self._emu = emu
        self.name = name
        self.shape = shape
        self.dtype = dtype

    # -- views -----------------------------------------------------------------
    @property
    def view(self) -> np.ndarray:
        """Latest program-visible values (truth). Mutating this directly
        bypasses cache accounting — use __setitem__ instead."""
        return self._emu.truth_flat(self.name).reshape(self.shape)

    @property
    def nvm(self) -> np.ndarray:
        """What would survive a crash right now."""
        return self._emu.post_crash_view(self.name)

    # -- array protocol ----------------------------------------------------------
    def __getitem__(self, index) -> np.ndarray:
        lo, hi = _flat_span(self.shape, index)
        self._emu.read(self.name, lo, hi)
        return self.view[index]

    def __setitem__(self, index, value) -> None:
        lo, hi = _flat_span(self.shape, index)
        self.view[index] = value
        self._emu.write(self.name, lo, hi)

    def __array__(self, dtype=None):
        out = self.__getitem__(Ellipsis)
        return out.astype(dtype) if dtype is not None else out

    # -- persistence ops --------------------------------------------------------
    def flush(self, index=Ellipsis) -> None:
        """CLFLUSH the lines covering ``index``."""
        lo, hi = _flat_span(self.shape, index)
        self._emu.flush(self.name, lo, hi)

    def nbytes_span(self, index=Ellipsis) -> int:
        lo, hi = _flat_span(self.shape, index)
        return (hi - lo) * self.dtype.itemsize

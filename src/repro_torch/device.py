"""Which torch device the port's device math runs on.

The default is the CUDA card. Asking for the default on a host without
one raises — nothing here carries on on the CPU by itself. A caller who
wants the CPU (the parity tests do) says so with :func:`use_device`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["get_device", "selected_device", "use_device"]

_selected: Optional[torch.device] = None


def get_device() -> torch.device:
    """The device selected by the innermost :func:`use_device`, else
    ``cuda``; raises when that default is asked for without a card."""
    if _selected is not None:
        return _selected
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs its device math on a CUDA card and "
            "torch.cuda.is_available() is False; wrap the call in "
            "repro_torch.use_device('cpu') to run it on the CPU")
    return torch.device("cuda")


def selected_device() -> Optional[torch.device]:
    """The explicit selection in force, or None when calls would get the
    default. A parent hands this to the worker processes it starts: a
    spawned child begins with no selection of its own."""
    return _selected


@contextlib.contextmanager
def use_device(dev: Union[str, torch.device]) -> Iterator[torch.device]:
    """Select ``dev`` for the enclosed calls (nestable)."""
    global _selected
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"use_device({str(dev)!r}): no CUDA card here")
    prev, _selected = _selected, dev
    try:
        yield dev
    finally:
        _selected = prev

"""Invariant registry — the "algorithm knowledge" the paper consults.

An :class:`Invariant` is a named predicate over the post-crash NVM view
of a set of data objects. The recovery engine (recovery.py) scans
candidate restart points and accepts the newest one whose invariants all
hold. Built-in invariant families:

  OrthogonalityInvariant   p^T q == 0                   (CG, Eq. 1)
  ResidualInvariant        r == b - A z                 (CG, Eq. 2)
  ChecksumInvariant        ABFT row/col sums hold       (MM, Eq. 6)
  ScalarChecksumInvariant  sum(x) == recorded checksum  (training state)

Tolerances are relative to data magnitude: the point is to distinguish
"torn write / stale garbage" from "valid iterate", and torn data misses
by many orders of magnitude.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from . import abft

__all__ = [
    "Invariant",
    "CheckResult",
    "OrthogonalityInvariant",
    "ResidualInvariant",
    "ChecksumInvariant",
    "ScalarChecksumInvariant",
    "InvariantSet",
]


@dataclasses.dataclass
class CheckResult:
    name: str
    ok: bool
    error: float  # scalar badness measure (0 when ok)
    detail: str = ""


class Invariant:
    name: str = "invariant"

    def check(self, data: Dict[str, np.ndarray]) -> CheckResult:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class OrthogonalityInvariant(Invariant):
    """|p^T q| / (|p||q|) <= tol  — CG Eq. 1."""

    p_key: str
    q_key: str
    tol: float = 1e-8
    name: str = "orthogonality"

    def check(self, data: Dict[str, np.ndarray]) -> CheckResult:
        p, q = data[self.p_key], data[self.q_key]
        denom = float(np.linalg.norm(p) * np.linalg.norm(q)) + 1e-300
        err = abs(float(p @ q)) / denom
        return CheckResult(self.name, err <= self.tol, err,
                           f"|p.q|/|p||q| = {err:.3e}")


@dataclasses.dataclass
class ResidualInvariant(Invariant):
    """||r - (b - A z)|| / ||b|| <= tol — CG Eq. 2. ``matvec`` computes
    A @ z so sparse A never needs densifying."""

    r_key: str
    z_key: str
    b: np.ndarray
    matvec: Callable[[np.ndarray], np.ndarray]
    tol: float = 1e-6
    name: str = "residual"

    def check(self, data: Dict[str, np.ndarray]) -> CheckResult:
        r, z = data[self.r_key], data[self.z_key]
        err = float(np.linalg.norm(r - (self.b - self.matvec(z))))
        rel = err / (float(np.linalg.norm(self.b)) + 1e-300)
        return CheckResult(self.name, rel <= self.tol, rel,
                           f"||r-(b-Az)||/||b|| = {rel:.3e}")


@dataclasses.dataclass
class ChecksumInvariant(Invariant):
    """ABFT row+column checksum relationships on a full-checksum matrix."""

    key: str
    rtol: float = 1e-8
    atol: float = 1e-6
    name: str = "abft_checksum"

    def check(self, data: Dict[str, np.ndarray]) -> CheckResult:
        Cf = data[self.key]
        row, col = abft.residuals(Cf)
        err = float(max(np.max(np.abs(row)), np.max(np.abs(col))))
        ok = abft.verify(Cf, self.rtol, self.atol)
        return CheckResult(self.name, ok, err, f"max checksum residual {err:.3e}")


@dataclasses.dataclass
class ScalarChecksumInvariant(Invariant):
    """sum(x) matches an independently persisted scalar checksum — the
    training-state invariant (checksums maintained incrementally because
    optimizer updates are linear in the applied step)."""

    key: str
    expected: float
    rtol: float = 1e-6
    atol: float = 1e-8
    name: str = "scalar_checksum"

    def check(self, data: Dict[str, np.ndarray]) -> CheckResult:
        got = float(np.sum(np.asarray(data[self.key], dtype=np.float64)))
        tol = self.atol + self.rtol * max(abs(self.expected), 1.0)
        err = abs(got - self.expected)
        return CheckResult(self.name, err <= tol, err,
                           f"sum={got:.9g} expected={self.expected:.9g}")


class InvariantSet:
    """All invariants must hold for a restart point to be accepted."""

    def __init__(self, invariants: Optional[List[Invariant]] = None):
        self.invariants: List[Invariant] = list(invariants or [])

    def add(self, inv: Invariant) -> "InvariantSet":
        self.invariants.append(inv)
        return self

    def check_all(self, data: Dict[str, np.ndarray]) -> List[CheckResult]:
        return [inv.check(data) for inv in self.invariants]

    def holds(self, data: Dict[str, np.ndarray]) -> bool:
        return all(res.ok for res in self.check_all(data))

"""The paper's three case studies, runnable on the crash emulator:

  cg        — Conjugate Gradient with versioned arrays + invariant recovery (§III.B)
  mm_abft   — ABFT matrix multiplication, two-loop decomposition (§III.C)
  xsbench   — Monte-Carlo cross-section lookup with selective flushing (§III.D)
"""

from . import cg, mm_abft, xsbench  # noqa: F401

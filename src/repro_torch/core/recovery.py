"""Backward-scan recovery engine (paper §III.B recovery procedure).

After a crash, the newest persisted iteration counter bounds the search:
starting from iteration i (or slot k), test the algorithm's invariants
against the post-crash NVM view of each candidate; accept the first
(newest) candidate where every invariant holds. The engine reports both
the chosen restart point and the *detection cost* (modeled seconds spent
reading NVM to evaluate invariants), which benchmarks/fig3 breaks out as
"detecting where to restart".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .invariants import CheckResult, InvariantSet

__all__ = ["RecoveryOutcome", "backward_scan"]


@dataclasses.dataclass
class RecoveryOutcome:
    restart_point: int          # iteration/slot to restart from; -1 => none found
    candidates_tested: int
    detection_seconds: float    # modeled NVM-read + invariant-eval time
    reports: List[List[CheckResult]]

    @property
    def found(self) -> bool:
        return self.restart_point >= 0


def backward_scan(
    newest: int,
    oldest: int,
    load_candidate: Callable[[int], Dict[str, np.ndarray]],
    invariants_for: Callable[[int], InvariantSet],
    charge_read_seconds: Optional[Callable[[Dict[str, np.ndarray]], float]] = None,
) -> RecoveryOutcome:
    """Scan candidates newest -> oldest (inclusive); return the first
    consistent one.

    load_candidate(j)  -> post-crash NVM views of iteration/slot j's objects
    invariants_for(j)  -> the InvariantSet that must hold at j
    charge_read_seconds(data) -> modeled cost of reading `data` from NVM
    """
    reports: List[List[CheckResult]] = []
    detect_s = 0.0
    tested = 0
    for j in range(newest, oldest - 1, -1):
        data = load_candidate(j)
        tested += 1
        if charge_read_seconds is not None:
            detect_s += charge_read_seconds(data)
        results = invariants_for(j).check_all(data)
        reports.append(results)
        if all(r.ok for r in results):
            return RecoveryOutcome(j, tested, detect_s, reports)
    return RecoveryOutcome(-1, tested, detect_s, reports)

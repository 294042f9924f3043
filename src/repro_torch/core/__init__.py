"""repro_torch.core — the paper's primary contribution: algorithm-directed
crash consistence (ADCC) for NVM, on a PyTorch/CUDA device-math layer.

Substrate (paper SIII.A):
  nvm, regions            emulated NVM + volatile cache + crash semantics
  backends                pluggable cache emulation: exact per-entry
                          "reference" oracle / batched "vectorized" default
Baselines (paper test cases 2-5):
  checkpoint_baseline     synchronous full-copy checkpoint (hdd/nvm/nvm+dram)
  transactions            PMEM-style undo-log transactions
Algorithm knowledge (paper SIII.B-D):
  abft                    checksum algebra (Eqs. 3-6)
  invariants              invariant registry (orthogonality/residual/checksum)
  recovery                backward-scan restart-point search
  versioned               iteration-versioned persistent arrays
The scenario layer above this package (``repro_torch.scenarios``) composes
these pieces into the unified Workload x ConsistencyStrategy x CrashPlan
experiment matrix: strategies there wrap CheckpointBaseline / TxManager /
the ADCC paths, and run_scenario()/sweep() drive them over the emulator.
"""

from .backends import (
    BACKENDS,
    MemoryBackend,
    ReferenceLRUBackend,
    VectorizedBackend,
    make_backend,
)
from .nvm import CrashEmulator, NVMConfig, NVMStore, TrafficStats, VolatileCache
from .regions import PersistentRegion
from .invariants import (
    ChecksumInvariant,
    InvariantSet,
    OrthogonalityInvariant,
    ResidualInvariant,
    ScalarChecksumInvariant,
)
from .recovery import RecoveryOutcome, backward_scan
from .transactions import TxManager, UndoLogTx
from .checkpoint_baseline import CheckpointBaseline

__all__ = [
    "CrashEmulator", "NVMConfig", "NVMStore", "TrafficStats", "VolatileCache",
    "MemoryBackend", "ReferenceLRUBackend", "VectorizedBackend",
    "BACKENDS", "make_backend",
    "PersistentRegion",
    "ChecksumInvariant", "InvariantSet", "OrthogonalityInvariant",
    "ResidualInvariant", "ScalarChecksumInvariant",
    "RecoveryOutcome", "backward_scan",
    "TxManager", "UndoLogTx", "CheckpointBaseline",
]

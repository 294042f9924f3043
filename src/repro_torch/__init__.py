"""repro_torch — the PyTorch/CUDA port of ``repro``.

Same directory and module names as the JAX package, so each module's
counterpart is found at the same relative path. The package imports
``torch`` and ``numpy`` only; the integrity kernels are hand-written
CUDA C++ (``kernels/csrc``) built with ``nvcc`` at their first launch.

  device      which torch device the device-math layer runs on
  core        NVM crash emulator, ABFT algebra, invariants, batched
              device math (``core.backends.batched``)
  algorithms  the paper's case studies (CG, ABFT matmul, XSBench)
  scenarios   Workload x ConsistencyStrategy x CrashPlan sweeps,
              including ``sweep(engine="fork", mode="batched")``
  kernels     the CUDA kernels, their wrappers and plain versions
  tracing     the trainer's spans and counters, in memory, on the
              profiler's clock
"""

from .device import get_device, use_device

__all__ = ["get_device", "use_device"]

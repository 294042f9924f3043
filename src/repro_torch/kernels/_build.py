"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, no ``ninja``. The library's file name carries a hash
of the source and the flags, so a changed source is rebuilt and an
unchanged one is reused. Nothing is built when the package is imported:
the first launch on a CUDA tensor calls :func:`load`.

The build directory is ``build/repro_torch/`` beside ``src/``. Every
compile runs with ``-Xptxas -v``, so the build log states each kernel's registers, shared
memory and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "build_all", "load",
           "source_names"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def source_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> the directory that holds src/
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch cannot be built on this host")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all of ``csrc``) that has no
    up-to-date library yet, one ``nvcc`` process each, all started
    together. Returns per source ``{"path", "seconds", "log", "built"}``.
    A failed build raises with ``nvcc``'s output."""
    names = list(names) if names is not None else source_names()
    out: Dict[str, dict] = {}
    procs = []
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": target, "seconds": 0.0, "log": "",
                         "built": False}
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        # compile beside the target and rename: a concurrent process
        # building the same source never loads a half-written library
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, cmd, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, target, tmp, cmd, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": target, "seconds": seconds, "log": log,
                     "built": True}
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]["path"]))
        _loaded[name] = lib
    return lib

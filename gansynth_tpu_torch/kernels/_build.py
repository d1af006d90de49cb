"""Builds a CUDA source under ``csrc/`` with plain ``nvcc`` and loads it.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes
no PyTorch header, so it compiles in seconds into its own shared library,
which ``ctypes`` loads. The library lands in
``build/torch_kernels/<sha256 of source and flags>/lib<name>.so`` under
the repository root. It is written to a temporary name and moved into
place with ``os.replace``: an interrupted build leaves no half-written
library behind, and there is no lock file to wait on. A library whose
hash directory already holds it is loaded without a build.

Nothing runs at import time; the first launch of a kernel calls
:func:`load_library`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    path: Path
    lib: ctypes.CDLL
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc's output, with the -Xptxas -v lines


_loaded: Dict[str, KernelLibrary] = {}
_locks: Dict[str, threading.Lock] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and os.path.isfile(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on "
        "PATH (the port's kernels are built from source on first use)"
    )


def _compile(name: str) -> KernelLibrary:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + "\0".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / digest.hexdigest()[:24] / f"lib{name}.so"
    log_path = target.with_suffix(".log")
    if target.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(name, target, ctypes.CDLL(str(target)), 0.0, log)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.tmp-{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, target)
    return KernelLibrary(name, target, ctypes.CDLL(str(target)), seconds, log)


def load_library(name: str) -> KernelLibrary:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Each
    source has its own lock, so threads that load different libraries
    build them at the same time."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            _loaded[name] = _compile(name)
        return _loaded[name]

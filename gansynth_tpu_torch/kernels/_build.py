"""Builds a CUDA source under ``csrc/`` with plain ``nvcc`` and loads it.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes
no PyTorch header (only CUDA's and the shared ``csrc/*.cuh``), so it
compiles in seconds into its own shared library, which ``ctypes`` loads.
The library lands in ``<build dir>/<key>/lib<name>.so``, where the key is
a sha256 of the source, every ``csrc`` header it includes (transitively),
the flags and the output of ``nvcc --version``: an edit to a header or
another toolkit builds anew. The build dir is ``build/torch_kernels``
under the checkout when the package sits in one (its grandparent holds
``pyproject.toml``), else ``$XDG_CACHE_HOME/gansynth_tpu_torch/kernels``
(``~/.cache`` when that is unset), never the installed package's tree. The
library is written to a temporary name and moved into place with
``os.replace``: an interrupted build leaves no half-written library
behind, and there is no lock file to wait on. A library whose key
directory already holds it is loaded without a build.

Nothing runs at import time; the first launch of a kernel calls
:func:`load_library`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
PACKAGE_ROOT = Path(__file__).resolve().parents[2]
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


def build_dir(root: Path = PACKAGE_ROOT) -> Path:
    """Where libraries are built: ``<root>/build/torch_kernels`` when
    ``root`` is a checkout (holds ``pyproject.toml``), else the user's
    cache directory."""
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "gansynth_tpu_torch" / "kernels"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: Path) -> list:
    """The ``csrc`` headers that ``source`` includes with quotes, directly
    or through another header, in a fixed order."""
    seen, todo = [], [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / name
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return sorted(seen)


_nvcc_versions: Dict[str, str] = {}


def nvcc_version(nvcc: str) -> str:
    """``nvcc --version``'s output (read once per compiler)."""
    if nvcc not in _nvcc_versions:
        proc = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True)
        _nvcc_versions[nvcc] = proc.stdout + proc.stderr
    return _nvcc_versions[nvcc]


def build_key(name: str, nvcc: str) -> str:
    """The hash that names a build of ``csrc/<name>.cu``: the source, its
    headers, the flags and the compiler's version."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        digest.update(b"\0" + header.name.encode() + b"\0"
                      + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    digest.update(nvcc_version(nvcc).encode())
    return digest.hexdigest()[:24]


def _compile(name: str) -> KernelLibrary:
    source = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    target = build_dir() / build_key(name, nvcc) / f"lib{name}.so"
    log_path = target.with_suffix(".log")
    if target.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(name, target, ctypes.CDLL(str(target)), 0.0, log)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.tmp-{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
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

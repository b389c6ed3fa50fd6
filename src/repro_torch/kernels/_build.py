"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``.  Libraries go to ``build/kernels/`` at the repository root,
named by a hash of every source under ``csrc/`` and of the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
is built at import time: the first wrapper call on a CUDA tensor builds
(``build_all`` builds every library at once, one ``nvcc`` per source, all
started together).

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}
#: nvcc processes this process has started (a warmed server's request path
#: must start none)
NVCC_RUNS = {"count": 0}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point reported a CUDA error."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only on a "
            "machine with the CUDA toolkit")
    return found


def sources() -> list[str]:
    """Names of the kernel libraries: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    NVCC_RUNS["count"] += 1
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Build every library not built yet, all nvcc processes at once, and
    load them.  Returns name -> library path."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {name: _library_path(name) for name in sources()}
        procs = {name: _start(name, path) for name, path in paths.items()
                 if not path.is_file()}
        try:
            for name, proc in procs.items():
                _finish(name, paths[name], proc)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, path in paths.items():
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(path))
        return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


@functools.cache
def function(lib: str, name: str, argtypes: tuple):
    """The C entry point ``name`` of library ``lib``, typed once (returns
    the launch's ``cudaGetLastError()`` as an int)."""
    fn = getattr(library(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    if status != 0:
        raise KernelLaunchError(f"{what}: CUDA error {status}")

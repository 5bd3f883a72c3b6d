"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and becomes
``build/lib<name>.so`` at the repository root (``build/`` is git-ignored).
A library is rebuilt when it is missing or older than its source or than
any header ``csrc/*.cuh`` (the sources share them).  Nothing
is built at import time: the first call that needs a kernel builds it, or a
caller builds them all up front with :func:`build_all` (one ``nvcc`` process
per source, all started together).

This is a plain-C interface on purpose: a source that includes PyTorch's
headers takes minutes to compile, a plain one seconds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

SOURCES = ("rmsnorm", "flash_attention", "wkv6")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or PATH's."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME, /usr/local/cuda or PATH)")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared ``csrc/*.cuh``."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _start(name: str) -> Tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, lib_path(name))    # atomic: concurrent builds are safe
    return log


def build_all(names: Iterable[str] = SOURCES, *, force: bool = False
              ) -> Dict[str, str]:
    """Compile the named sources in parallel; returns each ``nvcc`` log
    (``-Xptxas -v``: registers, shared memory, spills); ``""`` if fresh."""
    names = list(names)
    with _lock:
        procs = {n: _start(n) for n in names if force or _stale(n)}
        logs = {n: "" for n in names}
        try:
            for n, (p, tmp) in procs.items():
                logs[n] = _finish(n, p, tmp)
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for n in procs:
            _libs.pop(n, None)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    if _stale(name):
        build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def c_args(*types: str) -> List[type]:
    """ctypes argtypes from short codes: p pointer/stream, i int, f float."""
    table = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    return [table[t] for t in types]

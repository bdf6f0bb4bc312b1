"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``).
Nothing is built at import time: a kernel's wrapper calls
:func:`library` when it first launches, and :func:`build` compiles any
number of sources at once, one ``nvcc`` process each, all started
together. A library's file name carries a digest of its source, the
shared headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale build is never loaded.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside each library as ``<name>-<digest>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "sl_matmul": CSRC / "sl_matmul.cu",
    "paged_attention": CSRC / "paged_attention.cu",
    "sddmm": CSRC / "sddmm.cu",
    "adam8bit": CSRC / "adam8bit.cu",
    "sparse_decode": CSRC / "sparse_decode.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all in parallel. Returns {name: library path}; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(names)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name].name} "
                          f"(exit {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader never sees
    if failed:                   # a half-written library
        raise RuntimeError("\n".join(failed))
    return {name: lib_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error: a refused
    launch never runs, and ``torch.cuda.synchronize`` would not report
    it."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

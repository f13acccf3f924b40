"""Build and load the port's CUDA kernels.

Each kernel is one source under ``evennicer_slam_tpu_torch/csrc/`` with a
plain C interface. It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the root of the checkout (git-ignored) the first
time it is asked for, and loaded with ``ctypes``. Importing this module needs
neither ``nvcc`` nor a GPU; only :func:`load_kernel_library` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# what the last build of each library printed (register and shared-memory
# use per kernel from ptxas) and how long it took
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``, or ``RuntimeError`` where the CUDA toolkit is absent."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (looked on PATH, $CUDA_HOME, /usr/local/cuda)"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def start_build(name: str, extra_flags: Sequence[str] = ()) -> dict:
    """Start ``nvcc`` for ``csrc/<name>.cu`` without waiting, so several
    sources can compile side by side. Returns a handle for
    :func:`finish_build`; no compiler is started when an up-to-date library
    (same source, same flags) already exists."""
    src = source_path(name)
    with open(src, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join((*NVCC_FLAGS, *extra_flags)).encode()
        ).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    handle = {"name": name, "lib": lib, "proc": None}
    if os.path.exists(lib):
        return handle
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    handle.update(
        tmp=tmp, cmd=cmd, t0=time.perf_counter(),
        proc=subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    )
    return handle


def finish_build(handle: dict) -> str:
    """Wait for a build started with :func:`start_build`; raise with the
    compiler's output if it failed. Returns the library's path."""
    proc = handle["proc"]
    if proc is None:
        BUILD_LOG.setdefault(
            handle["name"], {"lib": handle["lib"], "seconds": 0.0, "ptxas": "(reused)"})
        return handle["lib"]
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(handle["tmp"]):
            os.remove(handle["tmp"])
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(handle['cmd'])}\n{out}"
        )
    os.replace(handle["tmp"], handle["lib"])
    BUILD_LOG[handle["name"]] = {
        "lib": handle["lib"],
        "seconds": time.perf_counter() - handle["t0"],
        "ptxas": out,
    }
    return handle["lib"]


def load_kernel_library(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built now if it is
    not there yet), loaded once per process."""
    key = name + "|" + " ".join(extra_flags)
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(finish_build(start_build(name, extra_flags)))
    return _LOADED[key]

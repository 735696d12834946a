"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` under ``repro_torch/kernels/`` compiles at first
use into ``build/repro_torch/lib<name>-<hash>.so`` at the root of the
checkout (``.gitignore`` lists ``build/``), where ``<hash>`` covers the
source and the flags: an edited source rebuilds, an unchanged one loads.
There is no prebuilt fallback.  The sources expose plain C functions that
take ``void*`` pointers and the CUDA stream and return
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "check"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
SOURCES = {
    "stream_scan": _PKG / "stream_scan" / "csrc" / "stream_scan.cu",
    "scoring_scan": _PKG / "stream_scan" / "csrc" / "scoring_scan.cu",
    "cms_sketch": _PKG / "cms_sketch" / "csrc" / "cms_sketch.cu",
    "segment_agg": _PKG / "segment_agg" / "csrc" / "segment_agg.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "cin": _PKG / "cin" / "csrc" / "cin.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{_logs[name]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _libs[name] = lib
        return lib


def build_all() -> dict:
    """Compile every source at once (one ``nvcc`` each, in parallel) and
    load them.  Returns ``{"seconds": s, "logs": {name: ptxas output}}``."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for fut in [pool.submit(_compile, n) for n in SOURCES]:
            fut.result()
    for name in SOURCES:
        load(name)
    return {"seconds": time.perf_counter() - t0, "logs": dict(_logs)}


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")

"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles on first use into its own shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of its sources so an edited kernel is rebuilt.  All sources
compile in parallel, one ``nvcc`` process each.  Nothing here runs at
import time.  The libraries expose plain C launchers that take device
pointers and the stream as ``void*`` and return ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "k2_scan": "k2_scan.cu",
    "k2_check": "k2_check.cu",
    "pred_gather_dac": "pred_gather_dac.cu",
    "pred_gather": "pred_gather.cu",
    "k2_range": "k2_range.cu",
    "k2_scan_rebind": "k2_scan_rebind.cu",
    "popcount": "popcount.cu",
    "sorted_intersect_mask": "sorted_intersect.cu",
    "block_spmm": "block_spmm.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ptxas: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every missing library in parallel; raise on any failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        path = _lib_path(name)
        out[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        _ptxas[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build all kernels at once (parallel nvcc) and load them."""
    with _lock:
        paths = build_all([n for n in SOURCES if n not in _libs])
        for name, path in paths.items():
            _libs[name] = ctypes.CDLL(str(path))
        return dict(_libs)


def ptxas_report() -> dict[str, str]:
    """``nvcc -Xptxas -v`` output of the kernels built by this process."""
    return dict(_ptxas)

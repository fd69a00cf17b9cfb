"""Host (C++) runtime component: the exact linear-assignment solver of the
selection energy (the port's own copy of reart_tpu/native).

`lap.cpp` is compiled with the host compiler on first use into
`reart_tpu_torch/_build/`, named by a hash of the source and flags, and
loaded with ctypes. There is no substitute path: without a C++ compiler the
call raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "lap.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# no -march=native: the library may outlive the machine that built it
CXX_FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libreart_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile lap.cpp if its library is missing; returns the path."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build "
                           "reart_tpu_torch/native/lap.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: no process loads half a file
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    i = ctypes.c_int
    lib.lap_solve_batch.restype = i
    lib.lap_solve_batch.argtypes = [i, i, i, _F, _I]
    lib.lap_points_batch.restype = i
    lib.lap_points_batch.argtypes = [i, i, i, _F, _F, _F, _I]
    return lib


def lap_solve_batch(cost: np.ndarray) -> np.ndarray:
    """Exact LAP on (B, N, M) float costs -> row_to_col (B, N) int32."""
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    if cost.ndim == 2:
        cost = cost[None]
    b, n, m = cost.shape
    out = np.empty((b, n), dtype=np.int32)
    rc = load_library().lap_solve_batch(b, n, m, cost.ctypes.data_as(_F),
                                        out.ctypes.data_as(_I))
    if rc != 0:
        raise RuntimeError(f"lap_solve_batch failed (code {rc})")
    return out


def lap_solve_points(src: np.ndarray, tgt: np.ndarray,
                     v_init: np.ndarray | None = None) -> np.ndarray:
    """Exact LAP under euclidean point-pair costs. src (B, N, 3), tgt
    (B, M, 3), optional initial column duals v_init (B, M) -> row_to_col
    (B, N) int32. Cost rows are materialised inside the solver, never the
    whole (B, N, M) matrix; warm duals let each augmentation end early."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    tgt = np.ascontiguousarray(tgt, dtype=np.float32)
    if src.ndim == 2:
        src, tgt = src[None], tgt[None]
        if v_init is not None:
            v_init = v_init[None]
    b, n, _ = src.shape
    m = tgt.shape[1]
    out = np.empty((b, n), dtype=np.int32)
    vp = None
    if v_init is not None:
        v_init = np.ascontiguousarray(v_init, dtype=np.float32)
        if v_init.shape != (b, m):
            raise ValueError(f"v_init {v_init.shape} must be {(b, m)}")
        vp = v_init.ctypes.data_as(_F)
    rc = load_library().lap_points_batch(
        b, n, m, src.ctypes.data_as(_F), tgt.ctypes.data_as(_F), vp,
        out.ctypes.data_as(_I))
    if rc != 0:
        raise RuntimeError(f"lap_points_batch failed (code {rc})")
    return out

"""Builds and loads the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for sm_90a (Hopper), one
compiler process per source, all started together, and the objects are
linked into one shared library with a plain C interface, which is loaded
with ctypes. The library is built on first use into
`reart_tpu_torch/_build/`, named by a hash of the sources and flags, so a
fresh checkout builds everything on its first kernel launch and an edited
source gets a fresh library.

`-fmad=false` keeps nvcc from contracting a*b + c into one FMA: each kernel
and its plain PyTorch version then round every sum the same way, which keeps
index outputs (nearest neighbours, FPS order, auction winners) identical.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points of the library: name -> argument types. Every function
# returns cudaGetLastError() after its launch (0 = cudaSuccess).
SIGNATURES = {
    # src, tgt, B, N, M, fd, fi, fc, bd, bi, bc, stream
    "reart_nn1_bidir_coords": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # query, ref, flow, B, N, M, out, min_d, flow_d, stream
    "reart_blend3": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # xyz, mask, B, N, npoint, out, stream
    "reart_fps": (_P, _P, _I, _I, _I, _P, _P),
    # benefit, price_in, B, N, M, eps (host float*), n_eps, max_sweeps,
    # row_to_col, price_out, stream
    "reart_auction_resident": (_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P),
    # benefit, price_in, B, N, M, eps (host float*), n_eps, max_sweeps,
    # row_to_col, price_out, key, c2r, assigned, owned, stats, stream
    "reart_auction_resident_hbm": (_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P,
                                   _P, _P, _P, _P, _P),
    # query, ref, B, N, M, ref_div, k, out_d, out_i, stream
    "reart_nn_topk": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # query, ref, B, N, M, out_d, out_i, out_c, stream
    "reart_nn1_coords": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    # src, tgt, B, N, M, fd, fi, bd, bi, stream
    "reart_nn_bidir": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # benefit, price, B, N, M, best_v, second_v, best_j, stream
    "reart_row_top2": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    # bid, best_j, B, N, M, col_bid, col_winner, stream
    "reart_col_winner_max": (_P, _P, _I, _I, _I, _P, _P, _P),
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "reart_tpu_torch are built with the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libreart_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compile the library if it is missing. Returns (path, seconds spent
    building, compiler log); seconds is 0.0 when the library existed."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return path, 0.0, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(cu, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    try:
        failed = [s for s, p in zip(cu, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)  # atomic: no process loads half a file
    return path, seconds, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError_t {err})")


def stream_of(tensor) -> ctypes.c_void_p:
    """The current PyTorch stream on the tensor's device, for a launch."""
    import torch

    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and of `dtype` when given) — the only inputs a kernel takes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def is_cpu(name: str, tensor) -> bool:
    """Dispatch by device: True for a CPU tensor (plain version), False for
    a CUDA tensor (kernel); any other device raises."""
    if tensor.device.type == "cpu":
        return True
    if tensor.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {tensor.device}")

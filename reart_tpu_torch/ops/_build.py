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

# The kernels' option sizes, passed as -D flags. The auction kernels'
# (csrc/auction_cluster.cuh), read by ops/cuda_auction's size gates too: the
# columns the streamed and large kernels cache a row, the banded kernel's
# (0: none), and the bidding rows at or below which the dense kernels run
# the rest of a phase on one block. The neighbour kernels': the queries a
# thread of nn_topk carries where the grid is full without slicing
# (csrc/nn_topk.cu, read by ops/cuda_nn.nn_topk_plan), and the points a lane
# of ball_query looks at per step (csrc/ball_query.cu). `build(defines=...)`
# overrides them for a variant.
DEFINES = {"REART_CACHE_K": 4, "REART_BAND_CACHE_K": 0, "REART_TAIL_ROWS": 32,
           "REART_NN_QPT": 4, "REART_BQ_V": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points of the library: name -> argument types. Every function
# returns cudaGetLastError() after its launch (0 = cudaSuccess).
SIGNATURES = {
    # src, tgt, B, N, M, fd, fi, fc, bd, bi, bc, fkey, bkey (scratch), stream
    "reart_nn1_bidir_coords": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P),
    # query, ref, flow, B, N, M, slices, out, min_d, flow_d, stream
    "reart_blend3": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # xyz, mask, B, N, npoint, out, stream
    "reart_fps": (_P, _P, _I, _I, _I, _P, _P),
    # benefit, price_in, B, N, M, eps (host float*), n_eps, max_sweeps,
    # row_to_col, price_out, stream
    "reart_auction_resident": (_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P),
    # benefit, price_in, B, N, M, eps (host float*), n_eps, max_sweeps,
    # row_to_col, price_out, stats, probe, stream
    "reart_auction_resident_hbm": (_P, _P, _I, _I, _I, _P, _I, _I, _P, _P,
                                   _P, _P, _P),
    # benefit, price_in, B, N, M, eps (host float*), n_eps, max_sweeps,
    # row_to_col, price_out, stats, probe, stream
    "reart_auction_large": (_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                            _P),
    # N, M, tile, out (3 int32: slot buffers, option, shared-memory bytes)
    "reart_auction_resident_hbm_config": (_I, _I, _I, _P),
    "reart_auction_large_config": (_I, _I, _I, _P),
    "reart_auction_banded_config": (_I, _I, _I, _P),
    # query, ref, B, N, M, k, queries a thread, slices, out_d, out_i, stream
    "reart_nn_topk": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # query, ref, B, N, M, route (0 packed, 1 topk), lanes a pair or queries
    # a thread, warps a block or slices, out_d, out_i, out_c, stream
    "reart_nn1_coords": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # src, tgt, B, N, M, warps, run, blocks, fd, fi, bd, bi, fkey, bkey
    # (scratch), stream
    "reart_nn_bidir": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P),
    # stream: one launch of an empty kernel (the launch floor)
    "reart_empty_kernel": (_P,),
    # benefit, price, B, N, M, best_v, second_v, best_j, stream
    "reart_row_top2": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    # bid, best_j, B, N, M, col_bid, col_winner, stream
    "reart_col_winner_max": (_P, _P, _I, _I, _I, _P, _P, _P),
    # xyz, new_xyz, B, N, S, r2, nsample, warps a block, out, stream
    "reart_ball_query": (_P, _P, _I, _I, _I, _F, _I, _I, _P, _P),
    # src, tgt, price_in, B, N, M, w, tile, eps (host float*), n_eps,
    # max_sweeps, carry, row_to_col, price_out, stats, stream
    "reart_auction_banded": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I,
                             _P, _P, _P, _P),
    # lin, bias, rows, C, blocks, z, stream
    "reart_bn_bias_add": (_P, _P, _I, _I, _I, _P, _P),
    # z, mean, var, bn_weight, bn_bias, rows, C, relu, blocks, out, stream
    "reart_bn_apply": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # grad_out, z, mean, var, bn_weight, bn_bias, rows, C, relu, blocks,
    # terms, stream
    "reart_bn_grad_terms": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # g_d, z, mean, var, sum_s, sum_d, rows, C, 2 / rows, 1 / rows, blocks,
    # grad_z, stream
    "reart_bn_grad_input": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P,
                            _P),
    # src, tgt, price_in, B, N, M, w, tile, eps (host float*), n_eps,
    # max_sweeps, carry, row_to_col, price_out, key, c2r, r2c, tile_flag,
    # owned, stats, stream
    "reart_auction_banded_global": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                                    _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P),
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


def _flags(defines: dict | None) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in
                              sorted({**DEFINES, **(defines or {})}.items()))


def library_path(defines: dict | None = None) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libreart_kernels_{h.hexdigest()[:16]}.so")


def build(defines: dict | None = None) -> tuple[str, float, str]:
    """Compile the library if it is missing, with `defines` over DEFINES.
    Returns (path, seconds spent building, compiler log); seconds is 0.0
    when the library existed."""
    flags = _flags(defines)
    path = library_path(defines)
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
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s],
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


def load_library(defines: dict | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set;
    `defines` over DEFINES gives a variant (its own file)."""
    return _load(tuple(sorted((defines or {}).items())))


@functools.lru_cache(maxsize=None)
def _load(defines: tuple) -> ctypes.CDLL:
    path, _, _ = build(dict(defines))
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
    """The current PyTorch stream on the tensor's device, for a launch: its
    raw handle, without building a `torch.cuda.Stream` (0.1 us a call
    against 6.5 on the card; a corr step asks 59 times)."""
    import torch

    return ctypes.c_void_p(
        torch._C._cuda_getCurrentRawStream(tensor.device.index))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


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

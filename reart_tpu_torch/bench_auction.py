"""Time the auction kernels' tail options on the card, in turns.

    python -m reart_tpu_torch.bench_auction

Builds variants of the kernel library with one option size of
`ops._build.DEFINES` changed each (the candidate cache off in the streamed
and large kernels, REART_CACHE_K=0; the banded kernel with that cache,
REART_BAND_CACHE_K=4; the tail on one block at other thresholds,
REART_TAIL_ROWS), each into its own file under reart_tpu_torch/_build/,
checks each variant against the plain versions (row_to_col, prices and stats exact), then times every
variant twice, in the order A B ... B A on one card: the streamed kernel at
(9, 2048, 2048) warm and cold (the projection fit's LAP), the banded kernel
at (7, 4096, 4096), w=1024, warm and cold (the sapien fit's LAP on the
synthetic scene chip_smoke.py solves), the large kernel at the energy's
presolve (9, 4096, 4096) with 400-sweep tails and at the engine's warm
(7, 4096, 4096). Prints one line a variant with the card's name and power
limit. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from reart_tpu_torch.data.sapien import SapienDataset
from reart_tpu_torch.data.synth import make_sapien_scene
from reart_tpu_torch.ops import _build
from reart_tpu_torch.ops import cuda_auction as C
from reart_tpu_torch.ops.assignment import _curve_sort
from reart_tpu_torch.ops.distance import pairwise_sqdist

# name -> option sizes over ops._build.DEFINES
VARIANTS = {
    "as built": {},
    "no cache": {"REART_CACHE_K": 0},
    # the banded kernel with the streamed kernel's cache (not taken)
    "banded cache": {"REART_BAND_CACHE_K": 4},
    "no tail": {"REART_TAIL_ROWS": 0},
    **{f"tail {t}": {"REART_TAIL_ROWS": t} for t in (8, 64, 128)},
}
ENGINE_EPS = (5e-3, 1e-4)
PRESOLVE_EPS = tuple(1e-6 * 30.0 ** k for k in range(3, -1, -1))


def _eps(eps):
    return ctypes.cast((ctypes.c_float * len(eps))(*eps), ctypes.c_void_p)


def streamed(lib, benefit, price, eps, sweeps):
    b, n, m = benefit.shape
    out = (torch.empty((b, n), dtype=torch.int64, device=benefit.device),
           torch.empty((b, m), device=benefit.device),
           torch.empty((b, len(eps), 2), dtype=torch.int32,
                       device=benefit.device))
    _build.check_launch("streamed", lib.reart_auction_resident_hbm(
        benefit.data_ptr(), price.data_ptr(), b, n, m, _eps(eps), len(eps),
        sweeps, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), None,
        _build.stream_of(benefit)))
    return out


def large(lib, benefit, price, eps, sweeps):
    b, n, m = benefit.shape
    out = (torch.empty((b, n), dtype=torch.int64, device=benefit.device),
           torch.empty((b, m), device=benefit.device),
           torch.empty((b, len(eps), 2), dtype=torch.int32,
                       device=benefit.device))
    _build.check_launch("large", lib.reart_auction_large(
        benefit.data_ptr(), price.data_ptr(), b, n, m, _eps(eps), len(eps),
        sweeps, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), None,
        _build.stream_of(benefit)))
    return out


def banded(lib, src, tgt, price, eps, sweeps, w, tile):
    b, n, _ = src.shape
    m = tgt.shape[1]
    out = (torch.empty((b, n), dtype=torch.int64, device=src.device),
           torch.empty((b, m), device=src.device),
           torch.empty((b, len(eps), 3), dtype=torch.int32,
                       device=src.device))
    _build.check_launch("banded", lib.reart_auction_banded(
        src.data_ptr(), tgt.data_ptr(), price.data_ptr(), b, n, m, w, tile,
        _eps(eps), len(eps), sweeps, 0, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), _build.stream_of(src)))
    return out


def ms(fn, launches=10, reps=5):
    """Median over `reps` of one call's time from `launches` calls between
    one pair of CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_auction: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def benefit_of(src, tgt):
        return (-torch.sqrt(pairwise_sqdist(src, tgt))).contiguous()

    # the projection fit's LAP: a cloud against a permuted, moved copy
    tgt = randn(9, 2048, 3)
    src = tgt[:, torch.randperm(2048, generator=gen, device=dev)] \
        + 0.05 * randn(9, 2048, 3)
    cold = benefit_of(src, tgt)
    warm = benefit_of(src + 0.002 * randn(9, 2048, 3), tgt)
    zero = torch.zeros((9, 2048), device=dev)
    warm_price = C.auction_solve_resident_hbm_plain(cold, zero, ENGINE_EPS,
                                                    100)[1].contiguous()
    # the energy's presolve with 400-sweep tails and the engine's warm solve
    tgt4 = randn(9, 4096, 3)
    src4 = tgt4[:, torch.randperm(4096, generator=gen, device=dev)] \
        + 0.05 * randn(9, 4096, 3)
    tails = benefit_of(src4, tgt4)
    engine = tails[:7].contiguous()
    moved = benefit_of(src4[:7] + 0.002 * randn(7, 4096, 3), tgt4[:7])
    zero4 = torch.zeros((9, 4096), device=dev)
    engine_price = C.auction_solve_large_plain(
        engine, zero4[:7], ENGINE_EPS, 100)[1].contiguous()
    # the sapien fit's banded LAP, as chip_smoke.py builds it: the scene's
    # GT clouds of views 1-7 a little off against the observed views,
    # Hilbert-sorted, w=1024, tile 256
    with tempfile.TemporaryDirectory() as tmp:
        sap = SapienDataset(make_sapien_scene(
            os.path.join(tmp, "scene"), n_views=8, n_points=4096,
            n_parts=6))[0]
    rng = np.random.RandomState(0)
    gt = sap["gt_pc_list"] + 0.02 * rng.randn(
        *sap["gt_pc_list"].shape).astype(np.float32)
    bs, bt, _, _ = _curve_sort(torch.from_numpy(gt).to(dev),
                               torch.from_numpy(sap["pc_list"]).to(dev),
                               1024, None)
    bs, bt = bs.contiguous(), bt.contiguous()
    bmoved = (bs + 0.002 * torch.from_numpy(rng.randn(*gt.shape).astype(
        np.float32)).to(dev)).contiguous()
    bzero = torch.zeros((7, 4096), device=dev)
    band_price = C.auction_solve_banded_plain(bs, bt, bzero, ENGINE_EPS, 100,
                                              1024)[1].contiguous()

    calls = {
        "streamed warm": (streamed, (warm, warm_price, ENGINE_EPS, 100),
                          lambda: C.auction_solve_resident_hbm_plain(
                              warm, warm_price, ENGINE_EPS, 100, True)),
        "streamed cold": (streamed, (cold, zero, ENGINE_EPS, 100),
                          lambda: C.auction_solve_resident_hbm_plain(
                              cold, zero, ENGINE_EPS, 100, True)),
        "banded warm": (banded, (bmoved, bt, band_price, ENGINE_EPS, 100,
                                 1024, 256),
                        lambda: C.auction_solve_banded_plain(
                            bmoved, bt, band_price, ENGINE_EPS, 100, 1024,
                            return_stats=True)),
        "banded cold": (banded, (bs, bt, bzero, ENGINE_EPS, 100, 1024, 256),
                        lambda: C.auction_solve_banded_plain(
                            bs, bt, bzero, ENGINE_EPS, 100, 1024,
                            return_stats=True)),
        "large presolve": (large, (tails, zero4, PRESOLVE_EPS, 400),
                           lambda: C.auction_solve_large_plain(
                               tails, zero4, PRESOLVE_EPS, 400, True)),
        "large engine warm": (large, (moved, engine_price, ENGINE_EPS, 100),
                              lambda: C.auction_solve_large_plain(
                                  moved, engine_price, ENGINE_EPS, 100,
                                  True)),
    }
    refs = {k: ref() for k, (_, _, ref) in calls.items()}
    libs = {name: _build.load_library(defines)
            for name, defines in VARIANTS.items()}
    for name, lib in libs.items():
        for k, (fn, args, _) in calls.items():
            got = fn(lib, *args)
            if any(not torch.equal(g, r) for g, r in zip(got, refs[k])):
                raise AssertionError(f"{name}, {k}: differs from the plain "
                                     f"version")
    print(f"{card}: every variant equals the plain versions (row_to_col, "
          f"prices, stats)", flush=True)
    times = {name: {k: [] for k in calls} for name in libs}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for k, (fn, args, _) in calls.items():
            times[name][k].append(ms(lambda: fn(libs[name], *args),
                                     5 if "banded" in k or "large" in k
                                     else 10))
    for name in libs:
        print(f"{card}: {name}: " + "; ".join(
            f"{k} {t[0]:.4f}, {t[1]:.4f} ms" for k, t in times[name].items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

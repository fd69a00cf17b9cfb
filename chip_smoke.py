#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reart_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build:  compiles reart_tpu_torch/csrc/*.cu (sm_90a) into the kernel
             library and native/lap.cpp with the host compiler, and prints
             the build time and ptxas resource lines;
  3. kernels vs plain: each of the twelve kernels against its plain PyTorch
             version on the card, at the main paths' shapes plus ragged and
             tie cases; indices and coordinates exact, floats within
             FLOAT_TOL; ms of many launches per event pair (for the two
             kernels too small to fill the queue: of a replayed CUDA graph
             of many launches, which is their device time), and each
             kernel's bound (the least time the card could take);
  4. reference: a toy fit on the card against the same fit on the CPU; a
             3-part toy robot through the whole relaxation run (fit, seg
             refine, graph stage, metrics, TED, energy, result files) on the
             card against the same run on the CPU; and finalize from fixed
             labels and poses on the card against the CPU within
             FINALIZE_RTOL; and the projection stage of a toy robot (the
             kinematic model built from a result.pkl of GT labels and
             perturbed GT poses, a short fit, finalize with inverse
             kinematics) on the card against the CPU within KINEMATIC_TOL;
             and the correspondence backbone on the card against the CPU
             (FPS and ball-query indices exact, features within
             BACKBONE_TOL);
  5. the fit: fit_base at nao scale (bench.py's synthetic sequence and
             config, 60 iterations), with every kernel's launch count;
  6. the run: the relaxation run at full width (T=10, N=4096, 20 parts) on
             an articulated scene made in memory, with every kernel's
             launch count and the seconds of each finalize stage;
  7. the projection run at full width: the result.pkl of phase 6 through
             `--model kinematic --downsample 2 --assign_gap 1 --assign_band 0`
             for 200 iterations, a LAP of (9, 2048, 2048) in each, then
             finalize with the retargeting error; launch counts of the fit
             and of the whole run, seconds per stage;
  8. the corr chain at full width: the scene of phase 6 written to disk,
             the `corr` subcommand trains the PointNet++ backbone on it
             (batch 4, 1024 points, CORR_STEPS steps), then the relaxation
             run of phase 6 with the default `--flow_provider corr` fits
             from that file's SMNN anchors; launch counts of each, the
             seconds of setup_flow and of each stage;
  9. a toy sapien scene (LAPs of 300^2) through both stages on the card
             against the CPU: the relaxation healthy, its tree's joints
             equal and its numbers within SAPIEN_RUN_TOL; the projection's
             tree, labels and joint types equal, its numbers within
             SAPIEN_PROJ_TOL;
 10. the sapien chain at full width: make_sapien_scene (8 views x 4096
             points, 6 parts), the relaxation run from its --flow_file at
             --downsample 1 ((7, 4096, 4096) LAPs through the banded kernel,
             the band guard's probes and one re-probe printed), then the
             projection run; full_flow_epe, per- and multi-scan RI, seconds
             per stage and launch counts of each;
 11. the real chain at full width: write_real_scene (6 OBJ frames), `corr
             --data_domain real`, the relaxation run from its SMNN anchors
             (4096 points, --downsample 4) and the projection run with
             prismatic joints allowed; seconds and launch counts of each.
Phase 3 holds the banded kernel to its plain version at the sapien LAP
((7, 4096, 4096), w=1024) and at (9, 2048, 2048), w=512, cold and warm,
carry off and on.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports neither jax nor reart_tpu.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# kernel vs plain: both use the same formula in the same order of additions,
# with no FMA contraction (nvcc -fmad=false) and IEEE sqrt/division, so
# floats should agree to the last bit; allow an ulp-scale residue
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
# toy fit on the card vs on the CPU: ATen reductions differ by an ulp
# between devices, amplified by 12 Adam steps
FIT_RTOL = 1e-3

# the toy robot run on the card vs on the CPU, from the same parameters and
# Gumbel draws: 600 Adam steps through hard (argmax) part assignments, where
# an ulp can move a point to another part; the numbers of result.txt agree
# to these absolute or relative bounds, and the tree exactly. These bars only
# say that the two fits ended in the same place; the stages after the fit
# are held to FINALIZE_RTOL by finalize_phase
RUN_TOL = {"seg_ri": ("abs", 0.02), "flow_epe": ("abs", 0.3),
           # a threshold at 0.5 cm where the EPE is 0.5 cm: 0.131 was seen
           "flow_acc5": ("abs", 0.2), "flow_acc10": ("abs", 0.1),
           "flow_angle": ("abs", 0.05), "recon_err": ("abs", 0.4),
           "cd_err": ("rel", 0.25), "retarget_err": ("abs", 0.0),
           "ted": ("abs", 0.0), "ass_err": ("rel", 0.25),
           "screw_err": ("abs", 0.01), "group_err": ("rel", 0.25),
           "total_err": ("rel", 0.25)}
# finalize from the same labels and poses on the card vs on the CPU: float32
# metrics whose reductions round differently; labels, tree and TED exactly
FINALIZE_RTOL = 1e-3
# the projection stage of the toy robot on the card vs on the CPU, from the
# same result.pkl, through a 30-iteration fit with a LAP in each. An
# epsilon-auction's matching is not unique: rows in a price war bid the same
# amount up to rounding, so an ulp in a cost picks another winner and
# another epsilon-optimal matching, and the two fits part by a few per cent
# of the assignment loss. Labels, tree and TED exactly; the rest to these
# absolute or relative bars, which say that both fits ended in the same place
KINEMATIC_RUN_TOL = {
    "seg_ri": ("abs", 0.0), "flow_epe": ("abs", 0.1),
    "flow_acc5": ("abs", 0.1), "flow_acc10": ("abs", 0.1),
    "flow_angle": ("abs", 0.01), "recon_err": ("abs", 0.1),
    "cd_err": ("rel", 0.25), "retarget_err": ("abs", 0.5),
    "ted": ("abs", 0.0), "ass_err": ("rel", 0.25),
    "screw_err": ("abs", 0.01), "group_err": ("rel", 0.05),
    "total_err": ("rel", 0.1)}
# the same fitted kinematic model scored on the card vs on the CPU
# (--resume --evaluate: no fit): float32 metrics (rtol, with atol 1e-4);
# the retargeting error goes through 200 AMSGrad steps per novel pose
KINEMATIC_TOL = {"default": 1e-3, "retarget_err": 2e-2}
# the backbone's features on the card vs on the CPU, from the same weights
# and clouds, in both BatchNorm modes: float32 matrix products summed in
# another order through 25 layers (cuBLAS against the CPU's GEMM), and in
# batch mode a channel whose batch deviation is far below sqrt(1e-5) has
# its rounding amplified up to 300-fold by the normalisation; the FPS and
# ball-query indices are equal
BACKBONE_TOL = dict(rtol=1e-3, atol=5e-4)
# the healthy bar of a 3-part toy (RI, flow EPE in cm, tree edit distance)
HEALTHY = {"seg_ri": (">", 0.9), "flow_epe": ("<", 2.0), "ted": ("==", 0.0)}

# published peaks of one H100 SXM at its full 700 W: float32 outside the
# tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNELS = {
    "nn1_bidir_coords": ("reart_tpu_torch/csrc/nn1_bidir_coords.cu",
                         "reart_tpu/ops/pallas_nn.py:503"),
    "blend3": ("reart_tpu_torch/csrc/blend3.cu",
               "reart_tpu/ops/pallas_nn.py:623"),
    "fps": ("reart_tpu_torch/csrc/fps.cu",
            "reart_tpu/ops/pallas_fps.py:31"),
    "auction_solve_resident": ("reart_tpu_torch/csrc/auction.cu",
                               "reart_tpu/ops/pallas_auction.py:193"),
    "nn_topk": ("reart_tpu_torch/csrc/nn_topk.cu",
                "reart_tpu/ops/pallas_nn.py:105"),
    "nn1_coords": ("reart_tpu_torch/csrc/nn1_coords.cu",
                   "reart_tpu/ops/pallas_nn.py:422"),
    "nn_bidir": ("reart_tpu_torch/csrc/nn_bidir.cu",
                 "reart_tpu/ops/pallas_nn.py:284"),
    "row_top2": ("reart_tpu_torch/csrc/auction_sweep.cu",
                 "reart_tpu/ops/pallas_auction.py:39"),
    "col_winner_max": ("reart_tpu_torch/csrc/auction_sweep.cu",
                       "reart_tpu/ops/pallas_auction.py:105"),
    "auction_solve_resident_hbm": ("reart_tpu_torch/csrc/auction_hbm.cu",
                                   "reart_tpu/ops/pallas_auction.py:334"),
    "ball_query": ("reart_tpu_torch/csrc/ball_query.cu",
                   "reart_tpu/ops/pallas_nn.py:194"),
    "auction_solve_banded": ("reart_tpu_torch/csrc/auction_banded.cu",
                             "reart_tpu/ops/pallas_auction.py:541"),
}


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps):
    """Median of `reps` single-call CUDA-event timings, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def many_ms(fn, launches=20, reps=5):
    """Median over `reps` of the time of one call, from `launches` calls
    between one pair of CUDA events, after a warm-up."""
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


def graph_ms(fn, launches=100, reps=5):
    """Device time of one call: `launches` calls captured into one CUDA
    graph, the graph replayed between one pair of CUDA events (median over
    `reps`). The host issues one replay, so a kernel too small to fill the
    queue is timed on the device and not by its wrapper."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def bound_of(flops, nbytes):
    """The least time (ms) the card could take: the larger of `flops` over
    the float32 peak and `nbytes` over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def bound(flops, tensors):
    """`bound_of` with the bytes of `tensors`: each input read once, each
    output written once."""
    return bound_of(flops, sum(t.numel() * t.element_size()
                               for t in tensors))


# one squared distance: 3 subtractions, 3 products, 2 additions
PAIR_FLOPS = 8


def check(name, got, ref, exact):
    """Compare output tuples; returns the max abs error over all outputs
    (indices included, as numbers)."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: output {i} is {g.dtype}"
                                 f"{tuple(g.shape)}, plain {r.dtype}"
                                 f"{tuple(r.shape)}")
        if i in exact or not g.is_floating_point():
            bad = int((g != r).sum())
            if bad:
                raise AssertionError(f"{name}: output {i} differs from the "
                                     f"plain version at {bad} entries")
        else:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name}: output {i} is not finite")
            torch.testing.assert_close(g, r, **FLOAT_TOL)
        both = torch.isfinite(g.double()) & torch.isfinite(r.double())
        diff = torch.where(both, g.double() - r.double(), 0.0).abs()
        err = max(err, float(diff.max()))  # equal infinities differ by 0
    return err


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()  # the card's name and power limit
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def build_phase():
    from reart_tpu_torch.ops import _build

    path, seconds, build_log = _build.build()
    _build.load_library()
    log(f"build: {path} in {seconds:.1f} s "
        f"({'built now' if seconds else 'already built'})")
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"  ptxas: {line.strip()}")
    from reart_tpu_torch import native

    t0 = time.perf_counter()
    native.load_library()
    log(f"build: {native.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")


def sequence(dev):
    """bench.py's synthetic nao-scale sequence: 10 frames of 4096 points."""
    rng = np.random.RandomState(0)
    cano = rng.randn(4096, 3).astype(np.float32)
    pcs = np.stack([cano + 0.02 * i for i in range(1, 10)])
    complete = np.concatenate([cano[None], pcs], 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return t(cano), t(pcs), t(complete)


def kernel_phase(dev):
    from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cano, pcs, complete = sequence(dev)
    stats = {}

    # row 5: Chamfer 1-NN, predicted clouds vs observed frames
    src = pred_clouds = (pcs + 0.01 * randn(9, 4096, 3)).contiguous()
    cases = [("main (9, 4096, 4096)", src, pcs),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3))]
    err = 0.0
    for label, a, b in cases:
        got = cuda_nn.nn1_bidir_coords(a, b)
        ref = cuda_nn.nn1_bidir_coords_plain(a, b)
        err = max(err, check(f"nn1_bidir_coords {label}", got, ref,
                             exact={1, 2, 4, 5}))
        log(f"nn1_bidir_coords {label}: indices and coords exact, "
            f"distances within {FLOAT_TOL}")
    out = cuda_nn.nn1_bidir_coords(src, pcs)
    stats["nn1_bidir_coords"] = dict(
        shape="(9, 4096, 4096)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.nn1_bidir_coords(src, pcs)),
        ms_single=median_ms(lambda: cuda_nn.nn1_bidir_coords(src, pcs), 20),
        plain_ms=median_ms(lambda: cuda_nn.nn1_bidir_coords_plain(src, pcs),
                           5),
        **bound(PAIR_FLOPS * 9 * 4096 * 4096, (src, pcs, *out)))

    # row 6: flow blend, predicted source frames vs FlowContext anchors
    query = (complete[:-1] + 0.01 * randn(9, 4096, 3)).contiguous()
    anchors = complete[:-1].contiguous()
    flows = (complete[1:] - complete[:-1]).contiguous()
    padded = anchors.clone()
    padded[:, 3000:] = 1e6  # FlowContext's FAR padding, zero flow
    pflows = flows.clone()
    pflows[:, 3000:] = 0.0
    cases = [("main (9, 4096, 4096)", query, anchors, flows),
             ("FAR-padded (9, 4096, 4096)", query, padded, pflows),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3),
              0.05 * randn(2, 1500, 3))]
    err = 0.0
    for label, q, r, f in cases:
        got = cuda_nn.blend3(q, r, f)
        ref = cuda_nn.blend3_plain(q, r, f)
        err = max(err, check(f"blend3 {label}", got, ref, exact=set()))
        mask_k = (got[1] <= got[2]) | (got[1] <= 0.05)
        mask_p = (ref[1] <= ref[2]) | (ref[1] <= 0.05)
        if not torch.equal(mask_k, mask_p):
            raise AssertionError(f"blend3 {label}: validity mask differs")
        log(f"blend3 {label}: mask exact, floats within {FLOAT_TOL}")
    out = cuda_nn.blend3(query, anchors, flows)
    stats["blend3"] = dict(
        shape="(9, 4096, 4096)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.blend3(query, anchors, flows)),
        ms_single=median_ms(lambda: cuda_nn.blend3(query, anchors, flows),
                            20),
        plain_ms=median_ms(lambda: cuda_nn.blend3_plain(query, anchors,
                                                        flows), 5),
        **bound(PAIR_FLOPS * 9 * 4096 * 4096,
                (query, anchors, flows, *out)))

    # row 12: FPS of the assign context, (1, 4096) and (9, 4096) -> 1024
    ones1 = torch.ones((1, 4096), dtype=torch.bool, device=dev)
    ones9 = torch.ones((9, 4096), dtype=torch.bool, device=dev)
    half = torch.rand((9, 4096), generator=gen, device=dev) < 0.5
    half[:, :7] = False
    labels = torch.randint(0, 20, (4096,), generator=gen, device=dev)
    labels[labels == 19] = 18  # a part without points: its FPS starts at 0
    part_masks = labels[None, :] == torch.arange(20, device=dev)[:, None]
    cano1 = cano[None].contiguous()
    cases = [("(1, 4096) -> 1024", cano1, ones1, 1024),
             ("(9, 4096) -> 1024", pcs, ones9, 1024),
             ("masked (9, 4096) -> 1024", pcs, half, 1024),
             ("ragged (2, 300) -> 64", randn(2, 300, 3),
              torch.ones((2, 300), dtype=torch.bool, device=dev), 64),
             # the backbone's first layer on a small cloud: past the last
             # point every pick is the lowest index
             ("past the cloud (2, 360) -> 512", randn(2, 360, 3),
              torch.ones((2, 360), dtype=torch.bool, device=dev), 512),
             # the graph stage's anchors: one cloud, a mask per part
             ("per-part masks (20, 4096) -> 20",
              cano[None].expand(20, 4096, 3).contiguous(), part_masks, 20)]
    err = 0.0
    for label, x, m, k in cases:
        got = cuda_fps.fps(x, m, k)
        ref = cuda_fps.fps_plain(x, m, k)
        err = max(err, check(f"fps {label}", (got,), (ref,), exact={0}))
        if not bool(m.gather(1, got)[m.any(1)].all()):
            raise AssertionError(f"fps {label}: picked a masked-out point")
        log(f"fps {label}: order exact")
    # every one of the 1024 picks updates and scans all 4096 running
    # distances: a distance, a minimum and a comparison per point
    stats["fps"] = dict(
        shape="(9, 4096) -> 1024", max_abs_err=err,
        ms=many_ms(lambda: cuda_fps.fps(pcs, ones9, 1024), 5, 5),
        ms_single=median_ms(lambda: cuda_fps.fps(pcs, ones9, 1024), 10),
        plain_ms=median_ms(lambda: cuda_fps.fps_plain(pcs, ones9, 1024), 3),
        **bound((PAIR_FLOPS + 2) * 9 * 1024 * 4096,
                (pcs, ones9, cuda_fps.fps(pcs, ones9, 1024))))
    stats["fps"]["ms_b1"] = median_ms(lambda: cuda_fps.fps(cano1, ones1, 1024),
                                      10)

    # row 9: the assign phase's LAP, (9, 1024, 1024), cold and warm-started
    tgt = randn(9, 1024, 3)
    src = (tgt[:, torch.randperm(1024, generator=gen, device=dev)]
           + 0.05 * randn(9, 1024, 3))
    benefit = (-torch.sqrt(pairwise_sqdist(src, tgt))).contiguous()
    moved = src + 0.002 * randn(9, 1024, 3)
    benefit2 = (-torch.sqrt(pairwise_sqdist(moved, tgt))).contiguous()
    eps = (5e-3, 1e-4)  # the fit's schedule: eps_min 1e-4, 2 scales, x50
    zero = torch.zeros((9, 1024), device=dev)
    cold = cuda_auction.auction_solve_resident(benefit, zero, eps, 100)
    warm_price = cold[1].contiguous()
    src_r, tgt_r = randn(2, 300, 3), randn(2, 500, 3)
    benefit_r = (-torch.sqrt(pairwise_sqdist(src_r, tgt_r))).contiguous()
    cases = [("cold (9, 1024, 1024)", benefit, zero),
             ("warm (9, 1024, 1024)", benefit2, warm_price),
             ("ragged cold (2, 300, 500)", benefit_r,
              torch.zeros((2, 500), device=dev))]
    err = 0.0
    for label, bm, p in cases:
        got = cuda_auction.auction_solve_resident(bm, p, eps, 100)
        ref = cuda_auction.auction_solve_resident_plain(bm, p, eps, 100)
        err = max(err, check(f"auction {label}", got, ref, exact={0}))
        unassigned = int((got[0] < 0).sum())
        log(f"auction {label}: row_to_col exact ({unassigned} rows left "
            f"at the sweep bound), prices within {FLOAT_TOL}")
    # the work depends on the data (how many rows bid, for how many
    # sweeps); what any solve of these inputs needs is one reading of the
    # benefit matrix per epsilon phase, a subtraction and a comparison each
    out = cuda_auction.auction_solve_resident(benefit2, warm_price, eps, 100)
    stats["auction_solve_resident"] = dict(
        shape="(9, 1024, 1024), warm", max_abs_err=err,
        ms=many_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 10, 5),
        ms_single=median_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 10),
        plain_ms=median_ms(lambda: cuda_auction.auction_solve_resident_plain(
            benefit2, warm_price, eps, 100), 3),
        **bound(2 * len(eps) * benefit2.numel(),
                (benefit2, warm_price, *out)))
    stats["auction_solve_resident"]["ms_cold"] = median_ms(
        lambda: cuda_auction.auction_solve_resident(benefit, zero, eps, 100),
        10)
    # what the solve's time is made of: sweeps and bidding rows per phase,
    # counted by the plain version (the same auction, row_to_col equal)
    for label, bm, p in cases[:2]:
        counts = cuda_auction.auction_solve_resident_plain(
            bm, p, eps, 100, return_stats=True)[2]
        log(f"auction {label}: sweeps per phase "
            f"{counts[..., 0].T.tolist()}, bidding rows per phase "
            f"{counts[..., 1].T.tolist()}")
    new_kernel_phase(dev, gen, pred_clouds, pcs, stats)
    sweep_kernel_phase(dev, gen, pred_clouds, pcs, stats)
    streamed_kernel_phase(dev, gen, stats)
    ball_query_phase(dev, gen, stats)
    with tempfile.TemporaryDirectory() as tmp:
        banded_kernel_phase(dev, tmp, stats)
    for name, s in stats.items():
        log(f"timing {name} {s['shape']}: kernel {s['ms']:.4f} ms, plain "
            f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.5f} ms by "
            f"{s['bound_by']} "
            + " ".join(f"{k} {v:.4f}" for k, v in s.items()
                       if k.startswith("ms_")))
    return stats


def new_kernel_phase(dev, gen, src, pcs, stats):
    """nn_topk, nn1_coords and nn_bidir against their plain versions."""
    from reart_tpu_torch.ops import cuda_nn

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # duplicates: every reference point appears 300 times, every query 50
    base = randn(1, 4, 3)
    tie_q, tie_r = base.repeat(1, 50, 1), base.repeat(1, 300, 1)
    zero = torch.zeros((2, 70, 3), device=dev)

    # row 1: k-NN. (9, 4096, 4096): Chamfer metrics (k=1), flow blend
    # (k=3), smoothing neighbourhood (k=8, one cloud); (T, P, N) candidates
    # against a frame shared by its P candidates: seg refinement
    moved = (pcs[:, None] + 0.01 * randn(9, 4, 4096, 3)).contiguous()
    cases = [(f"k={k} (9, 4096, 4096)", src, pcs, k) for k in (1, 3, 8)]
    cases += [("k=1 (9, 4, 4096, 3) vs broadcast (9, 1, 4096, 3)", moved,
               pcs[:, None], 1),
              ("k=3 ragged (2, 300, 1500)", randn(2, 300, 3),
               randn(2, 1500, 3), 3),
              ("k=3 M=2 < k (2, 50, 2)", randn(2, 50, 3), randn(2, 2, 3), 3),
              ("k=8 duplicates (1, 200, 1200)", tie_q, tie_r, 8),
              ("k=3 all ties (2, 70, 70)", zero, zero, 3),
              # the smoothing neighbourhood of seg refinement: one 2-D cloud
              # against itself, every query its own first hit at distance 0
              ("k=8 (4096, 3) against itself", pcs[0], pcs[0], 8),
              # label transfer of the denoise step: the few points of tiny
              # parts against the rest of the cloud, 2-D and ragged
              ("k=1 (37, 3) vs (4059, 3)", pcs[0, :37], pcs[0, 37:], 1)]
    err = 0.0
    for label, q, r, k in cases:
        got = cuda_nn.nn_topk(q, r, k)
        qf, rf, ref_div, batch = cuda_nn._flatten_query_ref("nn_topk", q, r)
        ref = cuda_nn.nn_topk_plain(qf, rf, k, ref_div)
        ref = tuple(x.reshape(batch + x.shape[-2:]) for x in ref)
        if r.shape[-2] < k:  # the missing slots hold (+inf, 0)
            m = r.shape[-2]
            if not (torch.isinf(got[0][..., m:]).all()
                    and int(got[1][..., m:].abs().max()) == 0):
                raise AssertionError(f"nn_topk {label}: missing slots")
            got = tuple(x[..., :m] for x in got)
            ref = tuple(x[..., :m] for x in ref)
        err = max(err, check(f"nn_topk {label}", got, ref, exact={1}))
        log(f"nn_topk {label}: indices exact, distances within {FLOAT_TOL}")
    # the run's largest call: T * P = 9 * 20 candidate clouds, each against
    # its frame, 3.0 G pairs; the plain version goes through it in chunks
    big = (pcs[:, None] + 0.01 * randn(9, 20, 4096, 3)).contiguous()
    frames = pcs[:, None]
    out = cuda_nn.nn_topk(big, frames, 1)
    bigf, framesf, ref_div, _ = cuda_nn._flatten_query_ref("nn_topk", big,
                                                           frames)
    ref = cuda_nn.nn_topk_plain(bigf, framesf, 1, ref_div)
    err = max(err, check("nn_topk k=1 (9, 20, 4096, 3) vs broadcast",
                         tuple(x.reshape(180, 4096, 1) for x in out), ref,
                         exact={1}))
    log("nn_topk k=1 (9, 20, 4096, 3) vs broadcast (9, 1, 4096, 3): "
        f"indices exact, distances within {FLOAT_TOL}")
    cano = pcs[0]
    stats["nn_topk"] = dict(
        shape="k=1 (9, 20, 4096, 3) vs (9, 1, 4096, 3)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.nn_topk(big, frames, 1), 3, 5),
        plain_ms=median_ms(
            lambda: cuda_nn.nn_topk_plain(bigf, framesf, 1, ref_div), 2),
        ms_k1_9=many_ms(lambda: cuda_nn.nn_topk(src, pcs, 1)),
        ms_k3_9=many_ms(lambda: cuda_nn.nn_topk(src, pcs, 3)),
        ms_k8_1=many_ms(lambda: cuda_nn.nn_topk(cano, cano, 8)),
        **bound(PAIR_FLOPS * 180 * 4096 * 4096, (big, frames, *out)))

    # row 4: 1-NN with coords. (P^2, 20, 20): the anchor pairs of the graph
    # stage's spatial cost; a cloud-scale batch beside it
    anchors = randn(20, 20, 3)
    pair_q = anchors[:, None].expand(20, 20, 20, 3).reshape(400, 20, 3)
    pair_r = anchors[None].expand(20, 20, 20, 3).reshape(400, 20, 3)
    pair_q, pair_r = pair_q.contiguous(), pair_r.contiguous()
    cases = [("(9, 4096, 4096)", src, pcs),
             ("(400, 20, 20)", pair_q, pair_r),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3)),
             ("duplicates (1, 200, 1200)", tie_q, tie_r),
             ("all ties (2, 70, 70)", zero, zero)]
    err = 0.0
    for label, q, r in cases:
        err = max(err, check(f"nn1_coords {label}", cuda_nn.nn1_coords(q, r),
                             cuda_nn.nn1_coords_plain(q, r), exact={1, 2}))
        log(f"nn1_coords {label}: indices and coords exact, distances "
            f"within {FLOAT_TOL}")
    out = cuda_nn.nn1_coords(pair_q, pair_r)
    stats["nn1_coords"] = dict(
        shape="(400, 20, 20)", max_abs_err=err,
        # 400 one-warp blocks: 50 back-to-back calls never fill the queue,
        # so the kernel's time is read from a replayed graph
        ms=graph_ms(lambda: cuda_nn.nn1_coords(pair_q, pair_r)),
        ms_host=many_ms(lambda: cuda_nn.nn1_coords(pair_q, pair_r), 50, 5),
        plain_ms=many_ms(lambda: cuda_nn.nn1_coords_plain(pair_q, pair_r),
                         10, 5),
        ms_cloud_9=many_ms(lambda: cuda_nn.nn1_coords(src, pcs)),
        **bound(PAIR_FLOPS * 400 * 20 * 20, (pair_q, pair_r, *out)))

    # row 3: bidirectional 1-NN without coords: the Chamfer metric
    cases = [("(9, 4096, 4096)", src, pcs),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3)),
             ("duplicates (1, 200, 1200)", tie_q, tie_r),
             ("all ties (2, 70, 70)", zero, zero)]
    err = 0.0
    for label, a, b in cases:
        err = max(err, check(f"nn_bidir {label}", cuda_nn.nn_bidir(a, b),
                             cuda_nn.nn_bidir_plain(a, b), exact={1, 3}))
        log(f"nn_bidir {label}: indices exact, distances within {FLOAT_TOL}")
    out = cuda_nn.nn_bidir(src, pcs)
    stats["nn_bidir"] = dict(
        shape="(9, 4096, 4096)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.nn_bidir(src, pcs)),
        plain_ms=median_ms(lambda: cuda_nn.nn_bidir_plain(src, pcs), 5),
        **bound(PAIR_FLOPS * 9 * 4096 * 4096, (src, pcs, *out)))


def sweep_kernel_phase(dev, gen, src, pcs, stats):
    """row_top2 and col_winner_max against their plain versions, and the
    sweep route of auction_lap against the same loop over plain versions."""
    from reart_tpu_torch.ops import assignment, cuda_auction
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # rows 7 and 8 at the energy stage's shape: predicted clouds against the
    # observed frames, euclidean costs, prices of a solve under way
    benefit = (-torch.sqrt(pairwise_sqdist(src, pcs))).contiguous()
    zero = torch.zeros((9, 4096), device=dev)
    _, mid = assignment._auction_phase(benefit, zero, 2.7e-2, 5)
    mid = mid.contiguous()
    ragged = (-torch.sqrt(pairwise_sqdist(randn(2, 300, 3),
                                          randn(2, 500, 3)))).contiguous()
    ties = -torch.randint(0, 3, (2, 128, 160), generator=gen,
                          device=dev).float()
    one_col = -randn(3, 5, 1).abs()
    cases = [("cold (9, 4096, 4096)", benefit, zero),
             ("mid-solve (9, 4096, 4096)", benefit, mid),
             ("ragged (2, 300, 500)", ragged, randn(2, 500).abs()),
             ("ties (2, 128, 160)", ties,
              torch.randint(0, 2, (2, 160), generator=gen,
                            device=dev).float()),
             ("M = 1 (3, 5, 1)", one_col, torch.zeros((3, 1), device=dev))]
    err_r = err_c = 0.0
    for label, bm, p in cases:
        got = cuda_auction.row_top2(bm, p)
        ref = cuda_auction.row_top2_plain(bm, p)
        err_r = max(err_r, check(f"row_top2 {label}", got, ref,
                                 exact={0, 1, 2}))
        log(f"row_top2 {label}: values and columns exact")
        # two thirds of the rows bid, as in a sweep under way
        bid = got[0] - got[1] + 0.5
        bid[:, ::3] = float("-inf")
        m = bm.shape[2]
        got_c = cuda_auction.col_winner_max(bid, got[2], m)
        ref_c = cuda_auction.col_winner_max_plain(bid, got[2], m)
        err_c = max(err_c, check(f"col_winner_max {label}", got_c, ref_c,
                                 exact={0, 1}))
        log(f"col_winner_max {label}: bids and winners exact")
    nobody = torch.full((2, 300), float("-inf"), device=dev)
    cols = torch.zeros((2, 300), dtype=torch.int64, device=dev)
    check("col_winner_max no bidder", cuda_auction.col_winner_max(
        nobody, cols, 500), cuda_auction.col_winner_max_plain(
        nobody, cols, 500), exact={0, 1})
    log("col_winner_max no bidder (2, 300) -> 500: exact")

    bv, sv, bj = cuda_auction.row_top2(benefit, mid)
    bid = bv - sv + 1e-3
    bid[:, ::3] = float("-inf")
    out_c = cuda_auction.col_winner_max(bid, bj, 4096)
    # row_top2: a subtraction and a comparison per entry, the matrix read
    # once; col_winner_max: a comparison per row, the bids and columns read
    # and the per-column outputs written
    stats["row_top2"] = dict(
        shape="(9, 4096, 4096)", max_abs_err=err_r,
        ms=many_ms(lambda: cuda_auction.row_top2(benefit, mid)),
        plain_ms=median_ms(lambda: cuda_auction.row_top2_plain(benefit, mid),
                           3),
        **bound(2 * benefit.numel(), (benefit, mid, bv, sv, bj)))
    stats["col_winner_max"] = dict(
        shape="(9, 4096) -> 4096", max_abs_err=err_c,
        ms=graph_ms(lambda: cuda_auction.col_winner_max(bid, bj, 4096)),
        ms_host=many_ms(lambda: cuda_auction.col_winner_max(bid, bj, 4096),
                        50, 5),
        plain_ms=median_ms(
            lambda: cuda_auction.col_winner_max_plain(bid, bj, 4096), 3),
        **bound(bid.numel(), (bid, bj, *out_c)))

    # the sweep route as a whole, at a size the streamed kernel would take
    tgt = randn(2, 1200, 3)
    moved = (tgt[:, torch.randperm(1200, generator=gen, device=dev)]
             + 0.05 * randn(2, 1200, 3))
    cost = torch.sqrt(pairwise_sqdist(moved, tgt))
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=100)
    r2c, price = assignment.auction_lap(cost, return_price=True,
                                        use_resident=False, **kw)
    bm = (-cost).contiguous()
    p_ref = torch.zeros((2, 1200), device=dev)
    for eps in (5e-3, 1e-4):
        r_ref, p_ref = assignment._auction_phase(bm, p_ref, eps, 100,
                                                 plain=True)
    r_ref = torch.where(r_ref < 0, torch.argmax(bm - p_ref[:, None], -1),
                        r_ref)
    check("auction_lap sweep route (2, 1200, 1200)", (r2c, price),
          (r_ref, p_ref), exact={0})
    log("auction_lap sweep route (2, 1200, 1200): row_to_col exact, prices "
        f"within {FLOAT_TOL}")


def streamed_kernel_phase(dev, gen, stats):
    """auction_solve_resident_hbm against its plain version and against the
    sweep route, at the projection fit's LAP: (9, 2048, 2048) euclidean
    costs of two clouds, cold (zero prices) and warm (the prices of the
    previous solve, the source cloud moved a little)."""
    from reart_tpu_torch.ops import assignment, cuda_auction
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def clouds(b, n, m):
        tgt = randn(b, m, 3)
        pick = torch.randperm(m, generator=gen, device=dev)[:n]
        return tgt[:, pick] + 0.05 * randn(b, n, 3), tgt

    def benefit_of(src, tgt):
        return (-torch.sqrt(pairwise_sqdist(src, tgt))).contiguous()

    eps = (5e-3, 1e-4)  # the fit's schedule: eps_min 1e-4, 2 scales, x50
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0)
    solve = cuda_auction.auction_solve_resident_hbm
    plain = cuda_auction.auction_solve_resident_hbm_plain
    src, tgt = clouds(9, 2048, 2048)
    benefit = benefit_of(src, tgt)
    benefit2 = benefit_of(src + 0.002 * randn(9, 2048, 3), tgt)
    zero = torch.zeros((9, 2048), device=dev)
    warm_price = solve(benefit, zero, eps, 100)[1].contiguous()
    src_r, tgt_r = clouds(2, 1024, 2048)
    ties = -torch.randint(0, 3, (2, 1100, 1200), generator=gen,
                          device=dev).float()
    cases = [("cold (9, 2048, 2048)", benefit, zero, 100),
             ("warm (9, 2048, 2048)", benefit2, warm_price, 100),
             ("non-square cold (2, 1024, 2048)", benefit_of(src_r, tgt_r),
              torch.zeros((2, 2048), device=dev), 100),
             ("sweep bound 3 (9, 2048, 2048)", benefit, zero, 3),
             ("ties (2, 1100, 1200)", ties,
              torch.zeros((2, 1200), device=dev), 100)]
    err = 0.0
    counts = {}
    for label, bm, p, sweeps in cases:
        got = solve(bm, p, eps, sweeps, return_stats=True)
        torch.cuda.synchronize()
        ref = plain(bm, p, eps, sweeps, return_stats=True)
        err = max(err, check(f"auction_hbm {label}", got, ref, exact={0, 2}))
        left = int((got[0] < 0).sum())
        if "bound" in label and left == 0:
            raise AssertionError(f"auction_hbm {label}: no row was left at "
                                 f"the sweep bound")
        counts[label] = got[2]
        log(f"auction_hbm {label}: row_to_col and the {left} rows left at "
            f"the bound exact, prices within {FLOAT_TOL}; sweeps per phase "
            f"{got[2][..., 0].T.tolist()}, bidding rows per phase "
            f"{got[2][..., 1].T.tolist()}")
        # the sweep route on the same inputs: the same matching and prices
        r_k, p_k = assignment.auction_lap(-bm, price=p, return_price=True,
                                          max_sweeps=sweeps, **kw)
        r_s, p_s = assignment.auction_lap(-bm, price=p, return_price=True,
                                          max_sweeps=sweeps,
                                          use_resident=False, **kw)
        check(f"auction_lap one launch vs sweep route {label}", (r_k, p_k),
              (r_s, p_s), exact={0})
    log("auction_lap: the one-launch route equals the sweep route "
        "(use_resident=False) at all five cases")

    # the bound counts what this run's data needs: a row that bids reads
    # its benefit row once (a subtraction and a comparison per entry);
    # prices in and out, row_to_col out
    warm = counts["warm (9, 2048, 2048)"]
    rows_bid = int(warm[..., 1].sum())
    out = solve(benefit2, warm_price, eps, 100)
    nbytes = rows_bid * 2048 * 4 + sum(
        t.numel() * t.element_size() for t in (warm_price, *out))
    stats["auction_solve_resident_hbm"] = dict(
        shape="(9, 2048, 2048), warm", max_abs_err=err,
        ms=many_ms(lambda: solve(benefit2, warm_price, eps, 100), 10, 5),
        plain_ms=median_ms(lambda: plain(benefit2, warm_price, eps, 100), 3),
        ms_cold=many_ms(lambda: solve(benefit, zero, eps, 100), 10, 5),
        ms_sweep_route=median_ms(lambda: assignment.auction_lap(
            -benefit2, price=warm_price, max_sweeps=100, use_resident=False,
            **kw), 3),
        ms_sweep_route_cold=median_ms(lambda: assignment.auction_lap(
            -benefit, max_sweeps=100, use_resident=False, **kw), 3),
        **bound_of(2 * rows_bid * 2048, nbytes))
    cold = counts["cold (9, 2048, 2048)"]
    log(f"auction_hbm (9, 2048, 2048): warm {rows_bid} bidding rows in "
        f"{int(warm[..., 0].sum())} element-sweeps "
        f"(most in one phase of one element {int(warm[..., 0].max())}), "
        f"cold {int(cold[..., 1].sum())} bidding rows in "
        f"{int(cold[..., 0].sum())} element-sweeps (most "
        f"{int(cold[..., 0].max())}); every row bidding in every sweep to "
        f"the bound would read {9 * 2 * 100 * 2048 * 2048 * 4 / 1e9:.1f} GB")


def scene():
    """The articulated table of the full-width runs (T=10, N=4096, six
    parts) and the normalisation that carries it into the unit ball."""
    from reart_tpu_torch.data.synth import (
        make_robot_sample,
        unit_ball_normalization,
    )

    sample = make_robot_sample(n_frames=10, n_points=4096, n_parts=6, seed=0)
    return (sample, *unit_ball_normalization(sample))


def gather_points(points, idx):
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))


def ball_query_phase(dev, gen, stats):
    """The three kernels of a backbone forward (fps, ball_query, nn_topk k=3)
    against their plain versions, indices exact, on the clouds the two
    correspondence paths give them: the nine source frames of the scene,
    normalised as setup_flow normalises them (SA1: 512 FPS centroids of 4096
    points; SA2: 128 of those 512); a training batch as the `corr` trainer
    makes it (4 synthetic pairs of 1024 points: 8 clouds); the held-out pair
    of its evaluation (2 clouds). Then ball_query's edge cases."""
    from reart_tpu_torch.models.pointnet2 import SA1, SA2
    from reart_tpu_torch.ops import cuda_fps, cuda_nn
    from reart_tpu_torch.train.corr import (
        CorrTrainConfig,
        draw_pairs,
        synth_pair,
    )

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ones(b, n):
        return torch.ones((b, n), dtype=torch.bool, device=dev)

    sample, centroid, scale = scene()
    frames = torch.from_numpy((sample["complete_pc_list"] - centroid)
                              * np.float32(scale)).to(dev).contiguous()
    cfg = CorrTrainConfig(batch=4, n_points=1024)
    src, tgt, _, _ = synth_pair(draw_pairs(gen, 10, 4096, cfg), frames, cfg)
    clouds = {"flow": frames[:-1].contiguous(),
              "train": torch.cat([src, tgt]).contiguous(),
              "held-out": torch.stack([src[0], tgt[0]]).contiguous()}
    errs = dict(fps=0.0, ball_query=0.0, nn_topk=0.0)
    timing = {}

    def time_kernel(fn, launches, host_launches):
        # calls of a few microseconds are paced by the wrapper back to
        # back, so the kernel's time is a replayed graph's
        return dict(ms=graph_ms(fn, launches),
                    ms_host=many_ms(fn, host_launches, 5))

    for group, cloud in clouds.items():
        timed = group != "held-out"
        # the two FPS of the SA layers
        levels = [cloud]
        for npoint in (SA1[0], SA2[0]):
            x = levels[-1]
            mask = ones(*x.shape[:2])
            label = f"fps {tuple(x.shape[:2])} -> {npoint}"
            idx = cuda_fps.fps(x, mask, npoint)
            errs["fps"] = max(errs["fps"], check(
                label, (idx,), (cuda_fps.fps_plain(x, mask, npoint),),
                exact={0}))
            took = ""
            if timed:  # far longer than its wrapper's host time
                ms = many_ms(lambda: cuda_fps.fps(x, mask, npoint), 20, 5)
                took = f"; {ms:.4f} ms a call, back to back"
            log(f"backbone shapes ({group}): {label}: order exact{took}")
            levels.append(gather_points(x, idx).contiguous())
        # the five groupings
        shapes = [("SA1", r, k, levels[0], levels[1])
                  for r, k in zip(SA1[1], SA1[2])]
        shapes += [("SA2", r, k, levels[1], levels[2])
                   for r, k in zip(SA2[1], SA2[2])]
        for layer, r, k, xyz, new_xyz in shapes:
            label = (f"{layer} r={r} K={k} {tuple(xyz.shape)} x "
                     f"{tuple(new_xyz.shape)}")
            got = cuda_nn.ball_query(r, k, xyz, new_xyz)
            torch.cuda.synchronize()
            ref = cuda_nn.ball_query_plain(r, k, xyz, new_xyz)
            errs["ball_query"] = max(errs["ball_query"], check(
                f"ball_query {label}", (got,), (ref,), exact={0}))
            if not timed:
                log(f"ball_query ({group}) {label}: indices exact")
                continue
            # what this data needs: a centroid looks at points up to its
            # K-th hit, or at the whole cloud when it has fewer
            n = xyz.shape[1]
            d = cuda_nn._sqdist_diff2(new_xyz, xyz)
            hits = (d < cuda_nn.radius_sq(r)).sum(-1)
            scanned = torch.where(hits >= k, got[..., k - 1] + 1,
                                  torch.full_like(hits, n))
            pairs = int(scanned.sum())
            del d
            t = timing[(group, label)] = dict(
                **time_kernel(lambda: cuda_nn.ball_query(r, k, xyz, new_xyz),
                              100, 50),
                plain_ms=median_ms(
                    lambda: cuda_nn.ball_query_plain(r, k, xyz, new_xyz), 3),
                **bound(PAIR_FLOPS * pairs, (xyz, new_xyz, got)))
            log(f"ball_query ({group}) {label}: indices exact; hits per "
                f"centroid min {int(hits.min())} median "
                f"{int(hits.median())} max {int(hits.max())}; {pairs} of "
                f"{hits.numel() * n} pairs looked at; kernel {t['ms']:.4f} ms "
                f"on the device ({t['ms_host']:.4f} ms a call from the "
                f"host), plain {t['plain_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.5f} ms by {t['bound_by']}")
        # the two 3-NN searches of the feature-propagation layers
        for q, r in ((levels[1], levels[2]), (levels[0], levels[1])):
            label = f"nn_topk k=3 {tuple(q.shape[:2])} vs {tuple(r.shape[:2])}"
            got = cuda_nn.nn_topk(q, r, 3)
            qf, rf, ref_div, batch = cuda_nn._flatten_query_ref("nn_topk",
                                                                q, r)
            ref = tuple(x.reshape(batch + x.shape[-2:])
                        for x in cuda_nn.nn_topk_plain(qf, rf, 3, ref_div))
            errs["nn_topk"] = max(errs["nn_topk"], check(label, got, ref,
                                                         exact={1}))
            took = ""
            if timed:
                t = time_kernel(lambda: cuda_nn.nn_topk(q, r, 3), 20, 20)
                took = (f"; {t['ms']:.4f} ms on the device, "
                        f"{t['ms_host']:.4f} ms a call, back to back")
            log(f"backbone shapes ({group}): {label}: indices exact, "
                f"distances within {FLOAT_TOL}{took}")
    err = errs["ball_query"]

    # the edge cases of the CPU test
    k, radius = 8, 0.25                      # radius^2 = 0.0625 exactly
    xyz = torch.full((1, 70, 3), 5.0, device=dev)
    xyz[0, :, 0] += torch.arange(70, device=dev)
    xyz[0, 10:10 + k] = 1.0                  # exactly k hits of centroid 1
    xyz[0, 30] = torch.tensor([-3.0, 0.0, 0.0])   # the one hit of centroid 2
    xyz[0, 40] = torch.tensor([0.25, 0.0, 0.0])   # at the radius: outside
    xyz[0, 41] = torch.tensor([0.0, 0.2499999, 0.0])      # just inside
    new_xyz = torch.tensor([[[-9.0, -9.0, -9.0], [1.0, 1.0, 1.0],
                             [-3.0, 0.1, 0.0], [0.0, 0.0, 0.0]]], device=dev)
    got = cuda_nn.ball_query(radius, k, xyz, new_xyz)
    want = torch.stack([torch.zeros(k), torch.arange(10, 10 + k),
                        torch.full((k,), 30), torch.full((k,), 41)]
                       ).to(dev, torch.int64)[None]
    if not torch.equal(got, want):
        raise AssertionError(f"ball_query edge cases: {got.tolist()}")
    dup = torch.rand((2, 130, 3), generator=gen, device=dev).repeat(1, 2, 1)
    many = torch.rand((1100, 64, 3), generator=gen, device=dev)
    cases = [("edge cases (1, 70) x (1, 4)", radius, k, xyz, new_xyz),
             ("ragged (3, 601) x (3, 97)", 0.2, 16,
              torch.rand((3, 601, 3), generator=gen, device=dev),
              torch.rand((3, 97, 3), generator=gen, device=dev)),
             ("duplicates (2, 260) x (2, 40)", 0.2, 16, dup,
              dup[:, 5:45].contiguous()),
             ("more slots than points (2, 20) x (2, 5), K=32", 10.0, 32,
              randn(2, 20, 3), randn(2, 5, 3)),
             # 1100 x 512 / 8 blocks: past the 65,535 of one grid row
             ("(1100, 64) x (1100, 512)", 0.3, 8, many,
              torch.rand((1100, 512, 3), generator=gen, device=dev))]
    for label, r, kk, a, b in cases:
        err = max(err, check(f"ball_query {label}",
                             (cuda_nn.ball_query(r, kk, a, b),),
                             (cuda_nn.ball_query_plain(r, kk, a, b),),
                             exact={0}))
        log(f"ball_query {label}: indices exact")

    for name in ("fps", "nn_topk"):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                         errs[name])
    main = [key for key in timing
            if key[0] == "flow" and "r=0.2 K=128" in key[1]][0]

    def forward(group, what):
        return sum(t[what] for key, t in timing.items() if key[0] == group)

    stats["ball_query"] = dict(
        shape=main[1], max_abs_err=err, **timing[main],
        ms_forward=forward("flow", "ms"),
        ms_host_forward=forward("flow", "ms_host"),
        ms_plain_forward=forward("flow", "plain_ms"),
        ms_bound_forward=forward("flow", "bound_ms"),
        ms_forward_train=forward("train", "ms"),
        ms_plain_forward_train=forward("train", "plain_ms"),
        ms_bound_forward_train=forward("train", "bound_ms"))


def reference_phase(dev):
    """A toy fit on the card against the same fit on the CPU (plain
    versions), from the same parameters and Gumbel draws."""
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.train import FitConfig, FlowContext, fit_base

    n, t, p = 256, 4, 3
    rng = np.random.RandomState(0)
    cano = rng.randn(n, 3).astype(np.float32)
    pcs = np.stack([cano + 0.02 * i for i in range(1, t)])
    complete = np.concatenate([cano[None], pcs], 0)
    flow_ctx = FlowContext.from_lists(
        [complete[i] for i in range(t - 1)],
        [complete[i + 1] - complete[i] for i in range(t - 1)])
    cfg = FitConfig(n_iter=12, assign_iter=6, assign_gap=3, downsample=2,
                    use_flow_loss=True, use_assign_loss=True)
    init = BaseModel(p, t - 1, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with torch.no_grad():  # off the identity, where Adam amplifies noise
        init.proposal_6d.add_(torch.from_numpy(
            0.1 * rng.randn(t - 1, p, 6).astype(np.float32)))
        init.proposal_t.copy_(torch.from_numpy(
            0.1 * rng.randn(t - 1, p, 3).astype(np.float32)))
    state = {k: v.clone() for k, v in init.state_dict().items()}

    def noise(it):
        return np.random.RandomState(it).gumbel(size=(n, p)).astype(
            np.float32)

    hists = {}
    for where in ("cpu", dev):
        model = BaseModel(p, t - 1, device=where)
        model.load_state_dict(state)
        _, h = fit_base(model, cfg, cano, pcs, flow_ctx=flow_ctx,
                        noise=noise, device=where)
        hists[str(where)] = {k: v.cpu() for k, v in h.items()}
    for k, ref in hists["cpu"].items():
        got = hists[str(dev)][k]
        torch.testing.assert_close(got, ref, rtol=FIT_RTOL, atol=1e-7)
    log(f"reference: toy fit (N={n}, T={t}, P={p}, 12 iters) on the card "
        f"matches the CPU fit within rtol {FIT_RTOL}; total_loss "
        f"{hists['cpu']['total_loss'][0]:.6f} -> "
        f"{hists['cpu']['total_loss'][-1]:.6f}")


def robot_args(extra, save_root, flow_provider="gt"):
    from reart_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["robot", "--use_flow_loss", "--flow_provider", flow_provider,
         "--use_assign_loss", "--save_root", save_root, *extra.split()])


def read_result_txt(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (line.split(": ") for line in f.read().splitlines() if line)}


def toy_robot_phase(dev, tmp):
    """A 3-part toy robot (a base and two hinged arms, 4 frames, 360
    points) through the whole relaxation run, 600 iterations with GT flow:
    on the card at the healthy bar, and equal to the same run on the CPU
    from the same parameters and Gumbel draws within RUN_TOL."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.data.synth import make_toy_robot_sample

    sample = make_toy_robot_sample()
    args = robot_args("--silence --n_iter 600 --assign_iter 400 "
                      "--num_parts 5 --start_tau 2 --end_tau 0.5 "
                      "--manual_seed 0", tmp)
    shape = (sample["cano_pc"].shape[0], args.num_parts)

    def noise(it):
        return np.random.RandomState(it).gumbel(size=shape).astype(np.float32)

    runs = {}
    for where in ("cpu", dev):
        save_dir = os.path.join(tmp, f"toy_{torch.device(where).type}")
        cli.run_sample(args, "robot", sample, save_dir, device=where,
                       noise=noise)
        runs[str(where)] = read_result_txt(os.path.join(save_dir,
                                                        "result.txt"))
    card, cpu = runs[str(dev)], runs["cpu"]
    log(f"reference: toy robot on the card {card}")
    log(f"reference: toy robot on the CPU  {cpu}")
    ops = {">": lambda a, b: a > b, "<": lambda a, b: a < b,
           "==": lambda a, b: a == b}
    for key, (op, limit) in HEALTHY.items():
        if not ops[op](card[key], limit):
            raise AssertionError(f"toy robot on the card: {key} = "
                                 f"{card[key]} is not {op} {limit}")
    within(card, cpu, RUN_TOL, "toy robot")
    log(f"reference: toy robot run (N=360, T=4, 600 iters) on the card is "
        f"healthy (RI {card['seg_ri']}, EPE {card['flow_epe']} cm, TED "
        f"{card['ted']}) and matches the CPU run within {RUN_TOL}")


def finalize_phase(dev, tmp):
    """Everything after the fit (seg refine, graph stage, metrics, TED,
    energy with its presolve on the card) from fixed labels and poses, on
    the card against the CPU: the six-part table at T=5, N=2048 (2048^2 is
    past the presolve's threshold), its GT parts scattered over 12 pose
    columns with one part split in two, 150 points on a wrong part and
    every pose a little off. Labels, tree and TED must be equal, every
    other number of result.txt within FINALIZE_RTOL."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import make_robot_sample
    from reart_tpu_torch.models import BaseModel

    sample = make_robot_sample(n_frames=5, n_points=2048, n_parts=6, seed=0)
    rng = np.random.RandomState(0)
    gt = sample["gt_cano_part"]
    cols = rng.permutation(12)[:7]
    seg = cols[gt]
    seg[(gt == 0) & (sample["cano_pc"][:, 0] < 0)] = cols[6]
    wrong = rng.choice(len(seg), 150, replace=False)
    seg[wrong] = cols[rng.randint(0, 6, 150)]
    trans = np.tile(np.eye(4, dtype=np.float32), (4, 12, 1, 1))
    trans[:, cols[:6]] = sample["gt_pose_list"][1:]
    trans[:, cols[6]] = sample["gt_pose_list"][1:, 0]
    trans[..., :3, 3] += 0.002 * rng.randn(4, 12, 3).astype(np.float32)

    args = robot_args("--silence --num_parts 12 --seg_refine 2", tmp)
    runs = {}
    for where in ("cpu", dev):
        save_dir = os.path.join(tmp, f"finalize_{torch.device(where).type}")
        os.makedirs(save_dir)
        model = BaseModel(12, 4, device=where,
                          generator=torch.Generator().manual_seed(0))
        res = cli.finalize(args, "robot", sample, seg.copy(), trans.copy(),
                           model, None, save_dir, 1.0, device=where)
        runs[str(where)] = (res, checkpoint.load_result(
            os.path.join(save_dir, "result.pkl")))
    (card, card_pkl), (cpu, cpu_pkl) = runs[str(dev)], runs["cpu"]
    if card_pkl["joint_connection"] != cpu_pkl["joint_connection"] or not \
            np.array_equal(card_pkl["pred_cano_part"],
                           cpu_pkl["pred_cano_part"]):
        raise AssertionError("finalize: labels or tree differ between the "
                             "card and the CPU")
    for key in ("seg_ri", "ted", "retarget_err"):
        if card[key] != cpu[key]:
            raise AssertionError(f"finalize: {key} on the card {card[key]} "
                                 f"vs on the CPU {cpu[key]}")
    for key, ref in cpu.items():
        if not abs(card[key] - ref) <= FINALIZE_RTOL * abs(ref) + 1e-4:
            raise AssertionError(f"finalize: {key} on the card {card[key]} "
                                 f"vs on the CPU {ref}")
    log(f"reference: finalize from fixed labels and poses (N=2048, T=5) on "
        f"the card {card}")
    log(f"reference: matches the CPU within rtol {FINALIZE_RTOL} (atol "
        f"1e-4), labels, tree {card_pkl['joint_connection']} and TED equal")


def within(card, cpu, tol, what):
    """Hold result dicts to per-key ("abs" | "rel", bound) bars; returns
    each key's difference in its bar's unit."""
    if card.keys() != cpu.keys() or card.keys() != tol.keys():
        raise AssertionError(f"{what}: result keys differ: {sorted(card)} vs "
                             f"{sorted(cpu)} vs {sorted(tol)}")
    diffs = {}
    for key, (kind, bound_) in tol.items():
        diff = abs(card[key] - cpu[key])
        if kind == "rel":
            diff /= max(abs(cpu[key]), 1e-12)
        if not diff <= bound_:
            raise AssertionError(f"{what}: {key} on the card {card[key]} vs "
                                 f"on the CPU {cpu[key]}: {kind} difference "
                                 f"{diff} > {bound_}")
        diffs[key] = diff
    return diffs


def kinematic_check_phase(dev, tmp):
    """The projection stage of the toy robot (all joints revolute) from a
    result.pkl of GT labels, GT poses a little off and the GT tree:
    build_kinematic_from_result, a 30-iteration fit_kinematic with a LAP
    per iteration, finalize with inverse kinematics; through the command
    line's run_sample on the card and on the CPU. Tree, labels, seg_ri and
    TED must be equal, the rest within KINEMATIC_RUN_TOL. Then the CPU
    run's model.ckpt.pkl is scored on both without a fit (--resume
    --evaluate), within KINEMATIC_TOL."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import make_toy_robot_sample

    sample = make_toy_robot_sample()
    rng = np.random.RandomState(0)
    trans = sample["gt_pose_list"][1:].copy()
    trans[..., :3, 3] += 0.01 * rng.randn(3, 3, 3).astype(np.float32)
    base = os.path.join(tmp, "toy_gt_result.pkl")
    checkpoint.save_result(base, sample["gt_cano_part"], trans, 0,
                           [[1, 0], [2, 0]], {})
    protocol = ("--silence --model kinematic --tree_search 0 --n_iter 30 "
                "--assign_iter 0 --downsample 2 --assign_gap 1 "
                "--assign_band 0")
    args = robot_args(f"{protocol} --base_result_path {base}", tmp)
    runs = {}
    for where in ("cpu", dev):
        save_dir = os.path.join(tmp, f"kin_{torch.device(where).type}")
        res = cli.run_sample(args, "robot", sample, save_dir, device=where)
        runs[str(where)] = (res, checkpoint.load_result(
            os.path.join(save_dir, "result.pkl")))
    (card, card_pkl), (cpu, cpu_pkl) = runs[str(dev)], runs["cpu"]
    if card_pkl["joint_connection"] != cpu_pkl["joint_connection"] or not \
            np.array_equal(card_pkl["pred_cano_part"],
                           cpu_pkl["pred_cano_part"]):
        raise AssertionError("projection check: labels or tree differ "
                             "between the card and the CPU")
    diffs = within(card, cpu, KINEMATIC_RUN_TOL, "projection check")
    if not (card["seg_ri"] > 0.9 and card["ted"] == 0.0
            and card["flow_epe"] < 2.0 and card["retarget_err"] < 10.0):
        raise AssertionError(f"projection check: not healthy: {card}")
    log(f"reference: projection stage of the toy robot on the card {card}")
    log(f"reference: on the CPU {cpu}")
    log(f"reference: within {KINEMATIC_RUN_TOL}: differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
        + f"; labels, tree {card_pkl['joint_connection']} and TED equal")

    ckpt_path = os.path.join(tmp, "kin_cpu", "model.ckpt.pkl")
    args = robot_args(f"{protocol} --resume {ckpt_path} --evaluate", tmp)
    scores = {}
    for where in ("cpu", dev):
        save_dir = os.path.join(tmp, f"kin_eval_{torch.device(where).type}")
        scores[str(where)] = cli.run_sample(args, "robot", sample, save_dir,
                                            device=where)
        if os.listdir(save_dir) != ["result.txt"]:
            raise AssertionError("projection check: --evaluate wrote "
                                 f"{os.listdir(save_dir)}")
    card, cpu = scores[str(dev)], scores["cpu"]
    if card.keys() != cpu.keys() or "retarget_err" not in card:
        raise AssertionError(f"projection check: {sorted(card)} vs "
                             f"{sorted(cpu)}")
    worst = {}
    for key, ref in cpu.items():
        rtol = KINEMATIC_TOL.get(key, KINEMATIC_TOL["default"])
        if not abs(card[key] - ref) <= rtol * abs(ref) + 1e-4:
            raise AssertionError(f"projection check, no fit: {key} on the "
                                 f"card {card[key]} vs on the CPU {ref}")
        worst[key] = abs(card[key] - ref) / max(abs(ref), 1e-12)
    log(f"reference: the CPU fit's checkpoint scored without a fit on the "
        f"card {card}")
    log(f"reference: matches the CPU within rtol {KINEMATIC_TOL} (atol "
        "1e-4): relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


def kernel_wrappers():
    from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn

    return (cuda_nn.nn1_bidir_coords, cuda_nn.blend3, cuda_fps.fps,
            cuda_auction.auction_solve_resident, cuda_nn.nn_topk,
            cuda_nn.nn1_coords, cuda_nn.nn_bidir, cuda_auction.row_top2,
            cuda_auction.col_winner_max,
            cuda_auction.auction_solve_resident_hbm, cuda_nn.ball_query,
            cuda_auction.auction_solve_banded)


def launch_counts():
    return {w.__name__: w.launches for w in kernel_wrappers()}


RUN_PROTOCOL = ("--n_iter 400 --assign_iter 300 --num_parts 20 "
                "--downsample 4 --seg_refine 2")


def run_phase(dev, tmp):
    """The relaxation run at full width: the six-part articulated table at
    T=10, N=4096, 20 part proposals, GT flow + assign losses, downsample 4,
    a short fit (300 + 100 iterations), then finalize with seg_refine 2."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.profiling import phase_report, reset_phases

    sample = scene()[0]
    args = robot_args(RUN_PROTOCOL, tmp)
    save_dir = os.path.join(tmp, "table")
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    # no device is named: the entry points take the card by themselves
    results = cli.run_sample(args, "robot", sample, save_dir)
    torch.cuda.synchronize()
    launches = launch_counts()

    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"run: {k} = {v} is not finite")
    if read_result_txt(os.path.join(save_dir, "result.txt")).keys() \
            != results.keys():
        raise AssertionError("run: result.txt does not list the results")
    saved = checkpoint.load_result(os.path.join(save_dir, "result.pkl"))
    n_parts = int(saved["pred_cano_part"].max()) + 1
    if (saved["pred_cano_part"].shape != (4096,)
            or saved["pred_pose_list"].shape != (9, n_parts, 4, 4)
            or len(saved["joint_connection"]) != n_parts - 1):
        raise AssertionError("run: result.pkl does not hold a tree over "
                             f"{n_parts} parts")
    model = checkpoint.base_model_from_checkpoint(
        checkpoint.load_checkpoint(os.path.join(save_dir, "model.ckpt.pkl")),
        device=dev)
    if model.num_parts != 20:
        raise AssertionError("run: model.ckpt.pkl does not reload")
    for name, count in launches.items():
        # the streamed auction belongs to the projection run's path, the
        # ball query to the corr chain's, the banded auction to sapien's
        if (count <= 0) != (name in ("auction_solve_resident_hbm",
                                     "ball_query", "auction_solve_banded")):
            raise AssertionError(f"kernel {name}: {count} launches in the "
                                 f"relaxation run")
    log(f"run: robot relaxation run at full width, {n_parts} parts, edges "
        f"{saved['joint_connection']}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in results.items()))
    log("run: seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"run: kernel launches {launches}")
    return launches, sample, os.path.join(save_dir, "result.pkl")


PROJECTION_ITERS = 200


def projection_run_phase(dev, tmp, sample, base_result_path):
    """The projection run at full width: the relaxation run's result.pkl
    through `--model kinematic` with the documented projection protocol
    (`--assign_iter 0 --downsample 2 --assign_gap 1`, dense LAP): every
    iteration solves a (9, 2048, 2048) LAP in one launch. Then finalize on
    the fixed tree with the retargeting error."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.models import KinematicModel
    from reart_tpu_torch.profiling import phase_report, reset_phases

    args = robot_args(
        f"--model kinematic --base_result_path {base_result_path} "
        f"--tree_search 0 --n_iter {PROJECTION_ITERS} --assign_iter 0 "
        "--downsample 2 --assign_gap 1 --assign_band 0 --num_parts 20", tmp)
    save_dir = os.path.join(tmp, "table_kinematic")
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    # the counts are read once more where the fit hands over to finalize
    fit_launches = {}
    finalize = cli.finalize

    def finalize_after_reading_counts(*a, **kw):
        torch.cuda.synchronize()
        fit_launches.update(launch_counts())
        return finalize(*a, **kw)

    cli.finalize = finalize_after_reading_counts
    try:
        # no device is named: the entry points take the card by themselves
        results = cli.run_sample(args, "robot", sample, save_dir)
    finally:
        cli.finalize = finalize
    torch.cuda.synchronize()
    launches = launch_counts()

    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"projection run: {k} = {v} is not finite")
    txt = read_result_txt(os.path.join(save_dir, "result.txt"))
    if txt.keys() != results.keys() or not txt["retarget_err"] < 9999.0:
        raise AssertionError("projection run: result.txt does not list the "
                             f"results with a retargeting error: {txt}")
    base = checkpoint.load_result(base_result_path)
    saved = checkpoint.load_result(os.path.join(save_dir, "result.pkl"))
    # the stored tree, each edge now pointing from child to parent
    if sorted(map(sorted, saved["joint_connection"])) \
            != sorted(map(sorted, base["joint_connection"])):
        raise AssertionError("projection run: the stored tree was not kept")
    model, state = checkpoint.kinematic_model_from_checkpoint(
        checkpoint.load_checkpoint(os.path.join(save_dir, "model.ckpt.pkl")),
        device=dev)
    n_parts = len(base["joint_connection"]) + 1
    if (not isinstance(model, KinematicModel)
            or model.theta_list.shape != (9, n_parts - 1)
            or state.num_parts != n_parts
            or [list(e) for e in state.edges] != saved["joint_connection"]):
        raise AssertionError("projection run: model.ckpt.pkl does not "
                             "reload into a KinematicModel with its state")
    if fit_launches["auction_solve_resident_hbm"] != PROJECTION_ITERS:
        raise AssertionError(
            f"projection fit: {PROJECTION_ITERS} LAPs of (9, 2048, 2048) but "
            f"{fit_launches['auction_solve_resident_hbm']} launches of the "
            f"streamed auction")
    for name in ("row_top2", "col_winner_max", "auction_solve_resident"):
        if fit_launches[name]:
            raise AssertionError(f"projection fit launched {name} "
                                 f"{fit_launches[name]} times")
    for name in ("blend3", "fps", "auction_solve_resident_hbm", "nn_bidir",
                 "row_top2", "col_winner_max"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"projection run")
    log(f"projection run: {n_parts} parts, edges "
        f"{saved['joint_connection']}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in results.items()))
    log("projection run: seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"projection run: kernel launches of the fit {fit_launches}")
    log(f"projection run: kernel launches {launches}")
    return launches


def backbone_check_phase(dev):
    """The correspondence backbone on the card against the CPU, from the
    same weights and clouds (two frames of the scene, 1024 points each, and
    a cloud of 360 points, fewer than SA1's 512 centroids): the FPS and
    ball-query indices of both SA levels equal, the features of both
    BatchNorm modes within BACKBONE_TOL."""
    from reart_tpu_torch.models.pointnet2 import SA1, SA2, PointNet2Msg2
    from reart_tpu_torch.ops.sampling import (
        ball_query,
        farthest_point_sample,
        index_points,
    )

    sample, centroid, scale = scene()
    norm = (sample["complete_pc_list"] - centroid) * np.float32(scale)
    cpu_model = PointNet2Msg2(device="cpu",
                              generator=torch.Generator().manual_seed(0))
    card_model = PointNet2Msg2(device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    for n in (1024, 360):
        xyz = torch.from_numpy(np.ascontiguousarray(norm[[0, 5], :n]))
        levels = {}
        for where, x in (("cpu", xyz), ("card", xyz.to(dev))):
            out = []
            for spec in (SA1, SA2):
                idx = farthest_point_sample(x, spec[0])
                new = index_points(x, idx)
                out.append(idx)
                out += [ball_query(r, k, x, new)
                        for r, k in zip(spec[1], spec[2])]
                x = new
            levels[where] = [o.cpu() for o in out]
        for a, b in zip(levels["card"], levels["cpu"]):
            if not torch.equal(a, b):
                raise AssertionError(f"backbone N={n}: FPS or ball-query "
                                     f"indices differ between the card and "
                                     f"the CPU")
        worst = 0.0
        for mode in ("running", "batch"):
            with torch.no_grad():
                ref = cpu_model(xyz, bn_mode=mode)
                got = card_model(xyz.to(dev), bn_mode=mode).cpu()
            if got.shape != (2, n, 64) or not torch.isfinite(got).all():
                raise AssertionError(f"backbone N={n} {mode}: features "
                                     f"{tuple(got.shape)} or not finite")
            torch.testing.assert_close(got, ref, **BACKBONE_TOL)
            worst = max(worst, float((got - ref).abs().max()))
        log(f"reference: backbone (2, {n}, 3) on the card: FPS and "
            f"ball-query indices of both SA levels equal the CPU's, "
            f"features of both BatchNorm modes within {BACKBONE_TOL} "
            f"(largest difference {worst:.2e})")


CORR_STEPS = 300
# the real chain's backbone training: the scene's surfaces are sampled,
# where the command's default radii find positives
REAL_CORR_STEPS = 100
# the scene's parts are filled boxes, not surfaces: 1024 of a frame's points
# lie 0.055 apart on average in normalised units, so the resampled recipe's
# default radii (0.02 / 0.05, sized for densely sampled surfaces) would leave
# 3 in 100 source points with a positive; these leave 6 in 10
CORR_RADII = ("--pos_radius", "0.06", "--neg_radius", "0.15")


def corr_train_phase(dev, tmp, sample):
    """The `corr` subcommand at full width: the scene written to disk as a
    robot sequence with its normalisation file, CORR_STEPS steps of batch 4
    at 1024 points on the card. The loss must fall and the trained backbone
    must match points of the real frame pairs."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.data.synth import (
        write_normalize_file,
        write_robot_sequence,
    )
    from reart_tpu_torch.models.pointnet2 import load_corr_model

    seq_dir = os.path.join(tmp, "table_seq")
    norm_file = os.path.join(tmp, "normalize.pkl")
    corr_path = os.path.join(tmp, "corr_model.pkl")
    write_robot_sequence(seq_dir, sample)
    write_normalize_file(norm_file, seq_dir, sample)
    for w in kernel_wrappers():
        w.launches = 0
    # no device is named: the command line takes the card by itself
    out = cli.main([
        "corr", "--data_domain", "robot", "--seq_path", seq_dir,
        "--normalize_file", norm_file, "--num_points", "4096", "--batch", "4",
        "--train_points", "1024", "--steps", str(CORR_STEPS),
        "--dispatch_chunk", "50", "--save_path", corr_path, *CORR_RADII])
    torch.cuda.synchronize()
    launches = launch_counts()
    for key in ("loss", "first_loss", "precision", "match_rate",
                "real_match_rate"):
        if not math.isfinite(out[key]):
            raise AssertionError(f"corr: {key} = {out[key]} is not finite")
    head, tail = (float(np.mean(out["losses"][:10])),
                  float(np.mean(out["losses"][-10:])))
    if not tail < head:
        raise AssertionError(f"corr: the loss did not fall: mean of the "
                             f"first ten steps {head}, of the last ten "
                             f"{tail}")
    if not (out["match_rate"] > 0.0 and out["real_match_rate"] > 0.0):
        raise AssertionError(f"corr: no point matched: {out}")
    model = load_corr_model(corr_path)
    if next(model.parameters()).device.type != "cuda" or model.out_dim != 64:
        raise AssertionError("corr: the checkpoint does not reload onto the "
                             "card")
    # per step: 2 FPS, 5 ball queries, 2 k-NN searches; the evaluation adds
    # three forwards (the held-out pair, the two halves of the real pairs)
    want = {"fps": 2, "ball_query": 5, "nn_topk": 2}
    for name, per in want.items():
        if launches[name] != per * (CORR_STEPS + 3):
            raise AssertionError(f"corr: {launches[name]} launches of "
                                 f"{name}, expected {per} a forward")
    log(f"corr: {CORR_STEPS} steps of batch 4 x 1024 points in "
        f"{out['train_seconds']:.2f} s "
        f"({CORR_STEPS / out['train_seconds']:.2f} steps/s, "
        f"{1e3 * out['train_seconds'] / CORR_STEPS:.2f} ms a step, the "
        f"first step's warm-up included); loss {out['first_loss']:.3f} -> "
        f"{out['loss']:.3f} (mean of the first ten steps {head:.3f}, of the "
        f"last ten {tail:.3f}); held-out SMNN precision {out['precision']:.3f}, "
        f"match rate {out['match_rate']:.3f}; real frame pairs match rate "
        f"{out['real_match_rate']:.3f}")
    log(f"corr: kernel launches {launches}")
    corr_step_profile(dev, model, seq_dir, norm_file)
    corr_default_radii_phase(tmp, seq_dir, norm_file)
    return launches, seq_dir, norm_file, corr_path


def corr_default_radii_phase(tmp, seq_dir, norm_file, steps=40):
    """The `corr` subcommand as its defaults stand (radii 0.02 / 0.05), for
    a few steps: the same step and the same launches as the tuned run above;
    only the share of source points with a positive differs (see
    CORR_RADII), so its matching numbers say little about the backbone."""
    from reart_tpu_torch import cli

    for w in kernel_wrappers():
        w.launches = 0
    out = cli.main([
        "corr", "--data_domain", "robot", "--seq_path", seq_dir,
        "--normalize_file", norm_file, "--num_points", "4096",
        "--steps", str(steps), "--dispatch_chunk", str(steps),
        "--save_path", os.path.join(tmp, "corr_default_radii.pkl")])
    torch.cuda.synchronize()
    launches = launch_counts()
    if not all(math.isfinite(out[k]) for k in ("loss", "first_loss",
                                               "precision", "match_rate")):
        raise AssertionError(f"corr, default radii: not finite: {out}")
    for name, per in {"fps": 2, "ball_query": 5, "nn_topk": 2}.items():
        if launches[name] != per * (steps + 3):
            raise AssertionError(f"corr, default radii: {launches[name]} "
                                 f"launches of {name}, expected {per} a "
                                 f"forward")
    log(f"corr, default radii: {steps} steps of batch 4 x 1024 points in "
        f"{out['train_seconds']:.2f} s "
        f"({steps / out['train_seconds']:.2f} steps/s); loss "
        f"{out['first_loss']:.3f} -> {out['loss']:.3f}; held-out SMNN "
        f"precision {out['precision']:.3f}, match rate "
        f"{out['match_rate']:.3f}; real frame pairs match rate "
        f"{out['real_match_rate']:.3f}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")


def device_time_by_name(prof):
    """{kernel or copy name: microseconds on the device} of a profile; the
    device-side events only (an operator's entry repeats its kernels)."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        # the optimizer's own annotations ("Optimizer.step#Adam.step") are
        # device-side ranges, not kernels: they repeat their kernels
        if (evt.device_type != DeviceType.CUDA
                or evt.key.startswith("Optimizer.")):
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t > 0:
            out[evt.key] = out.get(evt.key, 0.0) + t
    return out


# kernel-name fragments of a profile's classes, first match wins
KERNEL_CLASSES = (
    ("the port's kernels", ("ball_query_kernel", "fps_kernel",
                            "nn_topk_kernel")),
    ("matrix products", ("gemm", "cutlass", "cublas", "gemv")),
    ("reductions", ("reduce_kernel",)),
    ("gathers and their backward", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def log_profile(what, prof, calls, wall_ms):
    by_name = device_time_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3 / calls
    if busy_ms == 0.0:
        log(f"{what}: device time not measured (the profiler recorded no "
            f"device activity); {wall_ms:.2f} ms of wall clock")
        return
    classes = {}
    for name, t in by_name.items():
        label = next((c for c, frags in KERNEL_CLASSES
                      if any(f in name.lower() for f in frags)), "other")
        classes[label] = classes.get(label, 0.0) + t / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"{what}: {wall_ms:.2f} ms of wall clock, {busy_ms:.2f} ms of "
        f"device time ({100 * max(0.0, 1 - busy_ms / wall_ms):.0f}% idle) "
        f"in {len(by_name)} kernel names: "
        + ", ".join(f"{c} {t:.3f} ms" for c, t in
                    sorted(classes.items(), key=lambda kv: -kv[1]))
        + "; largest: "
        + "; ".join(f"{name[:70]} {t / 1e3 / calls:.2f} ms"
                    for name, t in top))


def corr_step_profile(dev, model, seq_dir, norm_file):
    """Where a training step's and a feature extraction's time goes: 20
    steps on the host clock, then 5 steps and one extraction of nine
    4096-point frames under torch.profiler (kernel time by name)."""
    from torch.profiler import ProfilerActivity, profile

    from reart_tpu_torch import cli
    from reart_tpu_torch.train import corr as tc

    args = cli.build_parser().parse_args(
        ["corr", "--seq_path", seq_dir, "--normalize_file", norm_file])
    frames = torch.as_tensor(cli._corr_training_frames(args)[0], device=dev)
    cfg = tc.CorrTrainConfig(batch=4, n_points=1024,
                             pos_radius=float(CORR_RADII[1]),
                             neg_radius=float(CORR_RADII[3]))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        src, tgt, gt_pos, scale = tc.synth_pair(
            tc.draw_pairs(gen, frames.shape[0], frames.shape[1], cfg),
            frames, cfg)
        return tc._train_step(model, opt, cfg, src, tgt, gt_pos, scale)

    def timed(fn, calls):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / calls

    def extract():
        with torch.no_grad():
            return model(frames[:-1])

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    step_ms = timed(step, 20)
    with profile(activities=acts) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    log_profile("corr: a training step (batch 4 x 1024 points)", prof, 5,
                step_ms)
    extract_ms = timed(extract, 5)
    with profile(activities=acts) as prof:
        extract()
        torch.cuda.synchronize()
    log_profile("corr: one feature extraction of (9, 4096, 3)", prof, 1,
                extract_ms)


def corr_flow_run_phase(dev, tmp, sample, seq_dir, norm_file, corr_path,
                        stats):
    """The relaxation run of phase 6 with the default --flow_provider corr:
    the flow anchors are the SMNN matches of the backbone that the `corr`
    subcommand has just trained. Afterwards blend3 is held to its plain
    version on the anchors this run's setup_flow made (each frame pair's
    SMNN matches, padded with FAR to the largest count)."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.ops import cuda_nn
    from reart_tpu_torch.profiling import phase_report, reset_phases
    from reart_tpu_torch.train.engine import FAR

    args = cli.build_parser().parse_args(
        ["robot", "--use_flow_loss", "--use_assign_loss", "--save_root", tmp,
         "--seq_path", seq_dir, "--normalize_file", norm_file,
         "--corr_model_path", corr_path, *RUN_PROTOCOL.split()])
    if args.flow_provider != "corr":
        raise AssertionError("--flow_provider does not default to corr")
    save_dir = os.path.join(tmp, "table_corr_flow")
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    # setup_flow is timed, and its anchors and launches read, where
    # run_sample calls it
    seen = {}
    setup_flow = cli.setup_flow

    def timed_setup_flow(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = setup_flow(*a, **kw)
        torch.cuda.synchronize()
        seen.update(seconds=time.perf_counter() - t0, ctx=ctx,
                    launches=launch_counts())
        return ctx

    cli.setup_flow = timed_setup_flow
    try:
        # no device is named: the entry points take the card by themselves
        results = cli.run_sample(args, "robot", sample, save_dir)
    finally:
        cli.setup_flow = setup_flow
    torch.cuda.synchronize()
    launches = launch_counts()

    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"corr-flow run: {k} = {v} is not finite")
    if read_result_txt(os.path.join(save_dir, "result.txt")).keys() \
            != results.keys() or "flow_epe" not in results:
        raise AssertionError("corr-flow run: result.txt does not list the "
                             "results")
    anchors = (seen["ctx"].pc_ref[..., 0] < FAR / 2).sum(1).tolist()
    if seen["ctx"].pc_ref.device.type != "cuda" or min(anchors) < 3:
        raise AssertionError(f"corr-flow run: anchors per frame pair "
                             f"{anchors}")
    # two extractions of nine frames: 2 x (2 FPS, 5 ball queries, 2 k-NN)
    for name, count in (("fps", 4), ("ball_query", 10), ("nn_topk", 4)):
        if seen["launches"][name] != count:
            raise AssertionError(f"setup_flow: {seen['launches'][name]} "
                                 f"launches of {name}, expected {count}")
    for name in ("ball_query", "fps", "nn_topk", "blend3",
                 "nn1_bidir_coords", "auction_solve_resident"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"corr-flow run")
    log(f"corr-flow run: setup_flow {seen['seconds']:.3f} s, anchors per "
        f"frame pair {anchors} of 4096 points; "
        + ", ".join(f"{k} {v:.3f}" for k, v in results.items()))
    log("corr-flow run: seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"corr-flow run: kernel launches of setup_flow {seen['launches']}")
    log(f"corr-flow run: kernel launches {launches}")

    # the flow loss's call: the source frames against the run's own anchors
    ctx = seen["ctx"]
    query = torch.from_numpy(np.ascontiguousarray(
        sample["complete_pc_list"][:-1], np.float32)).to(dev)
    got = cuda_nn.blend3(query, ctx.pc_ref, ctx.flow_ref)
    ref = cuda_nn.blend3_plain(query, ctx.pc_ref, ctx.flow_ref)
    label = (f"blend3 {tuple(query.shape)} vs the run's anchors "
             f"{tuple(ctx.pc_ref.shape)}")
    err = check(label, got, ref, exact=set())
    if not torch.equal((got[1] <= got[2]) | (got[1] <= 0.05),
                       (ref[1] <= ref[2]) | (ref[1] <= 0.05)):
        raise AssertionError(f"{label}: validity mask differs")
    stats["blend3"]["max_abs_err"] = max(stats["blend3"]["max_abs_err"], err)
    ms = many_ms(lambda: cuda_nn.blend3(query, ctx.pc_ref, ctx.flow_ref))
    log(f"{label}: mask exact, floats within {FLOAT_TOL}; {ms:.4f} ms a "
        f"call, back to back")
    return launches


def fit_phase(dev):
    """fit_base at nao scale: T=10, N=4096, P=20, flow + assign losses,
    assign_gap 5, downsample 4 (LAP 9 x 1024^2), 30 + 30 iterations."""
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.models.base_model import gumbel_noise
    from reart_tpu_torch.train import FitConfig, FlowContext, fit_base

    cano, pcs, complete = sequence(dev)
    c = complete.cpu().numpy()
    flow_ctx = FlowContext.from_lists([c[i] for i in range(9)],
                                      [c[i + 1] - c[i] for i in range(9)],
                                      device=dev)
    cfg = FitConfig(n_iter=60, use_assign_loss=True, use_flow_loss=True,
                    assign_iter=30, assign_gap=5, downsample=4)

    def make_model(seed):
        return BaseModel(20, 9, generator=torch.Generator().manual_seed(seed))

    # warm-up fit: cuBLAS handles, allocator, kernel library
    fit_base(make_model(1), FitConfig(n_iter=10, use_assign_loss=True,
                                      use_flow_loss=True, assign_iter=5),
             cano, pcs, flow_ctx=flow_ctx)
    torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(0)
    marks = {}

    def noise(it):  # called once per iteration, in order
        if it in (0, cfg.assign_iter):
            torch.cuda.synchronize()
            marks[it] = time.perf_counter()
        return gumbel_noise((4096, 20), gen, dev)

    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    _, hist = fit_base(make_model(0), cfg, cano, pcs, flow_ctx=flow_ctx,
                       noise=noise)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {w.__name__: w.launches for w in wrappers}

    for k, v in hist.items():
        if v.shape != (cfg.n_iter,) or not torch.isfinite(v).all():
            raise AssertionError(f"fit history {k}: shape {tuple(v.shape)} "
                                 f"or non-finite values")
    total = hist["total_loss"].cpu().numpy()
    if not total[-1] < total[0]:
        raise AssertionError(f"total_loss did not fall: {total[0]} -> "
                             f"{total[-1]}")
    for name in ("nn1_bidir_coords", "blend3", "fps",
                 "auction_solve_resident"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the fit")
    n_recon = cfg.assign_iter
    recon_s = marks[n_recon] - marks[0]
    assign_s = t_end - marks[n_recon]
    log(f"fit: fit_base nao scale, {cfg.n_iter} iters: total_loss "
        f"{total[0]:.4f} -> {total[-1]:.4f}; recon+flow phase "
        f"{n_recon / recon_s:.2f} iters/s (incl. the FPS assign-context "
        f"build), assign+flow phase "
        f"{(cfg.n_iter - n_recon) / assign_s:.2f} iters/s")
    log(f"fit: kernel launches {launches}")
    return launches


def banded_kernel_phase(dev, tmp, stats):
    """auction_solve_banded against its plain version on the card, row_to_col,
    prices and per-phase stats exact: at the sapien relaxation's LAP, (7,
    4096, 4096) with w=1024, tile 256 (the full-width scene's GT clouds of
    views 1-7 a little off against the observed views, Hilbert-sorted), and
    at the robot's downsample-2 LAP, (9, 2048, 2048) with w=512 (Morton);
    cold and warm (the cold solve's prices, the source moved a little),
    carry off and on."""
    from reart_tpu_torch.data.sapien import SapienDataset
    from reart_tpu_torch.data.synth import make_robot_sample, make_sapien_scene
    from reart_tpu_torch.ops import cuda_auction
    from reart_tpu_torch.ops.assignment import _curve_sort, band_tile

    solve = cuda_auction.auction_solve_banded
    plain = cuda_auction.auction_solve_banded_plain
    eps = (5e-3, 1e-4)  # the fit's schedule: eps_min 1e-4, 2 scales, x50
    rng = np.random.RandomState(0)

    def problem(src, tgt, w):
        src = src + 0.02 * rng.randn(*src.shape).astype(np.float32)
        s, t, _, _ = _curve_sort(torch.from_numpy(src).to(dev),
                                 torch.from_numpy(tgt).to(dev), w, None)
        moved = s + 0.002 * torch.from_numpy(
            rng.randn(*src.shape).astype(np.float32)).to(dev)
        return s.contiguous(), moved.contiguous(), t.contiguous()

    root = make_sapien_scene(os.path.join(tmp, "sapien_kernel"), n_views=8,
                             n_points=4096, n_parts=6)
    sap = SapienDataset(root)[0]
    robot = make_robot_sample(n_frames=10, n_points=2048, n_parts=6, seed=1)
    shapes = {"(7, 4096, 4096) w=1024": (
        problem(sap["gt_pc_list"], sap["pc_list"], 1024), 1024),
        "(9, 2048, 2048) w=512": (
        problem(robot["gt_pc_list"], robot["pc_list"], 512), 512)}
    err = 0.0
    counts = {}
    for shape, ((src, moved, tgt), w) in shapes.items():
        b, n = src.shape[:2]
        zero = torch.zeros((b, n), device=dev)
        for carry in (False, True):
            cold = solve(src, tgt, zero, eps, 100, w, carry=carry,
                         return_stats=True)
            cases = (("cold", src, zero, cold),
                     ("warm", moved, cold[1], None))
            for label, s, p, got in cases:
                if got is None:
                    got = solve(s, tgt, p, eps, 100, w, carry=carry,
                                return_stats=True)
                torch.cuda.synchronize()
                ref = plain(s, tgt, p, eps, 100, w, carry=carry,
                            return_stats=True)
                name = f"auction_banded {shape} {label} carry={carry}"
                err = max(err, check(name, got, ref, exact={0, 1, 2}))
                counts[name] = got[2]
                st = got[2]
                log(f"{name}: row_to_col, prices and stats exact; sweeps "
                    f"per phase {st[..., 0].T.tolist()}, bidding rows "
                    f"{st[..., 1].sum(0).tolist()}, bidding tiles "
                    f"{st[..., 2].sum(0).tolist()} (of {n // band_tile(n)} "
                    f"a sweep an element), duplicate columns "
                    f"{int(n * b - sum(len(torch.unique(r)) for r in got[0]))}")

    # timed at the sapien shape, warm, carry off (the fit's call)
    (src, moved, tgt), w = shapes["(7, 4096, 4096) w=1024"]
    b, n = src.shape[:2]
    zero = torch.zeros((b, n), device=dev)
    warm_price = solve(src, tgt, zero, eps, 100, w)[1]
    st = counts["auction_banded (7, 4096, 4096) w=1024 warm carry=False"]
    tile = band_tile(n)
    # the least work this run's data needs: each phase builds the band's
    # distances once (3 subtractions, 3 products, 2 additions, a square
    # root), and each row that bids passes its window once per sweep (a
    # subtraction and two comparisons); the TPU kernel passes whole tiles
    # (tile_ops, logged beside it). The bytes: the points and prices in,
    # the map and prices out
    band_ops = len(eps) * b * n * w * (PAIR_FLOPS + 1)
    pass_ops = int(st[..., 1].sum()) * w * 3
    tile_ops = int(st[..., 2].sum()) * tile * w * 3
    out = solve(moved, tgt, warm_price, eps, 100, w)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (moved, tgt, warm_price, *out))
    stats["auction_solve_banded"] = dict(
        shape="(7, 4096, 4096) w=1024, warm", max_abs_err=err,
        ms=many_ms(lambda: solve(moved, tgt, warm_price, eps, 100, w), 5, 5),
        ms_cold=many_ms(lambda: solve(src, tgt, zero, eps, 100, w), 5, 5),
        plain_ms=median_ms(
            lambda: plain(moved, tgt, warm_price, eps, 100, w), 2),
        band_ops=band_ops, pass_ops=pass_ops, tile_ops=tile_ops,
        **bound_of(band_ops + pass_ops, nbytes))
    s2 = stats["auction_solve_banded"]
    log(f"auction_banded (7, 4096, 4096) w=1024: warm {s2['ms']:.4f} ms, cold "
        f"{s2['ms_cold']:.4f} ms, plain {s2['plain_ms']:.1f} ms; bound "
        f"{s2['bound_ms']:.5f} ms by {s2['bound_by']} (band distances "
        f"{band_ops / 1e6:.1f} M operations, the bidding rows' window "
        f"passes {pass_ops / 1e6:.1f} M (whole bidding tiles: "
        f"{tile_ops / 1e6:.1f} M), {nbytes / 1e6:.2f} MB)")


def _record_guard_probes():
    """Wrap the fit engine's band-guard probe so that each call's two
    matched costs are kept; returns (the list they go to, the restore)."""
    from reart_tpu_torch.train import engine

    seen = []
    probe = engine._band_guard_probe

    def recorded(*a, **kw):
        costs = probe(*a, **kw)
        seen.append(costs)
        return costs

    engine._band_guard_probe = recorded

    def restore():
        engine._band_guard_probe = probe

    return seen, restore


def _drive(args, domain, sample, save_dir, what, probes=None):
    """One run of the command line's main path on the card (no device is
    named: the entry points take the card by themselves), every launch
    count set to 0 just before and read just after. Returns (results,
    launches, seconds per stage, wall seconds)."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.profiling import phase_report, reset_phases

    reset_phases()
    if probes is not None:
        probes.clear()
    for w in kernel_wrappers():
        w.launches = 0
    t0 = time.perf_counter()
    results = cli.run_sample(args, domain, sample, save_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"{what}: {k} = {v} is not finite")
    if read_result_txt(os.path.join(save_dir, "result.txt")).keys() \
            != results.keys():
        raise AssertionError(f"{what}: result.txt does not list the results")
    log(f"{what}: " + ", ".join(f"{k} {v:.4f}" for k, v in results.items()))
    log(f"{what}: {wall:.2f} s; seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"{what}: kernel launches {launches}")
    return results, launches, phase_report(), wall


def _joint_types(payload):
    """The joint type of each edge of a kinematic model.ckpt.pkl."""
    pris = payload.get("prismatic_mask")
    return ["revolute"] * len(payload["edges"]) if pris is None else [
        "prismatic" if p else "revolute" for p in np.asarray(pris)]


def _log_probes(what, probes, guard):
    for i, (cb, cd) in enumerate(probes):
        rel = cb / max(cd, 1e-12) - 1.0
        log(f"{what}: guard probe {i}: banded matched cost {cb:.3f}, dense "
            f"{cd:.3f}, relative {rel:+.4f} -> "
            f"{'banded' if rel <= guard else 'dense'}")


SAPIEN_PROTOCOL = ("--downsample 1 --num_parts 10 --use_flow_loss "
                   "--use_assign_loss --n_iter 400 --assign_iter 300 "
                   "--assign_band_reprobe 50 --seg_refine 2")
SAPIEN_PROJECTION = ("--model kinematic --tree_search 0 --downsample 1 "
                     "--use_flow_loss --use_assign_loss --n_iter 100 "
                     "--assign_iter 50 --assign_band_reprobe 0")


def sapien_chain_phase(dev, tmp):
    """The sapien domain at full width: `make_sapien_scene`, 8 views x 4096
    points, 6 parts (three revolute and two prismatic joints); the
    relaxation run from the scene's --flow_file at --downsample 1 (a (7,
    4096, 4096) LAP every 5 iterations, banded on the card, the guard
    probing at the phase start and re-probing once), then the projection
    run from its result.pkl. Fails unless the banded kernel launched."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import make_sapien_scene

    root = make_sapien_scene(os.path.join(tmp, "sapien"), n_views=8,
                             n_points=4096, n_parts=6)
    common = ["sapien", "--sapien_base_folder", root, "--sapien_idx", "0",
              "--flow_file", os.path.join(root, "flow.npz")]
    args = cli.build_parser().parse_args(
        common + ["--save_root", os.path.join(tmp, "sapien_base"),
                  *SAPIEN_PROTOCOL.split()])
    sample = cli.dataset_sample(cli.load_dataset(args), 0)
    probes, restore = _record_guard_probes()
    out = {}
    try:
        save_dir = os.path.join(tmp, "sapien_base", "0")
        out["relaxation"] = _drive(args, "sapien", sample, save_dir,
                                   "sapien relaxation run", probes)
        _log_probes("sapien relaxation run", probes, args.assign_band_guard)
        if len(probes) != 2:
            raise AssertionError(f"sapien relaxation run: {len(probes)} guard "
                                 f"probes, expected the phase start's and "
                                 f"one re-probe")
        base = os.path.join(save_dir, "result.pkl")
        kargs = cli.build_parser().parse_args(
            common + ["--save_root", os.path.join(tmp, "sapien_kin"),
                      "--base_result_path", base,
                      *SAPIEN_PROJECTION.split()])
        out["projection"] = _drive(kargs, "sapien", sample,
                                   os.path.join(tmp, "sapien_kin", "0"),
                                   "sapien projection run", probes)
        _log_probes("sapien projection run", probes, args.assign_band_guard)
    finally:
        restore()
    for stage, (results, launches, _, _) in out.items():
        for key in ("full_flow_epe", "per_scan_ri", "multi_scan_ri"):
            if key not in results:
                raise AssertionError(f"sapien {stage} run: no {key}")
        for name in ("auction_solve_banded", "nn1_bidir_coords", "blend3",
                     "fps"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"sapien {stage} run")
    payload = checkpoint.load_checkpoint(
        os.path.join(tmp, "sapien_kin", "0", "model.ckpt.pkl"))
    log(f"sapien projection run: joints {_joint_types(payload)}, root "
        f"trajectory {payload['has_root_trans']}")
    return {k: v[1] for k, v in out.items()}


def real_chain_phase(dev, tmp):
    """The real domain at full width: `write_real_scene`, 6 OBJ frames (a
    body, a hinged flap, a slider); `corr --data_domain real` trains the
    backbone on them (REAL_CORR_STEPS steps, batch 4 x 1024 points); the
    relaxation run from its SMNN anchors at --num_points 4096 --downsample
    4; the projection run from its result.pkl, prismatic joints allowed."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import write_real_scene

    scans = write_real_scene(os.path.join(tmp, "real", "scans"), 6)
    corr_path = os.path.join(tmp, "real", "corr_model.pkl")
    cargs = cli.build_parser().parse_args(
        ["corr", "--data_domain", "real", "--seq_path", scans,
         "--num_points", "4096", "--steps", str(REAL_CORR_STEPS),
         "--save_path", corr_path])
    for w in kernel_wrappers():
        w.launches = 0
    t0 = time.perf_counter()
    corr = cli.run_train_corr(cargs)
    torch.cuda.synchronize()
    out = {"corr": (corr, launch_counts(), {}, time.perf_counter() - t0)}
    log(f"real corr run: {out['corr'][3]:.2f} s, loss {corr['first_loss']:.3f} "
        f"-> {corr['loss']:.3f}, held-out precision {corr['precision']:.3f} "
        f"at match rate {corr['match_rate']:.3f}, real pairs "
        f"{corr['real_match_rate']:.3f}; kernel launches {out['corr'][1]}")
    common = ["real", "--seq_path", scans, "--num_points", "4096",
              "--downsample", "4", "--use_flow_loss", "--use_assign_loss",
              "--corr_model_path", corr_path, "--num_parts", "10"]
    args = cli.build_parser().parse_args(
        common + ["--save_root", os.path.join(tmp, "real_base"), "--n_iter",
                  "400", "--assign_iter", "300"])
    sample = cli.dataset_sample(cli.load_dataset(args))
    save_dir = os.path.join(tmp, "real_base", "scans")
    out["relaxation"] = _drive(args, "real", sample, save_dir,
                               "real relaxation run")
    base = os.path.join(save_dir, "result.pkl")
    if not checkpoint.load_result(base)["joint_connection"]:
        raise AssertionError("real relaxation run: a single part, no tree")
    kargs = cli.build_parser().parse_args(
        common + ["--save_root", os.path.join(tmp, "real_kin"), "--model",
                  "kinematic", "--tree_search", "0", "--base_result_path",
                  base, "--n_iter", "100", "--assign_iter", "50"])
    out["projection"] = _drive(kargs, "real", sample,
                               os.path.join(tmp, "real_kin", "scans"),
                               "real projection run")
    for stage in ("relaxation", "projection"):
        results, launches = out[stage][:2]
        if "seg_ri" in results or "cd_err" not in results:
            raise AssertionError(f"real {stage} run: results {sorted(results)}")
        for name in ("ball_query", "fps", "blend3", "nn1_bidir_coords",
                     "auction_solve_resident"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"real {stage} run")
    payload = checkpoint.load_checkpoint(
        os.path.join(tmp, "real_kin", "scans", "model.ckpt.pkl"))
    log(f"real projection run: joints {_joint_types(payload)}")
    return {k: v[1] for k, v in out.items()}


# the toy sapien run on the card vs on the CPU, from the same parameters and
# Gumbel draws, the bars of the toy robot run (RUN_TOL) in this domain's
# units: errors in the data's units (the robot's 0.4 cm is 0.004), the full
# flow in cm. The relaxation is 200 iterations of a non-convex fit, so a
# rounding-level difference moves its small errors (a few 1e-4 at a healthy
# fit) by tens of percent: they are held to absolute bars of 0.1 cm. The
# projection starts from one result.pkl on both devices and keeps the
# relative bars of the robot run.
SAPIEN_PROJ_TOL = {"seg_ri": ("abs", 0.02), "recon_err": ("abs", 0.004),
                   "cd_err": ("rel", 0.25), "full_flow_epe": ("abs", 0.3),
                   "per_scan_ri": ("abs", 0.02),
                   "multi_scan_ri": ("abs", 0.02), "ass_err": ("rel", 0.25),
                   "screw_err": ("abs", 0.01), "total_err": ("rel", 0.25)}
SAPIEN_RUN_TOL = {**SAPIEN_PROJ_TOL, "cd_err": ("abs", 0.001),
                  "ass_err": ("abs", 0.001), "total_err": ("abs", 0.001)}
# the toy relaxation's seed: it lands in the 3-part basin (lid and drawer
# apart from the body), where the tree and the joint types are well posed
TOY_SAPIEN_SEED = 3


def _joints(tree):
    """A tree's joints as unordered part pairs. Off the robot domain the
    relaxation's edge order and direction carry nothing onward: the
    projection re-roots the tree at the largest part (kinematic_from_tree),
    and the direction is the MST's pick between two nearly equal costs."""
    return sorted(sorted(int(v) for v in e) for e in tree)


def toy_sapien_phase(dev, tmp):
    """A 3-part toy sapien scene (4 views x 300 points: LAPs of 300^2, the
    dense one-launch solver on both devices) through both stages on the card
    and on the CPU from the same parameters, Gumbel draws and result.pkl:
    the relaxation healthy on the card (multi-scan RI > 0.9), its joints
    equal, its numbers within SAPIEN_RUN_TOL; the projection from the CPU's
    result.pkl with labels, tree and joint types equal, its numbers within
    SAPIEN_PROJ_TOL."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import make_sapien_scene

    root = make_sapien_scene(os.path.join(tmp, "toy_sapien"), n_views=4,
                             n_points=300, n_parts=3)
    common = ["sapien", "--sapien_base_folder", root, "--sapien_idx", "0",
              "--flow_file", os.path.join(root, "flow.npz"), "--silence",
              "--use_flow_loss", "--use_assign_loss", "--num_parts", "5",
              "--manual_seed", str(TOY_SAPIEN_SEED)]
    args = cli.build_parser().parse_args(
        common + ["--n_iter", "200", "--assign_iter", "120", "--end_tau",
                  "0.5"])
    sample = cli.dataset_sample(cli.load_dataset(args), 0)

    def noise(it):
        return np.random.RandomState(1000 * TOY_SAPIEN_SEED + it).gumbel(
            size=(300, 5)).astype(np.float32)

    def pair(args, stage):
        runs = {}
        for where in ("cpu", dev):
            save_dir = os.path.join(tmp, f"toy_sapien_{stage}_"
                                         f"{torch.device(where).type}")
            res = cli.run_sample(args, "sapien", sample, save_dir,
                                 device=where, noise=noise)
            runs[str(where)] = (
                res, checkpoint.load_result(os.path.join(save_dir,
                                                         "result.pkl")),
                checkpoint.load_checkpoint(os.path.join(save_dir,
                                                        "model.ckpt.pkl")))
        return runs[str(dev)], runs["cpu"]

    card, cpu = pair(args, "base")
    log(f"reference: toy sapien relaxation on the card {card[0]}, tree "
        f"{card[1]['joint_connection']}")
    log(f"reference: on the CPU {cpu[0]}, tree {cpu[1]['joint_connection']}")
    if _joints(card[1]["joint_connection"]) != _joints(
            cpu[1]["joint_connection"]):
        raise AssertionError("toy sapien: the trees' joints differ between "
                             "the card and the CPU")
    if not card[0]["multi_scan_ri"] > 0.9:
        raise AssertionError(f"toy sapien on the card is not healthy: "
                             f"multi_scan_ri {card[0]['multi_scan_ri']}")
    diffs = within(card[0], cpu[0], SAPIEN_RUN_TOL, "toy sapien")
    log(f"reference: toy sapien relaxation healthy, its joints "
        f"{_joints(cpu[1]['joint_connection'])} equal, within "
        f"{SAPIEN_RUN_TOL}: " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in diffs.items()))
    base = os.path.join(tmp, "toy_sapien_base_cpu", "result.pkl")
    kargs = cli.build_parser().parse_args(
        common + ["--model", "kinematic", "--tree_search", "0",
                  "--base_result_path", base, "--n_iter", "40",
                  "--assign_iter", "20"])
    card, cpu = pair(kargs, "kin")
    if (card[1]["joint_connection"] != cpu[1]["joint_connection"]
            or not np.array_equal(card[1]["pred_cano_part"],
                                  cpu[1]["pred_cano_part"])
            or _joint_types(card[2]) != _joint_types(cpu[2])):
        raise AssertionError(
            f"toy sapien projection: labels, tree or joint types differ "
            f"between the card and the CPU: trees "
            f"{card[1]['joint_connection']} vs {cpu[1]['joint_connection']}, "
            f"joints {_joint_types(card[2])} vs {_joint_types(cpu[2])}")
    diffs = within(card[0], cpu[0], SAPIEN_PROJ_TOL, "toy sapien projection")
    log(f"reference: toy sapien projection on the card {card[0]}, joints "
        f"{_joint_types(card[2])}; labels, tree and "
        f"joint types equal to the CPU's, within {SAPIEN_PROJ_TOL}: "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs "
              "only on a CUDA GPU", file=sys.stderr)
        return 1
    import reart_tpu_torch  # noqa: F401  (precision defaults)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = device_phase()
    build_phase()
    stats = kernel_phase(dev)
    reference_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        toy_robot_phase(dev, tmp)
        finalize_phase(dev, tmp)
        kinematic_check_phase(dev, tmp)
        backbone_check_phase(dev)
        fit_launches = fit_phase(dev)
        run_launches, sample, result_path = run_phase(dev, tmp)
        projection_launches = projection_run_phase(dev, tmp, sample,
                                                   result_path)
        corr_launches, seq_dir, norm_file, corr_path = corr_train_phase(
            dev, tmp, sample)
        corr_flow_launches = corr_flow_run_phase(dev, tmp, sample, seq_dir,
                                                 norm_file, corr_path, stats)
        toy_sapien_phase(dev, tmp)
        sapien = sapien_chain_phase(dev, tmp)
        real = real_chain_phase(dev, tmp)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)  # once more, where the end of a long log still shows it
    kernels = []
    for name, (src, rep) in KERNELS.items():
        st = stats[name]
        # launches: over the full-width main paths, each driven from counts
        # of 0 (robot: the relaxation run, the projection run, the corr
        # training run, the relaxation run from corr flow; sapien: both
        # runs; real: the corr training run and both runs)
        paths = (run_launches, projection_launches, corr_launches,
                 corr_flow_launches, *sapien.values(), *real.values())
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(p[name] for p in paths),
                 "launches_run": run_launches[name],
                 "launches_projection": projection_launches[name],
                 "launches_corr_train": corr_launches[name],
                 "launches_corr_flow_run": corr_flow_launches[name],
                 "launches_sapien_run": sapien["relaxation"][name],
                 "launches_sapien_projection": sapien["projection"][name],
                 "launches_real_corr_train": real["corr"][name],
                 "launches_real_run": real["relaxation"][name],
                 "launches_real_projection": real["projection"][name],
                 "launches_fit": fit_launches[name],
                 "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                 "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                 "bound_by": st["bound_by"],
                 # no single PyTorch call computes any of these functions
                 "library_ms": None, "shape": st["shape"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

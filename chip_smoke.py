#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reart_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build:  compiles reart_tpu_torch/csrc/*.cu (sm_90a) into the kernel
             library and native/lap.cpp with the host compiler, and prints
             the build time and ptxas resource lines;
  3. kernels vs plain: each of the thirteen kernels that replace a TPU
             kernel against its plain PyTorch version on the card, and the
             fused BatchNorm (row 14) against the written-out form bit for
             bit at sa1.2's layer shapes, timed beside it, F.batch_norm +
             ReLU and its byte bound; at the main paths' shapes plus
             ragged and tie cases (for blend3 and nn1_bidir_coords also ties
             across
             their slices and tiles, sizes past them, M = 3; for fps N at
             and past the boundaries of its register layout, every point
             equal, one masked point, more picks than masked points; for the
             resident auction, prices exact too, the sweep bound, N = 1,
             N < M, M % 8 != 0, integer-cost ties, one slot buffer, 20
             elements, and the streamed kernel timed on its inputs as a
             yardstick; for the large kernel, the one launch of a LAP past
             2048^2, row_to_col, prices and stats exact at the energy's
             presolve (9, 4096, 4096) of phase 3's clouds and of clouds with
             400-sweep tails, the engine's dense LAP (7, 4096, 4096) cold and
             warm, the sweep bound, N < M, M % 4 != 0, integer-cost ties,
             B = 1, 20 elements and one slot buffer, auction_lap's default
             route against the sweep route, its ms beside the sweep route's
             and the resident kernel's at the same shapes, the bidding
             rows per phase, and its ms at (9, 2048, 2048) beside the
             streamed kernel's); for the streamed kernel (the cluster
             auction with a candidate cache and the tail on one block)
             row_to_col, prices and stats exact at the projection's
             (9, 2048, 2048) cold and warm and at the window's edges (M % 4
             != 0, B = 1, 20 elements, (1, 1025, 1025), the largest M whose
             state fits at N = 80 and, one past it, auction_lap's sweep
             route), the cache's answers, the first sweeps' ms and the ms
             a tail sweep; indices and
             coordinates exact, floats within FLOAT_TOL; ms of many launches
             per event pair (for the two kernels too small to fill the
             queue: of a replayed CUDA graph of many launches, which is
             their device time), and each kernel's bound (the least time the
             card could take); the Chamfer backward: two identical calls
             bit-equal, its scatter equal to the CPU's index_add_, its time
             against the index_add_ scatter;
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
             config, 60 iterations), with every kernel's launch count; a
             second run from the same seeds must give the same history bit
             for bit, and takes torch.profiler windows over 10 recon
             iterations, the assignment phase's start (its two FPS calls and
             first solve) and 10 assign iterations (device busy and idle
             share, device ms an iteration, blend3's and nn1_bidir_coords'
             ms an iteration, fps' and the resident auction's ms in the
             window); then an operator census of one iteration of each
             phase under torch.use_deterministic_algorithms(True,
             warn_only=True);
  6. the run: the relaxation run at full width (T=10, N=4096, 20 parts) on
             an articulated scene made in memory, with every kernel's
             launch count and the seconds of each finalize stage; in this
             and each full-width run after it the sweep kernels (row_top2,
             col_winner_max) must show 0 launches and auction_solve_large
             one a LAP past 2048^2 (the energy's presolve; in the sapien
             runs also the dense solves);
  7. the projection run at full width: the result.pkl of phase 6 through
             `--model kinematic --downsample 2 --assign_gap 1 --assign_band 0`
             for 200 iterations, a LAP of (9, 2048, 2048) in each, then
             finalize with the retargeting error; launch counts of the fit
             and of the whole run, seconds per stage;
  8. the corr chain at full width: the scene of phase 6 written to disk,
             the `corr` subcommand trains the PointNet++ backbone on it
             (batch 4, 1024 points, CORR_STEPS steps; every step's 25
             BatchNorms fused, forward and backward); the operator census
             of a training step, two trainings of CORR_TWIN_STEPS steps from
             the same seeds that must end bit-equal (weights, optimizer and
             generator states, losses), and a step's time with the gathers'
             fixed-order backward against autograd's own, in turns; then the
             relaxation run of phase 6 with the default `--flow_provider
             corr` fits from that file's SMNN anchors; launch counts of
             each, the seconds of setup_flow and of each stage;
  9. a toy sapien scene (LAPs of 300^2) through both stages on the card
             against the CPU: the relaxation healthy, its tree's joints
             equal and its numbers within SAPIEN_RUN_TOL; the projection's
             tree, labels and joint types equal, its numbers within
             SAPIEN_PROJ_TOL;
 10. the sapien chain at full width: make_sapien_scene (8 views x 4096
             points, 6 parts), the relaxation run from its --flow_file at
             --downsample 1 ((7, 4096, 4096) LAPs through the banded kernel,
             the band guard's probes and one re-probe printed, each
             joint's largest relative rotation printed and the result.pkl
             copied to --keep_dir when one is given), then the projection
             run; full_flow_epe,
             per- and multi-scan RI, seconds per stage and launch counts of
             each;
 11. the real chain at full width: write_real_scene (6 OBJ frames), `corr
             --data_domain real`, the relaxation run from its SMNN anchors
             (4096 points, --downsample 4) and the projection run with
             prismatic joints allowed; seconds and launch counts of each;
 12. (run after phase 8, whose files it reads) the tree search from phase
             6's result.pkl: the default projection command (no
             --tree_search: auto, gated), a forced sweep of 4 candidates
             and --tree_select holdout over 3, each with the streamed
             auction's launches in the fit stage equal to candidates x
             short fits x --tree_search_iter + --n_iter; then the
             offset-hinge robot from a wrong stored chain, on the card and
             on the CPU, under both criteria: the star tree each time;
 13. (after 12) `--auto_cano` through `cli.main` on phase 8's table
             sequence: a 50-iteration fit and an energy per each of the 10
             frames, the selected frame in result.pkl; then the toy
             robot's sweep on the card and on the CPU: the same frame.
  A. (after 13) the same sweep as one rows fit, select_canonical_frame(...,
             batched=True) on phase 13's inputs: nn1_bidir_coords (90,
             4096, 4096), fps (90 | 10, 4096) -> 1024 and the resident
             auction (90, 1024, 1024) exact against their plain versions,
             then the same frame and energies within BATCHED_RTOL, the
             rows fits' seconds against the sequential fits';
  B. (after 10) `sapien --batch_seq 0,1,2` through `cli.main` on three
             full-width scenes (8 views x 4096 points, 6 parts, each its
             seed, rates and flow file): result files for each, scene 0
             against phase 10's run within BATCH_SEQ_TOL and against its
             sequential run without the band guard within SAPIEN_RUN_TOL;
             the banded auction (21, 4096, 4096) and blend3 at B = 21
             exact against their plain versions;
  C. (after B and 11) phase 6's run with --snapshot_graph --snapshot_gap
             100 --trace_dir: result.pkl bit-equal to phase 6's, three
             snapshot rows, the trace naming the Chamfer kernel; phases 6's
             and 7's models as torch-format checkpoints, `--resume` of each
             giving the numbers of its model.ckpt.pkl;
  D. (last) the gif/html artifacts of phases 4 (the toy runs, finalize,
             the toy projection and its --evaluate run, each on the card and
             on the CPU), 6, 7, 10, 11 and B: each directory holds input.gif
             (written before the run, as `main` does), recon.gif, gt.gif
             where the sample has GT, seg.html, structure.html and
             novel_<k>.html after a robot projection; every gif T frames of
             320 x 320, looping, 300 ms a frame, every html the viewer with
             sets of the cloud's size; card against CPU, where labels and
             tree are held equal, the html byte-equal and the gifs within
             the frame bars (GIF_MIN_IOU, GIF_CENTROID_PX; the toy robot's
             two fits are reported only); matplotlib and imageio
             never imported; the input.gif and finalize/viz seconds of each
             full-width run.
After the card's name, a "viz probe" line says whether matplotlib, imageio
and PIL are installed on this machine (found without importing them;
reported, not checked).
Phase 3 holds the banded kernel to its plain version at the sapien LAP
((7, 4096, 4096), w=1024) and at (9, 2048, 2048), w=512, cold and warm,
carry off and on, and at w=128, w=M-128, B=1, B=20 and (1, 12288, 12288),
each through the design banded_route picks (the cluster design where its
state fits a block's shared memory, the global-state design past that),
timed beside the global-state design on the same inputs.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports neither jax nor reart_tpu.
"""

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
    # the sweeps of the two kernels above it (rows 7 and 8) past 2048^2
    "auction_solve_large": ("reart_tpu_torch/csrc/auction_large.cu",
                            "reart_tpu/ops/pallas_auction.py:39, "
                            "reart_tpu/ops/pallas_auction.py:105"),
    # replaces no TPU kernel: the JAX package's BatchNorm is fused by XLA
    "batch_norm": ("reart_tpu_torch/csrc/batch_norm.cu", None),
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


# the bounds (bound_ms, bound_by) are reart_tpu_torch.bench_nn's bound and
# bound_of, from the H100's peaks there

# nn_topk's k=1 instruction floor: the 8 float operations of a pair and the
# one fminf of its running minimum, at the H100 SXM's boost clock
INSTR_PER_PAIR = 9
# nn_bidir's: the 8 float operations and one fminf for each direction
BIDIR_INSTR_PER_PAIR = 10
BOOST_HZ = 1.98e9


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
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
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


def index_add_rows(idx, vals, n):
    """The Chamfer backward's scatter that scatter_rows replaced: index_add_,
    float atomics in arrival order on the card. Timed beside scatter_rows."""
    b, c = idx.shape[0], vals.shape[-1]
    offs = torch.arange(b, device=idx.device)[:, None] * n
    out = torch.zeros((b * n, c), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (idx + offs).reshape(-1), vals.reshape(-1, c))
    return out.reshape(b, n, c)


def chamfer_backward_check(dev, randn, pred, obs):
    """The Chamfer backward on the card: two identical calls give the same
    bits, with many duplicate winners (a sparse source against a dense
    target: each source point is the reverse winner of 16 target points on
    average, so its gradient is a long sum); `scatter_rows` on the card
    equals index_add_ on the CPU on the same inputs; and the time of the
    fit's recon-loss backward with `scatter_rows` and with index_add_, in
    turns (new, old, old, new)."""
    from reart_tpu_torch.ops import distance

    sparse, dense = randn(9, 256, 3), randn(9, 4096, 3)
    grads = []
    for _ in range(2):
        s = sparse.clone().requires_grad_(True)
        t = dense.clone().requires_grad_(True)
        distance.chamfer_loss(s, t).backward()
        grads.append((s.grad, t.grad))
    for name, a, b in zip(("source", "target"), *grads):
        if not torch.equal(a, b):
            raise AssertionError(f"Chamfer backward: two identical calls "
                                 f"give other {name} gradients "
                                 f"({int((a != b).sum())} entries)")
    idx = torch.randint(0, 256, (9, 4096), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    idx[:, :2048] = 3  # half of each element into one row
    vals = randn(9, 4096, 3) * 10.0 ** (6 * randn(9, 4096, 1).clamp(-1, 1))
    card = distance.scatter_rows(idx, vals, 256).cpu()
    cpu = index_add_rows(idx.cpu(), vals.cpu(), 256)
    if not torch.equal(card, cpu):
        raise AssertionError("scatter_rows on the card differs from "
                             "index_add_ on the CPU")
    p = pred.clone().requires_grad_(True)
    loss = distance.chamfer_loss(p, obs)

    def backward():
        torch.autograd.grad(loss, p, retain_graph=True)

    times = {"scatter_rows": [], "index_add_": []}
    for which in ("scatter_rows", "index_add_", "index_add_", "scatter_rows"):
        orig = distance.scatter_rows
        if which == "index_add_":
            distance.scatter_rows = index_add_rows
        try:
            times[which].append(many_ms(backward))
        finally:
            distance.scatter_rows = orig
    log("Chamfer backward: two identical calls bit-equal (sparse (9, 256) "
        "vs dense (9, 4096)); scatter_rows on the card equals index_add_ on "
        "the CPU; the recon loss's backward at (9, 4096, 4096) "
        + ", ".join(f"{k} {' '.join(f'{t:.4f}' for t in v)} ms"
                    for k, v in times.items()))


def kernel_phase(dev):
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound
    from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # the edge cases draw from a generator of their own, so that the main
    # shapes' inputs (and the work they make: sweeps, picks) stay those of
    # earlier runs
    edge = torch.Generator(device=dev).manual_seed(7)

    def edge_randn(*shape):
        return torch.randn(shape, generator=edge, device=dev)

    cano, pcs, complete = sequence(dev)
    stats = {}

    # row 5: Chamfer 1-NN, predicted clouds vs observed frames
    src = pred_clouds = (pcs + 0.01 * randn(9, 4096, 3)).contiguous()
    # 100 points repeated, the target shifted by 7: exact ties straddle the
    # kernel's 128-row and 512-column tiles both ways
    rep = randn(1, 100, 3).repeat(9, 42, 1)
    cases = [("main (9, 4096, 4096)", src, pcs),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3)),
             ("ties across tiles (9, 4096, 4096)",
              rep[:, :4096].contiguous(), rep[:, 7:4103].contiguous()),
             ("past the tiles (3, 4097, 1000)", randn(3, 4097, 3),
              randn(3, 1000, 3))]
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
    chamfer_backward_check(dev, randn, src, pcs)

    # row 6: flow blend, predicted source frames vs FlowContext anchors
    query = (complete[:-1] + 0.01 * randn(9, 4096, 3)).contiguous()
    anchors = complete[:-1].contiguous()
    flows = (complete[1:] - complete[:-1]).contiguous()
    padded = anchors.clone()
    padded[:, 3000:] = 1e6  # FlowContext's FAR padding, zero flow
    pflows = flows.clone()
    pflows[:, 3000:] = 0.0
    # 64 points repeated: each query's 3 nearest are copies 64 apart, in
    # different slices of the kernel
    tied = randn(1, 64, 3).repeat(9, 64, 1).contiguous()
    cases = [("main (9, 4096, 4096)", query, anchors, flows),
             ("FAR-padded (9, 4096, 4096)", query, padded, pflows),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3),
              0.05 * randn(2, 1500, 3)),
             ("ties across slices (9, 4096, 4096)", query, tied,
              0.05 * randn(9, 4096, 3)),
             ("M past the slices (9, 4096, 4093)", query,
              anchors[:, :4093].contiguous(), flows[:, :4093].contiguous()),
             ("M = 3 (2, 257, 3)", randn(2, 257, 3), randn(2, 3, 3),
              0.05 * randn(2, 3, 3))]
    err = 0.0
    for label, q, r, f in cases:
        slices = cuda_nn.blend3_slices(q.shape[0], q.shape[1], r.shape[1],
                                       torch.cuda.get_device_properties(
                                           dev).multi_processor_count)
        got = cuda_nn.blend3(q, r, f)
        ref = cuda_nn.blend3_plain(q, r, f)
        err = max(err, check(f"blend3 {label}", got, ref, exact=set()))
        mask_k = (got[1] <= got[2]) | (got[1] <= 0.05)
        mask_p = (ref[1] <= ref[2]) | (ref[1] <= 0.05)
        if not torch.equal(mask_k, mask_p):
            raise AssertionError(f"blend3 {label}: validity mask differs")
        log(f"blend3 {label}, {slices} slices: mask exact, floats within "
            f"{FLOAT_TOL}")
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
    # the kernel's layout: points a thread holds in registers (256 threads
    # up to 2048 points, 512 past, 1024 with the coordinates in shared
    # memory past 8192), so N at and past each boundary
    cases += [(f"N = {n} (2, {n}) -> 300", edge_randn(2, n, 3),
               torch.ones((2, n), dtype=torch.bool, device=dev), 300)
              for n in (1023, 1024, 1025, 2048, 2049, 4097, 8192, 8193,
                        cuda_fps.MAX_POINTS)]
    one = torch.zeros((3, 1500), dtype=torch.bool, device=dev)
    one[0, 1400] = one[1, 0] = one[2, 777] = True
    few = torch.zeros((2, 1025), dtype=torch.bool, device=dev)
    few[:, 1000:1010] = True
    cases += [("every point equal (2, 1025) -> 40",
               torch.ones((2, 1025, 3), device=dev),
               torch.ones((2, 1025), dtype=torch.bool, device=dev), 40),
              ("one masked point (3, 1500) -> 20", edge_randn(3, 1500, 3),
               one, 20),
              ("npoint past the masked count (2, 1025) -> 30",
               edge_randn(2, 1025, 3), few, 30),
              ("nothing masked (2, 1025) -> 5", edge_randn(2, 1025, 3),
               torch.zeros((2, 1025), dtype=torch.bool, device=dev), 5)]
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
    def lap(b, n, m, draw=edge_randn):
        return (-torch.sqrt(pairwise_sqdist(draw(b, n, 3), draw(b, m, 3)))
                ).contiguous()

    def zeros(b, m):
        return torch.zeros((b, m), device=dev)

    ties = (1.0, 0.1, 0.01)  # integer costs: whole-number bids
    cases = [("cold (9, 1024, 1024)", benefit, zero, eps, 100),
             ("warm (9, 1024, 1024)", benefit2, warm_price, eps, 100),
             ("ragged cold (2, 300, 500)", lap(2, 300, 500, randn),
              zeros(2, 500), eps, 100),
             # the cluster kernel's edge cases: rows left at the bound, one
             # row, N < M, M that splits over no count of blocks or lanes,
             # ties across columns and rows, one slot buffer (two do not fit
             # the shared memory), 20 elements (160 blocks, past 132 SMs)
             ("sweep bound 3 (9, 1024, 1024)", benefit, zero, eps, 3),
             ("N = 1 (3, 1, 7)", lap(3, 1, 7), zeros(3, 7), eps, 100),
             ("N < M (2, 100, 1000)", lap(2, 100, 1000), zeros(2, 1000), eps,
              100),
             ("M % 8 != 0 (2, 500, 1001)", lap(2, 500, 1001), zeros(2, 1001),
              eps, 100),
             ("integer costs, ties (2, 128, 160)",
              -torch.randint(0, 4, (2, 128, 160), generator=edge,
                             device=dev).float(), zeros(2, 160), ties, 200),
             ("one slot buffer (1, 72, 14450)", lap(1, 72, 14450),
              zeros(1, 14450), eps, 100),
             ("(20, 1024, 1024)", lap(20, 1024, 1024), zeros(20, 1024), eps,
              100)]
    err = 0.0
    for label, bm, p, e, sweeps in cases:
        got = cuda_auction.auction_solve_resident(bm, p, e, sweeps)
        torch.cuda.synchronize()
        ref = cuda_auction.auction_solve_resident_plain(bm, p, e, sweeps)
        err = max(err, check(f"auction {label}", got, ref, exact={0, 1}))
        unassigned = int((got[0] < 0).sum())
        if "bound" in label and unassigned == 0:
            raise AssertionError(f"auction {label}: no row was left at the "
                                 f"sweep bound")
        log(f"auction {label}: row_to_col and prices exact ({unassigned} "
            f"rows left at the sweep bound)")
    # the work depends on the data (how many rows bid, for how many
    # sweeps); what any solve of these inputs needs is one reading of the
    # benefit matrix per epsilon phase, a subtraction and a comparison each
    out = cuda_auction.auction_solve_resident(benefit2, warm_price, eps, 100)
    # a solve no longer outlasts its wrapper's host time, so its time is a
    # replayed graph's (device time); back to back and one call beside it
    stats["auction_solve_resident"] = dict(
        shape="(9, 1024, 1024), warm", max_abs_err=err,
        ms=graph_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 20),
        ms_host=many_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 10, 5),
        ms_single=median_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 10),
        plain_ms=median_ms(lambda: cuda_auction.auction_solve_resident_plain(
            benefit2, warm_price, eps, 100), 3),
        **bound(2 * len(eps) * benefit2.numel(),
                (benefit2, warm_price, *out)))
    stats["auction_solve_resident"]["ms_cold"] = graph_ms(
        lambda: cuda_auction.auction_solve_resident(benefit, zero, eps, 100),
        20)
    stats["auction_solve_resident"]["ms_cold_single"] = median_ms(
        lambda: cuda_auction.auction_solve_resident(benefit, zero, eps, 100),
        10)
    # the yardstick: the streamed kernel (a cluster of 8 blocks an element,
    # its state in global memory) on the same inputs, past its size gate
    for label, bm, p in (("", benefit2, warm_price), ("_cold", benefit, zero)):
        hbm = cuda_auction._launch_resident_hbm(bm, p, eps, 100)
        check(f"auction_hbm at (9, 1024, 1024){label}", hbm,
              cuda_auction.auction_solve_resident_plain(bm, p, eps, 100),
              exact={0, 1})
        stats["auction_solve_resident"][f"ms_hbm_kernel{label}"] = graph_ms(
            lambda: cuda_auction._launch_resident_hbm(bm, p, eps, 100), 20)
    # what the solve's time is made of: sweeps and bidding rows per phase,
    # counted by the plain version (the same auction, row_to_col equal)
    for label, bm, p, _, _ in cases[:2]:
        counts = cuda_auction.auction_solve_resident_plain(
            bm, p, eps, 100, return_stats=True)[2]
        log(f"auction {label}: sweeps per phase "
            f"{counts[..., 0].T.tolist()}, bidding rows per phase "
            f"{counts[..., 1].T.tolist()}")
    new_kernel_phase(dev, gen, pred_clouds, pcs, stats)
    sweep_kernel_phase(dev, gen, pred_clouds, pcs, stats)
    streamed_kernel_phase(dev, gen, stats)
    ball_query_phase(dev, gen, stats)
    batch_norm_phase(dev, gen, stats)
    with tempfile.TemporaryDirectory() as tmp:
        banded_kernel_phase(dev, tmp, stats)
    cluster_config_phase()
    for name, s in stats.items():
        log(f"timing {name} {s['shape']}: kernel {s['ms']:.4f} ms, plain "
            f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.5f} ms by "
            f"{s['bound_by']} "
            + " ".join(f"{k} {v:.4f}" for k, v in s.items()
                       if k.startswith("ms_")))
    return stats


def new_kernel_phase(dev, gen, src, pcs, stats):
    """nn_topk, nn1_coords and nn_bidir against their plain versions."""
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound
    from reart_tpu_torch.ops import _build, cuda_nn

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
              ("k=1 (37, 3) vs (4059, 3)", pcs[0, :37], pcs[0, 37:], 1),
              # IK's label transfer: the ~6 sparse points of the kinematic
              # model against the 4096-point canonical cloud, every AMSGrad
              # step of a retargeting
              ("k=1 IK (6, 3) vs (4096, 3)", src[0, :6], pcs[0], 1)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        err = max(err, check(f"nn_topk {label}", got, ref, exact={0, 1}))
        plan = cuda_nn.nn_topk_plan(qf.shape[0] // ref_div,
                                    qf.shape[1] * ref_div, rf.shape[1], k,
                                    sms)
        log(f"nn_topk {label}: indices and distances exact (queries a "
            f"thread, slices: {plan})")
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
                         exact={0, 1}))
    log("nn_topk k=1 (9, 20, 4096, 3) vs broadcast (9, 1, 4096, 3): "
        "indices and distances exact (queries a thread, slices: "
        f"{cuda_nn.nn_topk_plan(9, 20 * 4096, 4096, 1, sms)})")
    cano, ik = pcs[0], src[0, :6]
    stats["nn_topk"] = dict(
        shape="k=1 (9, 20, 4096, 3) vs (9, 1, 4096, 3)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.nn_topk(big, frames, 1), 3, 5),
        plain_ms=median_ms(
            lambda: cuda_nn.nn_topk_plain(bigf, framesf, 1, ref_div), 2),
        # the other shapes of the paths, on the device (a replayed graph:
        # the shorter calls are paced by the wrapper back to back) and a
        # call back to back
        ms_k1_9=graph_ms(lambda: cuda_nn.nn_topk(src, pcs, 1), 20),
        ms_host_k1_9=many_ms(lambda: cuda_nn.nn_topk(src, pcs, 1)),
        ms_k3_9=graph_ms(lambda: cuda_nn.nn_topk(src, pcs, 3), 20),
        ms_host_k3_9=many_ms(lambda: cuda_nn.nn_topk(src, pcs, 3)),
        ms_k8_1=graph_ms(lambda: cuda_nn.nn_topk(cano, cano, 8), 20),
        ms_host_k8_1=many_ms(lambda: cuda_nn.nn_topk(cano, cano, 8)),
        ms_ik=graph_ms(lambda: cuda_nn.nn_topk(ik, cano, 1), 100),
        ms_host_ik=many_ms(lambda: cuda_nn.nn_topk(ik, cano, 1), 50),
        **bound(PAIR_FLOPS * 180 * 4096 * 4096, (big, frames, *out)))
    st = stats["nn_topk"]
    # the instruction floor: INSTR_PER_PAIR instructions a pair at one
    # instruction a lane a clock on every SM, at the boost clock
    floor_ms = 1e3 * INSTR_PER_PAIR * 180 * 4096 * 4096 / (
        sms * 128 * BOOST_HZ)
    log(f"nn_topk at the table shape: {st['ms']:.4f} ms, "
        f"{100 * st['bound_ms'] / st['ms']:.1f}% of the {st['bound_ms']:.5f}"
        f" ms bound, {100 * floor_ms / st['ms']:.1f}% of the {floor_ms:.4f} "
        f"ms instruction floor ({INSTR_PER_PAIR} instructions a pair, "
        f"{sms} SMs x "
        f"128 lanes at {BOOST_HZ / 1e9:.2f} GHz)")
    for key, (q, r, k) in {"k1_9": (src, pcs, 1), "k3_9": (src, pcs, 3),
                           "k8_1": (cano, cano, 8),
                           "ik": (ik, cano, 1)}.items():
        d, i = cuda_nn.nn_topk(q, r, k)
        pairs = q.numel() // 3 * r.shape[-2]
        b = bound(PAIR_FLOPS * pairs, (q, r, d, i))
        log(f"nn_topk {key}: {st['ms_' + key]:.5f} ms on the device "
            f"({st['ms_host_' + key]:.5f} ms a call back to back), bound "
            f"{b['bound_ms']:.6f} ms by {b['bound_by']}")

    # row 4: 1-NN with coords. (P^2, 20, 20): the anchor pairs of the graph
    # stage's spatial cost at P = 20 parts and at the smaller P of later
    # merge steps (the packed route); clouds past 32 points beside them
    # (nn_topk's k = 1 route)
    def part_pairs(p):
        anchors = randn(p, 20, 3)
        q = anchors[:, None].expand(p, p, 20, 3).reshape(p * p, 20, 3)
        r = anchors[None].expand(p, p, 20, 3).reshape(p * p, 20, 3)
        return q.contiguous(), r.contiguous()

    pair_q, pair_r = part_pairs(20)
    # the P of the full-width runs' graph stages
    paths = {p: part_pairs(p) for p in (6, 5, 4)}
    small = randn(5, 31, 3)
    cases = [("(9, 4096, 4096)", src, pcs),
             ("(400, 20, 20)", pair_q, pair_r),
             *((f"({p * p}, 20, 20)", *paths[p]) for p in (6, 5, 4)),
             ("(49, 20, 20)", *part_pairs(7)),
             ("(4, 20, 20)", *part_pairs(2)),
             ("B=1 (1, 20, 20)", *part_pairs(1)),
             ("N < M (5, 3, 31)", small[:, :3], small),
             ("N > M (5, 31, 3)", small, small[:, :3].contiguous()),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3)),
             ("N > M ragged (2, 1500, 300)", randn(2, 1500, 3),
              randn(2, 300, 3)),
             ("duplicates (1, 200, 1200)", tie_q, tie_r),
             ("duplicates (3, 20, 20)", base.repeat(3, 5, 1),
              base.repeat(3, 5, 1)),
             ("all ties (2, 70, 70)", zero, zero),
             ("all ties (2, 20, 20)", zero[:, :20], zero[:, :20])]
    err = 0.0
    for label, q, r in cases:
        q, r = q.contiguous(), r.contiguous()
        err = max(err, check(f"nn1_coords {label}", cuda_nn.nn1_coords(q, r),
                             cuda_nn.nn1_coords_plain(q, r),
                             exact={0, 1, 2}))
        plan = cuda_nn.nn1_coords_plan(q.shape[0], q.shape[1], r.shape[1],
                                       sms)
        log(f"nn1_coords {label}: distances, indices and coords exact "
            f"(route {plan})")
    out = cuda_nn.nn1_coords(pair_q, pair_r)
    lib = _build.load_library()

    def empty():  # on the current stream: a graph's capture stream too
        _build.check_launch("empty kernel", lib.reart_empty_kernel(
            torch.cuda.current_stream(dev).cuda_stream))

    stats["nn1_coords"] = dict(
        shape="(400, 20, 20)", max_abs_err=err,
        # a few hundred warps: 50 back-to-back calls never fill the queue,
        # so the kernel's time is read from a replayed graph, beside an
        # empty kernel's in the same harness (the launch floor)
        ms=graph_ms(lambda: cuda_nn.nn1_coords(pair_q, pair_r)),
        ms_launch_floor=graph_ms(empty),
        ms_host=many_ms(lambda: cuda_nn.nn1_coords(pair_q, pair_r), 50, 5),
        plain_ms=many_ms(lambda: cuda_nn.nn1_coords_plain(pair_q, pair_r),
                         10, 5),
        **{f"ms_p{p}": graph_ms(lambda p=p: cuda_nn.nn1_coords(*paths[p]))
           for p in (6, 5, 4)},
        ms_cloud_9=many_ms(lambda: cuda_nn.nn1_coords(src, pcs)),
        **bound(PAIR_FLOPS * 400 * 20 * 20, (pair_q, pair_r, *out)))
    st = stats["nn1_coords"]
    log(f"nn1_coords (400, 20, 20): {st['ms']:.5f} ms on the device, an "
        f"empty kernel {st['ms_launch_floor']:.5f} ms in the same harness")

    # row 3: bidirectional 1-NN without coords: the Chamfer metric at the
    # frame stacks of the full-width runs (robot 9, sapien 7, real 5 frames
    # of 4096 points)
    frames = {t: (pcs[:1].repeat(t, 1, 1) + 0.01 * randn(t, 4096, 3),
                  pcs[:1].repeat(t, 1, 1) + 0.01 * randn(t, 4096, 3))
              for t in (7, 5)}
    cases = [("(9, 4096, 4096)", src, pcs),
             *((f"({t}, 4096, 4096)", *frames[t]) for t in (7, 5)),
             ("B=1 (1, 4096, 4096)", src[:1], pcs[:1]),
             ("ragged (2, 300, 1500)", randn(2, 300, 3), randn(2, 1500, 3)),
             ("N > M ragged (2, 1500, 300)", randn(2, 1500, 3),
              randn(2, 300, 3)),
             ("no tile multiple (3, 97, 211)", randn(3, 97, 3),
              randn(3, 211, 3)),
             ("(400, 20, 20)", pair_q, pair_r),
             ("duplicates (1, 200, 1200)", tie_q, tie_r),
             ("all ties (2, 70, 70)", zero, zero)]
    err = 0.0
    for label, a, b in cases:
        a, b = a.contiguous(), b.contiguous()
        err = max(err, check(f"nn_bidir {label}", cuda_nn.nn_bidir(a, b),
                             cuda_nn.nn_bidir_plain(a, b),
                             exact={0, 1, 2, 3}))
        plan = cuda_nn.nn_bidir_plan(a.shape[0], a.shape[1], b.shape[1], sms)
        log(f"nn_bidir {label}: distances and indices exact (warps, run, "
            f"blocks: {plan})")
    out = cuda_nn.nn_bidir(src, pcs)
    stats["nn_bidir"] = dict(
        shape="(9, 4096, 4096)", max_abs_err=err,
        ms=many_ms(lambda: cuda_nn.nn_bidir(src, pcs)),
        ms_device=graph_ms(lambda: cuda_nn.nn_bidir(src, pcs), 20),
        plain_ms=median_ms(lambda: cuda_nn.nn_bidir_plain(src, pcs), 5),
        **{f"ms_{t}": graph_ms(lambda t=t: cuda_nn.nn_bidir(*frames[t]), 20)
           for t in (7, 5)},
        **bound(PAIR_FLOPS * 9 * 4096 * 4096, (src, pcs, *out)))
    st = stats["nn_bidir"]
    # the instruction floor: BIDIR_INSTR_PER_PAIR instructions a pair at one
    # instruction a lane a clock on every SM, at the boost clock
    floor_ms = 1e3 * BIDIR_INSTR_PER_PAIR * 9 * 4096 * 4096 / (
        sms * 128 * BOOST_HZ)
    log(f"nn_bidir (9, 4096, 4096): {st['ms']:.5f} ms ({st['ms_device']:.5f}"
        f" on the device), {100 * st['bound_ms'] / st['ms']:.1f}% of the "
        f"{st['bound_ms']:.5f} ms bound, {100 * floor_ms / st['ms']:.1f}% of "
        f"the {floor_ms:.4f} ms instruction floor ({BIDIR_INSTR_PER_PAIR} "
        f"instructions a pair); frame stacks of 7 and 5: "
        f"{st['ms_7']:.5f}, {st['ms_5']:.5f} ms on the device")


def sweep_kernel_phase(dev, gen, src, pcs, stats):
    """row_top2 and col_winner_max against their plain versions, and the
    sweep route of auction_lap against the same loop over plain versions."""
    from reart_tpu_torch.bench_nn import bound
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
    large_kernel_phase(dev, benefit, stats)


# the energy's presolve (metrics._auction_duals): eps_min 1e-6, 4 phases,
# x30, 400 sweeps; the engine's dense LAP: eps_min 1e-4, 2 phases, x50, 100
PRESOLVE_EPS = tuple(1e-6 * 30.0 ** k for k in range(3, -1, -1))
ENGINE_EPS = (5e-3, 1e-4)


def large_kernel_phase(dev, benefit, stats):
    """auction_solve_large against its plain version (the sweep loop over
    the plain row_top2 / col_winner_max), row_to_col, prices and stats
    exact: the energy's presolve of phase 3's clouds (`benefit`) and of
    clouds whose matching has stragglers (a permutation, moved 0.05: its
    phases run into their 400-sweep tails, as the full-width runs' do), the
    engine's dense LAP at (7, 4096, 4096) cold and warm, and the edge cases;
    then auction_lap's default route against use_resident=False (the sweep
    kernels), the kernel's time beside the sweep route's and the resident
    kernel's (the same cluster sweep without the split row pass) launched
    at the same shape, and its bound (the benefit read once; operations for
    the rows the cache did not answer, counted by the kernel's probe)."""
    from reart_tpu_torch.bench_nn import bound_of
    from reart_tpu_torch.ops import assignment, cuda_auction
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    # a generator of its own: the phases after this one keep their inputs
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def benefit_of(src, tgt):
        return (-torch.sqrt(pairwise_sqdist(src, tgt))).contiguous()

    def lap(b, n, m):
        return benefit_of(randn(b, n, 3), randn(b, m, 3))

    def zeros(b, m):
        return torch.zeros((b, m), device=dev)

    solve = cuda_auction.auction_solve_large
    plain = cuda_auction.auction_solve_large_plain
    tgt = randn(9, 4096, 3)
    src = (tgt[:, torch.randperm(4096, generator=gen, device=dev)]
           + 0.05 * randn(9, 4096, 3))
    tails = benefit_of(src, tgt)
    engine = tails[:7].contiguous()
    moved = benefit_of(src[:7] + 0.002 * randn(7, 4096, 3), tgt[:7])
    warm_price = solve(engine, zeros(7, 4096), ENGINE_EPS, 100)[1]
    ties = (1.0, 0.1, 0.01)  # integer costs: whole-number bids
    cases = [
        ("presolve (9, 4096, 4096)", benefit, zeros(9, 4096), PRESOLVE_EPS,
         400),
        ("presolve with tails (9, 4096, 4096)", tails, zeros(9, 4096),
         PRESOLVE_EPS, 400),
        ("engine cold (7, 4096, 4096)", engine, zeros(7, 4096), ENGINE_EPS,
         100),
        ("engine warm (7, 4096, 4096)", moved, warm_price, ENGINE_EPS, 100),
        ("sweep bound 3 (9, 4096, 4096)", tails, zeros(9, 4096),
         PRESOLVE_EPS, 3),
        ("N < M (2, 2100, 2200)", lap(2, 2100, 2200), zeros(2, 2200),
         ENGINE_EPS, 100),
        ("M % 4 != 0 (2, 2100, 2101)", lap(2, 2100, 2101), zeros(2, 2101),
         ENGINE_EPS, 100),
        ("integer costs, ties (2, 2050, 2100)",
         -torch.randint(0, 4, (2, 2050, 2100), generator=gen,
                        device=dev).float(), zeros(2, 2100), ties, 200),
        ("B = 1 (1, 4096, 4096)", tails[:1].contiguous(), zeros(1, 4096),
         ENGINE_EPS, 100),
        # 160 blocks, past 132 SMs: the clusters run in two waves
        ("(20, 2100, 2100)", lap(20, 2100, 2100), zeros(20, 2100),
         ENGINE_EPS, 100),
        # two slot buffers do not fit the shared memory
        ("one slot buffer (1, 3000, 12000)", lap(1, 3000, 12000),
         zeros(1, 12000), ENGINE_EPS, 100)]
    err = 0.0
    counts = {}
    plain_s = {}
    for label, bm, p, e, sweeps in cases:
        b, n, m = bm.shape
        if not cuda_auction.large_available(n, m, dev):
            raise AssertionError(f"auction_large {label}: outside the large "
                                 f"kernel's window")
        got = solve(bm, p, e, sweeps, return_stats=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain(bm, p, e, sweeps, return_stats=True)
        torch.cuda.synchronize()
        plain_s[label] = time.perf_counter() - t0
        err = max(err, check(f"auction_large {label}", got, ref,
                             exact={0, 1, 2}))
        left = int((got[0] < 0).sum())
        if "bound" in label and left == 0:
            raise AssertionError(f"auction_large {label}: no row was left at "
                                 f"the sweep bound")
        counts[label] = got[2]
        log(f"auction_large {label}: row_to_col, prices and stats exact "
            f"({left} rows left at the sweep bound; plain "
            f"{plain_s[label]:.2f} s); sweeps per phase "
            f"{got[2][..., 0].T.tolist()}, bidding rows per phase "
            f"{got[2][..., 1].T.tolist()}")

    # the route as a whole: auction_lap's default (one launch) against
    # use_resident=False (sweep by sweep through row_top2, col_winner_max)
    presolve_kw = dict(eps_min=1e-6, num_scales=4, scale_factor=30.0,
                       max_sweeps=400)
    engine_kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0,
                     max_sweeps=100)
    route = [("presolve with tails (9, 4096, 4096)", tails, presolve_kw),
             ("engine cold (7, 4096, 4096)", engine, engine_kw)]
    for label, bm, kw in route:
        before = cuda_auction.auction_solve_large.launches
        r_k, p_k = assignment.auction_lap(-bm, return_price=True, **kw)
        if cuda_auction.auction_solve_large.launches != before + 1:
            raise AssertionError(f"auction_lap {label}: the default route did "
                                 f"not launch auction_solve_large once")
        r_s, p_s = assignment.auction_lap(-bm, return_price=True,
                                          use_resident=False, **kw)
        diff = float((p_k.double() - p_s.double()).abs().max())
        check(f"auction_lap one launch vs sweep route {label}", (r_k, p_k),
              (r_s, p_s), exact={0, 1})
        log(f"auction_lap {label}: one launch equals the sweep route "
            f"(use_resident=False): row_to_col equal, prices bit-equal "
            f"(largest difference {diff})")

    # time and bound at the presolve with tails (the full-width runs'
    # presolve runs its phases into their 400-sweep tails)
    label = "presolve with tails (9, 4096, 4096)"
    z9 = zeros(9, 4096)
    st = counts[label]
    rows_bid = int(st[..., 1].sum())
    probe = torch.zeros((9, 2), dtype=torch.int32, device=dev)
    out = cuda_auction._launch_large(tails, z9, PRESOLVE_EPS, 400, True,
                                     probe)
    hits, rows_read = probe.sum(0).tolist()
    # each input read once (the benefit, the prices), each output written
    # once; the operations this run's data needs, a subtraction and a
    # comparison for each entry of the rows read (the probe's count)
    nbytes = sum(t.numel() * t.element_size() for t in (tails, z9, *out))
    stats["auction_solve_large"] = dict(
        shape="(9, 4096, 4096), presolve with tails, cold",
        max_abs_err=err,
        ms=median_ms(lambda: solve(tails, z9, PRESOLVE_EPS, 400), 5),
        plain_ms=1e3 * plain_s[label],
        ms_phase3_presolve=median_ms(
            lambda: solve(benefit, z9, PRESOLVE_EPS, 400), 5),
        ms_engine_cold=median_ms(
            lambda: solve(engine, zeros(7, 4096), ENGINE_EPS, 100), 5),
        ms_engine_warm=median_ms(
            lambda: solve(moved, warm_price, ENGINE_EPS, 100), 5),
        ms_resident_kernel=median_ms(lambda: cuda_auction._launch_resident(
            tails, z9, PRESOLVE_EPS, 400), 5),
        ms_resident_kernel_engine_warm=median_ms(
            lambda: cuda_auction._launch_resident(moved, warm_price,
                                                  ENGINE_EPS, 100), 5),
        ms_sweep_route=median_ms(lambda: assignment.auction_lap(
            -tails, use_resident=False, **presolve_kw), 1),
        ms_sweep_route_engine_warm=median_ms(lambda: assignment.auction_lap(
            -moved, price=warm_price, use_resident=False, **engine_kw), 2),
        rows_read=rows_read,
        **bound_of(2 * rows_read * 4096, nbytes))
    s2 = stats["auction_solve_large"]
    for lbl in (label, "engine warm (7, 4096, 4096)"):
        c = counts[lbl]
        log(f"auction_large {lbl}: longest phases (sweeps) "
            f"{c[..., 0].max(0).values.tolist()}, bidding rows per phase "
            f"(all elements) {c[..., 1].sum(0).tolist()}")
    log(f"auction_large {label}: {s2['ms']:.4f} ms, the sweep route "
        f"{s2['ms_sweep_route']:.1f} ms, the resident kernel "
        f"{s2['ms_resident_kernel']:.4f} ms; bound {s2['bound_ms']:.5f} ms by "
        f"{s2['bound_by']} (the benefit read once, {nbytes / 1e9:.3f} GB; "
        f"{rows_bid} bids, {hits} answered by the cache, {rows_read} rows "
        f"read), {100 * s2['bound_ms'] / s2['ms']:.1f}% of it")


def cluster_config_phase():
    """The size gates of the cluster kernels (cuda_auction.cluster_plan,
    which mirrors the shared-memory layout of csrc/auction_cluster.cuh)
    against what the library takes (cluster_config) at every size of a scan
    across the gates' edges; prints each change of configuration with the
    size before it."""
    from reart_tpu_torch.ops import cuda_auction

    big = cuda_auction.RESIDENT_HBM_MAX_ELEMS
    scans = [("resident_hbm", n, range(n, min(16000, big // n) + 1), 0)
             for n in (80, 1100, 2048)]
    scans += [("large", n, range(max(n, big // n + 1), 16001), 0)
              for n in (2100, 3000, 4096)]
    scans += [("banded", 1024, [1024], 128)]
    scans += [("banded", None, range(2048, 12289, 256), 256)]
    table = {}
    for kernel, n0, ms, tile in scans:
        prev = None
        for m in ms:
            key = (kernel, m if n0 is None else n0, m, tile)
            plan = cuda_auction.cluster_plan(*key)
            cfg = cuda_auction.cluster_config(*key)
            if cfg != plan:
                raise AssertionError(f"cluster_plan {key}: {plan}, the "
                                     f"library {cfg}")
            if prev is None or cfg[:2] != prev[1][:2]:
                if prev is not None:
                    table[prev[0]] = prev[1]
                table[key] = cfg
            prev = (key, cfg)
        table[prev[0]] = prev[1]
    log(f"cluster_plan equals the library at every size scanned; (kernel, N, "
        f"M, tile) -> (slot buffers, option, bytes) at each change and at "
        f"the scans' ends: {list(table.items())}")


def streamed_kernel_phase(dev, gen, stats):
    """auction_solve_resident_hbm against its plain version, row_to_col,
    prices and stats exact, and against the sweep route, at the projection
    fit's LAP: (9, 2048, 2048) euclidean costs of two clouds, cold (zero
    prices) and warm (the prices of the previous solve, the source cloud
    moved a little); and the window's edges: M % 4 != 0, B = 1, more
    elements than fit the card at once, the window's lower edge, the
    largest M whose cluster state fits at small N and one past it (there
    auction_lap sweeps). Each case prints its slowest element's sweeps per
    phase and the bids the candidate cache answered against the rows read.
    Times: warm and cold, the first sweeps alone (max_sweeps 1, with the
    rows they read and the rate) and the rest per tail sweep of the slowest
    element; the bound, the benefit read once; the large kernel, which
    runs the same cluster sweep past 2048^2, is held to the plain version
    on the same inputs."""
    from reart_tpu_torch.bench_nn import bound_of
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

    def zeros(b, m):
        return torch.zeros((b, m), device=dev)

    eps = (5e-3, 1e-4)  # the fit's schedule: eps_min 1e-4, 2 scales, x50
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0)
    solve = cuda_auction.auction_solve_resident_hbm
    plain = cuda_auction.auction_solve_resident_hbm_plain
    src, tgt = clouds(9, 2048, 2048)
    benefit = benefit_of(src, tgt)
    benefit2 = benefit_of(src + 0.002 * randn(9, 2048, 3), tgt)
    zero = zeros(9, 2048)
    warm_price = solve(benefit, zero, eps, 100)[1].contiguous()
    src_r, tgt_r = clouds(2, 1024, 2048)
    ties = -torch.randint(0, 3, (2, 1100, 1200), generator=gen,
                          device=dev).float()
    # the largest M whose state fits the streamed kernel at N = 80
    m_edge = max(m for m in range(13000, 16000)
                 if cuda_auction.resident_hbm_available(80, m))
    cases = [("cold (9, 2048, 2048)", benefit, zero, 100),
             ("warm (9, 2048, 2048)", benefit2, warm_price, 100),
             ("non-square cold (2, 1024, 2048)", benefit_of(src_r, tgt_r),
              zeros(2, 2048), 100),
             ("sweep bound 3 (9, 2048, 2048)", benefit, zero, 3),
             ("ties (2, 1100, 1200)", ties, zeros(2, 1200), 100),
             ("M % 4 != 0 (2, 1100, 1203)", benefit_of(*clouds(2, 1100, 1203)),
              zeros(2, 1203), 100),
             ("B = 1 (1, 2048, 2048)", benefit2[:1].contiguous(),
              warm_price[:1].contiguous(), 100),
             # 160 blocks, past 132 SMs: the clusters run in two waves
             ("(20, 1100, 1100)", benefit_of(*clouds(20, 1100, 1100)),
              zeros(20, 1100), 100),
             ("the window's lower edge (1, 1025, 1025)",
              benefit_of(*clouds(1, 1025, 1025)), zeros(1, 1025), 100),
             (f"the largest M that fits (1, 80, {m_edge})",
              benefit_of(*clouds(1, 80, m_edge)), zeros(1, m_edge), 100)]
    err = 0.0
    counts = {}
    probes = {}
    for label, bm, p, sweeps in cases:
        b, n, m = bm.shape
        if not cuda_auction.resident_hbm_available(n, m):
            raise AssertionError(f"auction_hbm {label}: outside the streamed "
                                 f"window")
        probe = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        got = cuda_auction._launch_resident_hbm(bm, p, eps, sweeps, True,
                                                probe)
        torch.cuda.synchronize()
        ref = plain(bm, p, eps, sweeps, return_stats=True)
        err = max(err, check(f"auction_hbm {label}", got, ref,
                             exact={0, 1, 2}))
        left = int((got[0] < 0).sum())
        if "bound" in label and left == 0:
            raise AssertionError(f"auction_hbm {label}: no row was left at "
                                 f"the sweep bound")
        counts[label] = got[2]
        probes[label] = probe.sum(0).tolist()
        nbuf, cache_k, smem = cuda_auction.cluster_config("resident_hbm", n, m)
        log(f"auction_hbm {label} ({nbuf} slot buffers, {cache_k} columns "
            f"cached a row, {smem} bytes of shared memory): row_to_col, prices "
            f"and stats exact ({left} "
            f"rows left at the bound); the slowest element's sweeps per phase "
            f"{got[2][..., 0].max(0).values.tolist()}, bidding rows per "
            f"phase (all elements) {got[2][..., 1].sum(0).tolist()}; bids "
            f"the cache answered {probes[label][0]}, rows read "
            f"{probes[label][1]}")
        # the sweep route on the same inputs: the same matching and prices
        r_k, p_k = assignment.auction_lap(-bm, price=p, return_price=True,
                                          max_sweeps=sweeps, **kw)
        r_s, p_s = assignment.auction_lap(-bm, price=p, return_price=True,
                                          max_sweeps=sweeps,
                                          use_resident=False, **kw)
        check(f"auction_lap one launch vs sweep route {label}", (r_k, p_k),
              (r_s, p_s), exact={0, 1})
    log(f"auction_lap: the one-launch route equals the sweep route "
        f"(use_resident=False) at all {len(cases)} cases")
    # one column past the edge: the state no longer fits, auction_lap
    # sweeps (row_top2, col_winner_max) and equals use_resident=False
    past = benefit_of(*clouds(1, 80, m_edge + 1))
    if cuda_auction.resident_hbm_available(80, m_edge + 1):
        raise AssertionError(f"auction_hbm: (80, {m_edge + 1}) is inside the "
                             f"streamed window")
    before = (solve.launches, cuda_auction.row_top2.launches)
    r_k, p_k = assignment.auction_lap(-past, return_price=True,
                                      max_sweeps=100, **kw)
    if (solve.launches != before[0]
            or cuda_auction.row_top2.launches == before[1]):
        raise AssertionError(f"auction_lap (1, 80, {m_edge + 1}): did not "
                             f"take the sweep route")
    check(f"auction_lap (1, 80, {m_edge + 1}) vs use_resident=False",
          (r_k, p_k), assignment.auction_lap(-past, return_price=True,
                                             max_sweeps=100,
                                             use_resident=False, **kw),
          exact={0, 1})
    log(f"auction_lap (1, 80, {m_edge + 1}), one column past the streamed "
        f"kernel's state: the sweep route, equal to use_resident=False")

    # the bound: each input read once (the benefit, the prices), each output
    # written once; the operations this run's data needs, a subtraction and
    # a comparison for each entry of the rows read (the probe's count: the
    # bids the cache answers read none)
    warm = counts["warm (9, 2048, 2048)"]
    cold = counts["cold (9, 2048, 2048)"]
    rows_bid = int(warm[..., 1].sum())
    rows_read = probes["warm (9, 2048, 2048)"][1]
    out = solve(benefit2, warm_price, eps, 100, return_stats=True)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (benefit2, warm_price, *out))
    # the rows the first sweeps read (max_sweeps 1; the second phase's
    # first sweep is partly answered by the first phase's caches)
    first_read = {}
    for sfx, bm, p in (("", benefit2, warm_price), ("_cold", benefit, zero)):
        probe = torch.zeros((9, 2), dtype=torch.int32, device=dev)
        cuda_auction._launch_resident_hbm(bm, p, eps, 1, probe=probe)
        first_read[sfx] = int(probe[:, 1].sum())
    st = dict(
        shape="(9, 2048, 2048), warm", max_abs_err=err,
        ms=many_ms(lambda: solve(benefit2, warm_price, eps, 100), 10, 5),
        plain_ms=median_ms(lambda: plain(benefit2, warm_price, eps, 100), 3),
        ms_cold=many_ms(lambda: solve(benefit, zero, eps, 100), 10, 5),
        ms_first_sweeps=many_ms(lambda: solve(benefit2, warm_price, eps, 1),
                                10, 5),
        ms_first_sweeps_cold=many_ms(lambda: solve(benefit, zero, eps, 1),
                                     10, 5),
        ms_sweep_route=median_ms(lambda: assignment.auction_lap(
            -benefit2, price=warm_price, max_sweeps=100, use_resident=False,
            **kw), 3),
        ms_sweep_route_cold=median_ms(lambda: assignment.auction_lap(
            -benefit, max_sweeps=100, use_resident=False, **kw), 3),
        rows_read=rows_read,
        **bound_of(2 * rows_read * 2048, nbytes))
    for sfx, rows in first_read.items():
        st[f"gbs_first_sweeps{sfx}"] = (
            rows * 2048 * 4 / (st["ms_first_sweeps" + sfx] * 1e6))
    # the per-sweep split: the sweeps after each phase's first, of the
    # slowest element (the launch lasts as long as it does)
    for sfx, c in (("", warm), ("_cold", cold)):
        tail = int(c[..., 0].max(0).values.sum()) - len(eps)
        st[f"ms_per_tail_sweep{sfx}"] = (
            (st["ms" + sfx] - st["ms_first_sweeps" + sfx]) / max(tail, 1))
    # the large kernel (the same cluster sweep, past its size gate) on the
    # same inputs
    for label, bm, p in (("", benefit2, warm_price), ("_cold", benefit, zero)):
        check(f"auction_large at (9, 2048, 2048){label}",
              cuda_auction._launch_large(bm, p, eps, 100, return_stats=True),
              plain(bm, p, eps, 100, return_stats=True), exact={0, 1, 2})
    stats["auction_solve_resident_hbm"] = st
    log("auction_large at (9, 2048, 2048), cold and warm: row_to_col, "
        "prices and stats exact")
    log(f"auction_hbm (9, 2048, 2048): warm {st['ms']:.4f} ms (first sweeps "
        f"{st['ms_first_sweeps']:.4f}: {first_read['']} rows read, "
        f"{first_read[''] * 2048 * 4 / 1e6:.1f} MB at "
        f"{st['gbs_first_sweeps']:.0f} GB/s; then "
        f"{st['ms_per_tail_sweep'] * 1e3:.2f}"
        f" us a tail sweep of the slowest element's "
        f"{int(warm[..., 0].max(0).values.sum()) - len(eps)}), cold "
        f"{st['ms_cold']:.4f} ms (first sweeps {st['ms_first_sweeps_cold']:.4f}"
        f": {first_read['_cold']} rows read, "
        f"{first_read['_cold'] * 2048 * 4 / 1e6:.1f} MB at "
        f"{st['gbs_first_sweeps_cold']:.0f} GB/s; then "
        f"{st['ms_per_tail_sweep_cold'] * 1e3:.2f} us a tail sweep of "
        f"{int(cold[..., 0].max(0).values.sum()) - len(eps)}); warm "
        f"{rows_bid} bidding rows, {rows_read} rows read, "
        f"in {int(warm[..., 0].sum())} element-sweeps, cold "
        f"{int(cold[..., 1].sum())} in {int(cold[..., 0].sum())}; bound "
        f"{st['bound_ms']:.5f} ms by {st['bound_by']} (the benefit read "
        f"once, {nbytes / 1e6:.1f} MB; {2 * rows_read * 2048 / 1e6:.1f} M "
        f"operations), {100 * st['bound_ms'] / st['ms']:.1f}% of it")


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


# sa1.2's three layers, the largest of a corr step: (lin shape, C_in)
BN_SHAPES = (((8, 512, 128, 64), 6), ((8, 512, 128, 96), 64),
             ((8, 512, 128, 128), 96))


def batch_norm_phase(dev, gen, stats):
    """The fused batch-mode BatchNorm (ops/cuda_bn.py, row 14) at sa1.2's
    layer shapes: the Function's output, moments and the gradients of its
    four inputs equal autograd of the written-out form bit for bit; its
    forward and backward timed as replayed CUDA graphs, beside the
    written-out form (forward and autograd's backward), F.batch_norm + ReLU
    (a yardstick only: the port never calls it) and the byte bound of eight
    passes over the layer's (R, C) float32 tensor."""
    from torch.nn import functional as F

    from reart_tpu_torch.ops import cuda_bn

    def written_out(lin, bias, w, b, relu=True):
        out, _, mean, var = cuda_bn.bn_forward_plain(lin, bias, w, b, relu)
        return out, mean, var

    def library(lin, bias, w, b, relu=True):
        y = F.batch_norm((lin + bias).reshape(-1, lin.shape[-1]), None, None,
                         w, b, True, 0.0, cuda_bn.BN_EPS)
        return F.relu(y), None, None

    def fwd_bwd(fn, args, grad):
        def call():
            out = fn(*args)[0]
            return torch.autograd.grad(out, args, grad.reshape(out.shape))
        return call

    out = {}
    for shape, c_in in BN_SHAPES:
        c = shape[-1]
        x = torch.rand(shape[:-1] + (c_in,), generator=gen, device=dev)
        bound = 1.0 / math.sqrt(c_in)
        lin = F.linear(x, (2 * torch.rand((c, c_in), generator=gen,
                                          device=dev) - 1) * bound)
        del x
        bias = (2 * torch.rand(c, generator=gen, device=dev) - 1) * bound
        w = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        grad = torch.randn(shape, generator=gen, device=dev)
        args = [t.requires_grad_() for t in (lin, bias, w, b)]
        res = []
        for fn in (cuda_bn.batch_norm_relu, written_out):
            o, m, v = fn(*args)
            res.append((o, m, v) + torch.autograd.grad(o, args, grad))
        for name, got, want in zip(
                ("out", "mean", "var", "grad lin", "grad bias",
                 "grad bn_weight", "grad bn_bias"), *res):
            if not torch.equal(got, want):
                raise AssertionError(f"batch_norm {shape}: {name} differs "
                                     f"from the written-out form's")
        del res
        plain = [t.detach() for t in args]
        _, z, mean, var = cuda_bn.bn_forward(*plain, True)
        ms_fwd = graph_ms(lambda: cuda_bn.bn_forward(*plain, True),
                          launches=5)
        ms_bwd = graph_ms(lambda: cuda_bn.bn_backward(
            grad, z, mean, var, plain[2], plain[3], True), launches=5)
        del z, mean, var
        rows = lin.numel() // c
        out[shape] = dict(
            ms=ms_fwd + ms_bwd, ms_fwd=ms_fwd, ms_bwd=ms_bwd,
            plain_ms=many_ms(fwd_bwd(written_out, args, grad), 5, 3),
            library_ms=many_ms(fwd_bwd(library, args, grad), 5, 3),
            bound_ms=8 * 4 * rows * c / 3.35e12 * 1e3)
        s = out[shape]
        log(f"batch_norm {shape} from C_in {c_in}: the written-out form's "
            f"output, moments and four gradients bit for bit; forward "
            f"{ms_fwd:.4f} + backward {ms_bwd:.4f} ms (device, replayed "
            f"graphs) against the 8-pass byte bound {s['bound_ms']:.4f} "
            f"({100 * s['bound_ms'] / s['ms']:.1f}%); written-out forward "
            f"and backward {s['plain_ms']:.4f} ms, F.batch_norm + ReLU "
            f"{s['library_ms']:.4f} ms")
        del lin, bias, w, b, grad, args, plain
    main = BN_SHAPES[-1][0]
    stats["batch_norm"] = dict(
        shape=str(main), max_abs_err=0.0, bound_by="bytes",
        **{k: out[main][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms")},
        ms_forward=out[main]["ms_fwd"], ms_backward=out[main]["ms_bwd"],
        **{f"ms_{'x'.join(map(str, sh))}": out[sh]["ms"]
           for sh, _ in BN_SHAPES[:-1]})


def ball_query_phase(dev, gen, stats):
    """The three kernels of a backbone forward (fps, ball_query, nn_topk k=3)
    against their plain versions, indices exact, on the clouds the two
    correspondence paths give them: the nine source frames of the scene,
    normalised as setup_flow normalises them (SA1: 512 FPS centroids of 4096
    points; SA2: 128 of those 512); a training batch as the `corr` trainer
    makes it (4 synthetic pairs of 1024 points: 8 clouds); the held-out pair
    of its evaluation (2 clouds). Then ball_query's edge cases."""
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound
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
            if timed:
                t = time_kernel(lambda: cuda_fps.fps(x, mask, npoint), 20, 20)
                took = (f"; {t['ms']:.4f} ms on the device, "
                        f"{t['ms_host']:.4f} ms a call, back to back")
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
                                                         exact={0, 1}))
            took = ""
            if timed:
                t = time_kernel(lambda: cuda_nn.nn_topk(q, r, 3), 20, 20)
                took = (f"; {t['ms']:.4f} ms on the device, "
                        f"{t['ms_host']:.4f} ms a call, back to back")
            log(f"backbone shapes ({group}): {label}: indices and "
                f"distances exact{took}")
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
    many = torch.rand((2100, 64, 3), generator=gen, device=dev)
    cases = [("edge cases (1, 70) x (1, 4)", radius, k, xyz, new_xyz),
             ("ragged (3, 601) x (3, 97)", 0.2, 16,
              torch.rand((3, 601, 3), generator=gen, device=dev),
              torch.rand((3, 97, 3), generator=gen, device=dev)),
             ("duplicates (2, 260) x (2, 40)", 0.2, 16, dup,
              dup[:, 5:45].contiguous()),
             ("more slots than points (2, 20) x (2, 5), K=32", 10.0, 32,
              randn(2, 20, 3), randn(2, 5, 3)),
             # 2100 x 512 centroids, 16 or fewer a block: past the 65,535
             # blocks of one grid row
             ("(2100, 64) x (2100, 512)", 0.3, 8, many,
              torch.rand((2100, 512, 3), generator=gen, device=dev)),
             # past the 16384 points held whole: tiles of 4096, most
             # centroids with fewer than K hits in the whole cloud
             ("tiled (1, 20000) x (1, 64), K=128", 0.1, 128,
              torch.rand((1, 20000, 3), generator=gen, device=dev),
              torch.rand((1, 64, 3), generator=gen, device=dev))]
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


def toy_robot_phase(dev, tmp, arts):
    """A 3-part toy robot (a base and two hinged arms, 4 frames, 360
    points) through the whole relaxation run, 600 iterations with GT flow:
    on the card at the healthy bar, and equal to the same run on the CPU
    from the same parameters and Gumbel draws within RUN_TOL. Each run's
    directory goes to phase D (`arts`)."""
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
        gif_s = arts.input_gif(sample, save_dir)
        cli.run_sample(args, "robot", sample, save_dir, device=where,
                       noise=noise)
        arts.add(f"toy robot ({torch.device(where).type})", save_dir,
                 sample, input_gif_s=gif_s)
        runs[str(where)] = read_result_txt(os.path.join(save_dir,
                                                        "result.txt"))
    arts.pair("toy robot", os.path.join(tmp, "toy_cuda"),
              os.path.join(tmp, "toy_cpu"), exact=False)
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


def finalize_phase(dev, tmp, arts):
    """Everything after the fit (seg refine, graph stage, metrics, TED,
    energy with its presolve on the card) from fixed labels and poses, on
    the card against the CPU: the six-part table at T=5, N=2048 (2048^2 is
    past the presolve's threshold), its GT parts scattered over 12 pose
    columns with one part split in two, 150 points on a wrong part and
    every pose a little off. Labels, tree and TED must be equal, every
    other number of result.txt within FINALIZE_RTOL; the artifacts go to
    phase D, the html byte-equal."""
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
        arts.add(f"finalize ({torch.device(where).type})", save_dir, sample)
        runs[str(where)] = (res, checkpoint.load_result(
            os.path.join(save_dir, "result.pkl")))
    arts.pair("finalize", os.path.join(tmp, "finalize_cuda"),
              os.path.join(tmp, "finalize_cpu"), exact=True)
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


def kinematic_check_phase(dev, tmp, arts):
    """The projection stage of the toy robot (all joints revolute) from a
    result.pkl of GT labels, GT poses a little off and the GT tree:
    build_kinematic_from_result, a 30-iteration fit_kinematic with a LAP
    per iteration, finalize with inverse kinematics; through the command
    line's run_sample on the card and on the CPU. Tree, labels, seg_ri and
    TED must be equal, the rest within KINEMATIC_RUN_TOL. Then the CPU
    run's model.ckpt.pkl is scored on both without a fit (--resume
    --evaluate), within KINEMATIC_TOL. The four directories go to phase D,
    each pair's html byte-equal."""
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
    novel = len(sample["novel_pose_list"])
    runs = {}
    for where in ("cpu", dev):
        save_dir = os.path.join(tmp, f"kin_{torch.device(where).type}")
        gif_s = arts.input_gif(sample, save_dir)
        res = cli.run_sample(args, "robot", sample, save_dir, device=where)
        arts.add(f"toy projection ({torch.device(where).type})", save_dir,
                 sample, input_gif_s=gif_s, novel=novel)
        runs[str(where)] = (res, checkpoint.load_result(
            os.path.join(save_dir, "result.pkl")))
    arts.pair("toy projection", os.path.join(tmp, "kin_cuda"),
              os.path.join(tmp, "kin_cpu"), exact=True)
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
        gif_s = arts.input_gif(sample, save_dir)
        scores[str(where)] = cli.run_sample(args, "robot", sample, save_dir,
                                            device=where)
        # result.txt and the artifacts; no result.pkl, no checkpoint
        arts.add(f"toy projection, --evaluate "
                 f"({torch.device(where).type})", save_dir, sample,
                 input_gif_s=gif_s, novel=novel, evaluate=True)
    arts.pair("toy projection, --evaluate",
              os.path.join(tmp, "kin_eval_cuda"),
              os.path.join(tmp, "kin_eval_cpu"), exact=True)
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
    from reart_tpu_torch.ops import cuda_auction, cuda_bn, cuda_fps, cuda_nn

    return (cuda_nn.nn1_bidir_coords, cuda_nn.blend3, cuda_fps.fps,
            cuda_auction.auction_solve_resident, cuda_nn.nn_topk,
            cuda_nn.nn1_coords, cuda_nn.nn_bidir, cuda_auction.row_top2,
            cuda_auction.col_winner_max,
            cuda_auction.auction_solve_resident_hbm, cuda_nn.ball_query,
            cuda_auction.auction_solve_banded,
            cuda_auction.auction_solve_large, cuda_bn.bn_forward,
            cuda_bn.bn_backward)


def launch_counts():
    """Each wrapper's launches, and `batch_norm`: the fused BatchNorm's
    forwards and backwards together (row 14)."""
    counts = {w.__name__: w.launches for w in kernel_wrappers()}
    counts["batch_norm"] = counts["bn_forward"] + counts["bn_backward"]
    return counts


def sweep_route_unused(what, launches, presolve_only=True):
    """Every LAP past 2048^2 of a full-width run (the energy's presolve, the
    sapien runs' dense solves) is one launch of auction_solve_large: the
    sweep kernels are not launched. A run without dense solves launches it
    once, for the presolve."""
    for name in ("row_top2", "col_winner_max"):
        if launches[name]:
            raise AssertionError(f"{what}: {launches[name]} launches of "
                                 f"{name}; the LAPs past 2048^2 take "
                                 f"auction_solve_large")
    large = launches["auction_solve_large"]
    if large < 1 or (presolve_only and large != 1):
        raise AssertionError(f"{what}: {large} launches of "
                             f"auction_solve_large")


RUN_PROTOCOL = ("--n_iter 400 --assign_iter 300 --num_parts 20 "
                "--downsample 4 --seg_refine 2")


def run_phase(dev, tmp, arts):
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
    gif_s = arts.input_gif(sample, save_dir)
    # no device is named: the entry points take the card by themselves
    results = cli.run_sample(args, "robot", sample, save_dir)
    torch.cuda.synchronize()
    launches = launch_counts()
    arts.add("run", save_dir, sample, input_gif_s=gif_s,
             viz_s=phase_report()["finalize/viz"])

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
        # ball query and the fused BatchNorm to the corr chain's, the banded
        # auction to sapien's; the sweep kernels to auction_lap(...,
        # use_resident=False) alone
        if (count <= 0) != (name in ("auction_solve_resident_hbm",
                                     "ball_query", "auction_solve_banded",
                                     "row_top2", "col_winner_max",
                                     "bn_forward", "bn_backward",
                                     "batch_norm")):
            raise AssertionError(f"kernel {name}: {count} launches in the "
                                 f"relaxation run")
    sweep_route_unused("run", launches)
    log(f"run: robot relaxation run at full width, {n_parts} parts, edges "
        f"{saved['joint_connection']}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in results.items()))
    log("run: seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"run: kernel launches {launches}")
    return launches, sample, os.path.join(save_dir, "result.pkl")


PROJECTION_ITERS = 200


def projection_run_phase(dev, tmp, sample, base_result_path, arts):
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

    gif_s = arts.input_gif(sample, save_dir)
    cli.finalize = finalize_after_reading_counts
    try:
        # no device is named: the entry points take the card by themselves
        results = cli.run_sample(args, "robot", sample, save_dir)
    finally:
        cli.finalize = finalize
    torch.cuda.synchronize()
    launches = launch_counts()
    arts.add("projection run", save_dir, sample, input_gif_s=gif_s,
             viz_s=phase_report()["finalize/viz"],
             novel=len(sample["novel_pose_list"]))

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
                 "auction_solve_large"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"projection run")
    sweep_route_unused("projection run", launches)
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
    # each training step's 25 BatchNorms fused, forward and backward; the
    # evaluation's forwards are in running mode, written out
    if launches["batch_norm"] != 50 * CORR_STEPS:
        raise AssertionError(f"corr: {launches['batch_norm']} fused "
                             f"BatchNorm calls, expected 50 a step")
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
    corr_determinism_phase(dev, tmp, seq_dir, norm_file)
    corr_default_radii_phase(tmp, seq_dir, norm_file)
    return launches, seq_dir, norm_file, corr_path


def autograd_index_points(points, idx):
    """index_points as it was before its backward had a fixed order:
    advanced indexing, whose backward is an accumulating index_put_ (float
    atomics in arrival order on the card). Timed beside the new order."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    out = points[rows, idx.reshape(points.shape[0], -1)]
    return out.reshape(idx.shape + points.shape[-1:])


def autograd_gather_rows(points, idx):
    """three_interpolate's gather as it was: torch.gather, whose backward is
    scatter_add_ (float atomics in arrival order on the card)."""
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def tree_differences(a, b, path=""):
    """Paths at which two nested dicts / lists of arrays differ."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [path or "/"]
        return [d for k in a for d in tree_differences(a[k], b[k],
                                                       f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_differences(x, y, f"{path}/{i}")]
    return [] if np.array_equal(np.asarray(a), np.asarray(b)) else [path]


CORR_TWIN_STEPS = 40


def corr_determinism_phase(dev, tmp, seq_dir, norm_file):
    """The backbone's training repeats on the card: a census of one training
    step (forward, loss, backward, Adam, BatchNorm statistics) under
    use_deterministic_algorithms(True, warn_only=True); two trainings of
    CORR_TWIN_STEPS steps from the same seed, generator and frames must end
    with equal weights, optimizer states, generator states and loss
    histories, bit for bit; and a training step's time with the gathers'
    fixed-order backward and with autograd's own, in turns (new, old, old,
    new)."""
    import pickle

    from reart_tpu_torch import cli
    from reart_tpu_torch.models import pointnet2
    from reart_tpu_torch.ops import interpolate, sampling
    from reart_tpu_torch.train import corr as tc

    args = cli.build_parser().parse_args(
        ["corr", "--seq_path", seq_dir, "--normalize_file", norm_file])
    frames = torch.as_tensor(cli._corr_training_frames(args)[0], device=dev)
    cfg = tc.CorrTrainConfig(batch=4, n_points=1024,
                             pos_radius=float(CORR_RADII[1]),
                             neg_radius=float(CORR_RADII[3]),
                             steps=CORR_TWIN_STEPS,
                             dispatch_chunk=CORR_TWIN_STEPS)
    model = pointnet2.PointNet2Msg2(
        device=dev, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        src, tgt, gt_pos, scale = tc.synth_pair(
            tc.draw_pairs(gen, frames.shape[0], frames.shape[1], cfg),
            frames, cfg)
        return tc._train_step(model, opt, cfg, src, tgt, gt_pos, scale)

    determinism_census("corr (one training step)", step)

    payloads = []
    for i in range(2):
        path = os.path.join(tmp, f"corr_twin_{i}.pkl")
        tc.train_corr(0, frames, cfg, checkpoint_path=path, device=dev)
        with open(path, "rb") as f:
            payloads.append(pickle.load(f))
    differ = tree_differences(*payloads)
    if differ:
        raise AssertionError(f"corr: two trainings of {CORR_TWIN_STEPS} "
                             f"steps from the same seeds differ at "
                             f"{len(differ)} entries, first {differ[:4]}")
    log(f"corr: two trainings of {CORR_TWIN_STEPS} steps from the same "
        f"seeds give the same weights ({len(payloads[0]['model'])} tensors), "
        f"optimizer state, generator state and losses bit for bit "
        f"(loss {payloads[0]['losses'][0]:.4f} -> "
        f"{payloads[0]['losses'][-1]:.4f})")

    def timed(calls=20):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / calls

    times = {"fixed order": [], "autograd's": []}
    for which in ("fixed order", "autograd's", "autograd's", "fixed order"):
        old = (pointnet2.index_points, interpolate.gather_rows)
        if which == "autograd's":
            pointnet2.index_points = autograd_index_points
            interpolate.gather_rows = autograd_gather_rows
        try:
            times[which].append(timed())
        finally:
            pointnet2.index_points, interpolate.gather_rows = old
    if (pointnet2.index_points is not sampling.index_points
            or interpolate.gather_rows is not sampling.gather_rows):
        raise AssertionError("corr: the gathers were not put back")
    log("corr: a training step (batch 4 x 1024 points, host clock over 20) "
        "with the gathers' backward in "
        + ", ".join(f"{k} {' '.join(f'{t:.2f}' for t in v)} ms"
                    for k, v in times.items()))


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

    from reart_tpu_torch import profiling

    spans = {s["name"] for s in profiling.snapshot()["spans"]}
    out = {}
    for evt in prof.key_averages():
        # the optimizer's own annotations ("Optimizer.step#Adam.step") and
        # the program's spans are device-side ranges, not kernels: they
        # repeat their kernels
        if (evt.device_type != DeviceType.CUDA
                or evt.key.startswith("Optimizer.") or evt.key in spans):
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
                            "nn_topk_kernel", "blend3_kernel", "nn1_bidir_",
                            "auction", "nn1_coords_", "nn_bidir_",
                            "row_top2_kernel", "col_winner_kernel")),
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
    sweep_route_unused("corr-flow run", launches)
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


class ProfileWindows:
    """torch.profiler windows over iterations [start, stop) of a fit, opened
    and closed from its noise(it) callback, which runs at the start of each
    iteration (in the assign phase, before the LAP of the iterations it
    starts). Each window keeps its profile and its wall-clock seconds."""

    def __init__(self, windows):
        self.windows = windows  # {label: (start, stop)}
        self.done = {}
        self.open = None

    def tick(self, it):
        from torch.profiler import ProfilerActivity, profile

        if self.open is not None and it == self.windows[self.open[0]][1]:
            label, prof, t0 = self.open
            torch.cuda.synchronize()
            prof.stop()
            self.done[label] = (prof, time.perf_counter() - t0)
            self.open = None
        for label, (start, _) in self.windows.items():
            if it == start:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                self.open = (label, prof, time.perf_counter())


def log_fit_window(what, prof, iters, wall_s):
    """A fit window's device time: busy and idle share, ms per iteration,
    the two neighbour kernels' ms per iteration, and the FPS and resident
    auction kernels' ms in the window, by kernel name."""
    by_name = device_time_by_name(prof)
    wall_ms = 1e3 * wall_s / iters
    busy_ms = sum(by_name.values()) / 1e3 / iters
    if busy_ms == 0.0:
        log(f"{what}: device time not measured (the profiler recorded no "
            f"device activity); {wall_ms:.3f} ms of wall clock an iteration")
        return

    def named(*frags):  # a demangled or a mangled name
        return sum(t for k, t in by_name.items()
                   if any(f in k for f in frags)) / 1e3 / iters

    log(f"{what}: {wall_ms:.4f} ms of wall clock and {busy_ms:.4f} ms of "
        f"device time an iteration, device busy {100 * busy_ms / wall_ms:.1f}"
        f"%, idle {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}% (under the "
        f"profiler); blend3 {named('blend3_kernel'):.4f} ms, "
        f"nn1_bidir_coords {named('nn1_bidir_'):.4f} ms (scan and decode) an "
        f"iteration; fps {iters * named('fps_kernel'):.4f} ms and the "
        f"resident auction "
        f"{iters * named('::auction_kernel', '14auction_kernel'):.4f} ms in "
        f"the "
        f"window")
    log_profile(what, prof, iters, wall_ms)


def determinism_census(what, fn):
    """Run fn() once under torch.use_deterministic_algorithms(True,
    warn_only=True), with every ATen operator recorded: the warnings name
    the operators that have no deterministic implementation; the operators
    of the scatter, gather and put families are the ones that the flag
    would otherwise swap silently. The flag is put back as it was."""
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with Census() as census:
                fn()
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
    flagged = sorted({str(w.message).split(" does not have")[0]
                      for w in caught
                      if "deterministic" in str(w.message)})
    families = ("index_add", "scatter", "index_put", "put", "gather",
                "index_select", "index", "embedding", "bincount", "histc",
                "cumsum", "segment_reduce", "sort", "searchsorted")
    suspects = sorted(n for n in census.names
                      if any(f in n for f in families))
    log(f"{what} determinism census: {len(census.names)} ATen operators; "
        f"flagged without a deterministic implementation: "
        f"{flagged or 'none'}; of the scatter, gather, index and sort "
        f"families: {suspects}")
    return flagged


def fit_phase(dev):
    """fit_base at nao scale: T=10, N=4096, P=20, flow + assign losses,
    assign_gap 5, downsample 4 (LAP 9 x 1024^2), 30 + 30 iterations. The
    fit runs twice from the same model seed, noise generator and data, and
    the two histories must be equal bit for bit; the second run takes
    torch.profiler windows over 10 recon and 10 assign iterations."""
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

    def run(marks=None, windows=None):
        gen = torch.Generator(device=dev).manual_seed(0)

        def noise(it):  # called once per iteration, in order
            if marks is not None and it in (0, cfg.assign_iter):
                torch.cuda.synchronize()
                marks[it] = time.perf_counter()
            if windows is not None:
                windows.tick(it)
            return gumbel_noise((4096, 20), gen, dev)

        _, hist = fit_base(make_model(0), cfg, cano, pcs, flow_ctx=flow_ctx,
                           noise=noise)
        torch.cuda.synchronize()
        return hist

    marks = {}
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    hist = run(marks)
    t_end = time.perf_counter()
    launches = launch_counts()

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

    # the assignment phase's start (iterations 29-30) holds the assign
    # context's two FPS calls and the first, cold, solve
    windows = ProfileWindows({"recon": (10, 20), "assign start": (29, 31),
                              "assign": (40, 50)})
    again = run(windows=windows)
    differ = [k for k in hist if not torch.equal(hist[k], again[k])]
    if differ:
        first = {k: int(torch.nonzero(hist[k] != again[k])[0])
                 for k in differ}
        raise AssertionError(f"fit: two runs from the same seeds differ in "
                             f"{differ}, first at iterations {first}")
    log(f"fit: a second run from the same seeds gives the same history bit "
        f"for bit ({', '.join(hist)})")
    for label, (prof, wall_s) in windows.done.items():
        start, stop = windows.windows[label]
        log_fit_window(f"fit: {label} window, {stop - start} iterations",
                       prof, stop - start, wall_s)
    # one recon and one assign iteration
    census_cfg = FitConfig(n_iter=2, use_assign_loss=True,
                           use_flow_loss=True, assign_iter=1, assign_gap=1,
                           downsample=4)
    determinism_census("fit (one recon and one assign iteration)",
                       lambda: fit_base(make_model(0), census_cfg, cano, pcs,
                                        flow_ctx=flow_ctx))
    return launches


def banded_kernel_phase(dev, tmp, stats):
    """auction_solve_banded against its plain version on the card, row_to_col,
    prices and per-phase stats exact: at the sapien relaxation's LAP, (7,
    4096, 4096) with w=1024, tile 256 (the full-width scene's GT clouds of
    views 1-7 a little off against the observed views, Hilbert-sorted), and
    at the robot's downsample-2 LAP, (9, 2048, 2048) with w=512 (Morton);
    cold and warm (the cold solve's prices, the source moved a little),
    carry off and on; then w=128, w=M-128, B=1, 20 elements, one shape in
    each of the cluster design's other configurations (one slot buffer
    with the target points in shared memory, (1, 6144, 6144); two with
    them in device memory, (1, 6656, 6656); one with them in device memory,
    (1, 8192, 8192), cold and warm, carry off and on) and a shape past its
    shared memory, each with the design and configuration it took
    (cuda_auction.banded_route, cluster_config). Times: warm and cold, the first sweeps
    alone and the rest per sweep, beside the global-state design on the
    same inputs."""
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound_of
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

    seen = set()

    def config_of(n):
        """The design an (n, n) element takes, and its configuration as
        the library reports it (held to cuda_auction.cluster_plan)."""
        tile = band_tile(n)
        route = cuda_auction.banded_route(n, n, tile)
        if route != "shared":
            seen.add(route)
            return f"the {route} design"
        cfg = cuda_auction.cluster_config("banded", n, n, tile)
        plan = cuda_auction.cluster_plan("banded", n, n, tile)
        if cfg != plan:
            raise AssertionError(f"auction_banded ({n}, {n}): the library "
                                 f"takes {cfg}, cluster_plan says {plan}")
        nbuf, pts, smem = cfg
        seen.add((nbuf, pts))
        return (f"the shared design, {nbuf} slot buffers, the target points "
                f"in {'shared' if pts else 'device'} memory, {smem} bytes")

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
                log(f"{name} ({config_of(n)}): row_to_col, prices and stats "
                    f"exact; sweeps per phase {st[..., 0].T.tolist()}, "
                    f"bidding rows {st[..., 1].sum(0).tolist()}, bidding "
                    f"tiles {st[..., 2].sum(0).tolist()} (of "
                    f"{n // band_tile(n)} a sweep an element), duplicate "
                    f"columns "
                    f"{int(n * b - sum(len(torch.unique(r)) for r in got[0]))}")

    # the edges: the narrowest and the widest window, one element, more
    # elements than fit the card at once, and past the cluster design's
    # shared memory (the global-state design)
    (src, moved, tgt), _ = shapes["(7, 4096, 4096) w=1024"]
    gen = np.random.RandomState(5)

    def clouds(b, n):
        a = gen.randn(b, n, 3).astype(np.float32)
        s, t, _, _ = _curve_sort(
            torch.from_numpy(a + 0.02 * gen.randn(b, n, 3).astype(
                np.float32)).to(dev), torch.from_numpy(a).to(dev), 512, None)
        return s.contiguous(), t.contiguous()

    b20 = clouds(20, 2048)
    past = clouds(1, 12288)
    s8k, t8k = clouds(1, 8192)
    moved8k = (s8k + 0.002 * torch.from_numpy(gen.randn(1, 8192, 3).astype(
        np.float32)).to(dev)).contiguous()
    price8k = solve(s8k, t8k, torch.zeros((1, 8192), device=dev), eps, 100,
                    512)[1]
    # (label, src, tgt, w, carry, prices; None: zeros)
    edges = [("w=128 (7, 4096, 4096)", src, tgt, 128, False, None),
             ("w=M-128 (7, 4096, 4096)", src, tgt, 4096 - 128, False, None),
             ("B = 1 (1, 4096, 4096) w=1024", src[:1].contiguous(),
              tgt[:1].contiguous(), 1024, False, None),
             ("(20, 2048, 2048) w=512", *b20, 512, False, None),
             ("(1, 6144, 6144) w=512", *clouds(1, 6144), 512, False, None),
             ("(1, 6656, 6656) w=512", *clouds(1, 6656), 512, False, None),
             ("(1, 8192, 8192) w=512 cold carry=False", s8k, t8k, 512,
              False, None),
             ("(1, 8192, 8192) w=512 cold carry=True", s8k, t8k, 512, True,
              None),
             ("(1, 8192, 8192) w=512 warm carry=True", moved8k, t8k, 512,
              True, price8k),
             ("past the shared memory (1, 12288, 12288) w=256", *past, 256,
              False, None)]
    for label, s, t, w, carry, p in edges:
        b, n = s.shape[:2]
        if p is None:
            p = torch.zeros((b, n), device=dev)
        got = solve(s, t, p, eps, 100, w, carry=carry, return_stats=True)
        torch.cuda.synchronize()
        ref = plain(s, t, p, eps, 100, w, carry=carry, return_stats=True)
        err = max(err, check(f"auction_banded {label}", got, ref,
                             exact={0, 1, 2}))
        log(f"auction_banded {label} ({config_of(n)}): row_to_col, prices "
            f"and stats exact; sweeps per phase "
            f"{got[2][..., 0].max(0).values.tolist()} (slowest element), "
            f"bidding rows {got[2][..., 1].sum(0).tolist()}")
    if seen != {(2, 1), (1, 1), (2, 0), (1, 0), "global"}:
        raise AssertionError(f"auction_banded: the cases took {seen}, not "
                             f"every configuration of the cluster design "
                             f"and the global-state design")

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

    def design(name, p, sweeps):
        return lambda: cuda_auction._launch_banded(
            moved if p is warm_price else src, tgt, p, eps, sweeps, w, tile,
            False, name)

    s2 = dict(
        shape="(7, 4096, 4096) w=1024, warm", max_abs_err=err,
        ms=many_ms(lambda: solve(moved, tgt, warm_price, eps, 100, w), 5, 5),
        ms_cold=many_ms(lambda: solve(src, tgt, zero, eps, 100, w), 5, 5),
        ms_first_sweeps=many_ms(design("shared", warm_price, 1), 5, 5),
        ms_first_sweeps_cold=many_ms(design("shared", zero, 1), 5, 5),
        ms_global_design=many_ms(design("global", warm_price, 100), 5, 5),
        ms_global_design_cold=many_ms(design("global", zero, 100), 5, 5),
        plain_ms=median_ms(
            lambda: plain(moved, tgt, warm_price, eps, 100, w), 2),
        band_ops=band_ops, pass_ops=pass_ops, tile_ops=tile_ops,
        **bound_of(band_ops + pass_ops, nbytes))
    later = int(st[..., 0].max(0).values.sum()) - len(eps)
    for sfx in ("", "_cold"):
        s2[f"ms_per_later_sweep{sfx}"] = (
            (s2["ms" + sfx] - s2["ms_first_sweeps" + sfx]) / max(later, 1))
    stats["auction_solve_banded"] = s2
    log(f"auction_banded (7, 4096, 4096) w=1024: warm {s2['ms']:.4f} ms "
        f"(first sweeps {s2['ms_first_sweeps']:.4f}, then "
        f"{s2['ms_per_later_sweep'] * 1e3:.2f} us a sweep of {later}), cold "
        f"{s2['ms_cold']:.4f} ms (first sweeps "
        f"{s2['ms_first_sweeps_cold']:.4f}, then "
        f"{s2['ms_per_later_sweep_cold'] * 1e3:.2f} us a sweep); the "
        f"global-state design on the same inputs "
        f"{s2['ms_global_design']:.4f} and {s2['ms_global_design_cold']:.4f} "
        f"ms; plain {s2['plain_ms']:.1f} ms; bound {s2['bound_ms']:.5f} ms by "
        f"{s2['bound_by']} (band distances {band_ops / 1e6:.1f} M "
        f"operations, the bidding rows' window passes {pass_ops / 1e6:.1f} M "
        f"(whole bidding tiles: {tile_ops / 1e6:.1f} M), "
        f"{nbytes / 1e6:.2f} MB)")


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


def _drive(args, domain, sample, save_dir, what, probes=None, arts=None):
    """One run of the command line's main path on the card (no device is
    named: the entry points take the card by themselves), every launch
    count set to 0 just before and read just after; with `arts`, input.gif
    first, as `main` writes it, and the directory goes to phase D. Returns
    (results, launches, seconds per stage, wall seconds)."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.profiling import phase_report, reset_phases

    reset_phases()
    if probes is not None:
        probes.clear()
    for w in kernel_wrappers():
        w.launches = 0
    gif_s = arts.input_gif(sample, save_dir) if arts is not None else None
    t0 = time.perf_counter()
    results = cli.run_sample(args, domain, sample, save_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if arts is not None:
        arts.add(what, save_dir, sample, input_gif_s=gif_s,
                 viz_s=phase_report()["finalize/viz"])
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


# graph/kinematics.build_graph: prismatic iff the largest relative rotation
# of the joint over the frames is below this many radians
ROT_AMP_THR = 0.15


def log_joint_rotations(what, result_path):
    """Each joint of a result.pkl's tree: the largest rotation angle of the
    child's pose relative to the parent's over the frames, which types it
    (prismatic below ROT_AMP_THR)."""
    from reart_tpu_torch import checkpoint

    saved = checkpoint.load_result(result_path)
    poses = np.asarray(saved["pred_pose_list"], np.float64)  # (T, P, 4, 4)
    parts = []
    for c, p in np.asarray(saved["joint_connection"]).reshape(-1, 2):
        rel = np.linalg.inv(poses[:, p]) @ poses[:, c]
        cos = (np.trace(rel[:, :3, :3], axis1=-2, axis2=-1) - 1.0) / 2.0
        ang = float(np.arccos(np.clip(cos, -1.0, 1.0)).max())
        kind = "prismatic" if ang < ROT_AMP_THR else "revolute"
        parts.append(f"({int(c)}, {int(p)}) {ang:.4f} rad {kind}")
    log(f"{what}: largest relative rotation of each joint: "
        + "; ".join(parts))


def sapien_chain_phase(dev, tmp, arts, keep_dir=None):
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
                                   "sapien relaxation run", probes, arts)
        _log_probes("sapien relaxation run", probes, args.assign_band_guard)
        base = os.path.join(save_dir, "result.pkl")
        log_joint_rotations("sapien relaxation run", base)
        if keep_dir is not None:
            keep = os.path.join(keep_dir, "sapien_relaxation_result.pkl")
            os.makedirs(keep_dir, exist_ok=True)
            shutil.copyfile(base, keep)
            log(f"sapien relaxation run: result.pkl kept as {keep}")
        if len(probes) != 2:
            raise AssertionError(f"sapien relaxation run: {len(probes)} guard "
                                 f"probes, expected the phase start's and "
                                 f"one re-probe")
        kargs = cli.build_parser().parse_args(
            common + ["--save_root", os.path.join(tmp, "sapien_kin"),
                      "--base_result_path", base,
                      *SAPIEN_PROJECTION.split()])
        out["projection"] = _drive(kargs, "sapien", sample,
                                   os.path.join(tmp, "sapien_kin", "0"),
                                   "sapien projection run", probes, arts)
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
        # the presolve and each dense (7, 4096, 4096) solve: one launch each
        sweep_route_unused(f"sapien {stage} run", launches,
                           presolve_only=False)
    payload = checkpoint.load_checkpoint(
        os.path.join(tmp, "sapien_kin", "0", "model.ckpt.pkl"))
    log(f"sapien projection run: joints {_joint_types(payload)}, root "
        f"trajectory {payload['has_root_trans']}")
    return {k: v[1] for k, v in out.items()}, out["relaxation"][0]


def real_chain_phase(dev, tmp, arts):
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
                               "real relaxation run", arts=arts)
    base = os.path.join(save_dir, "result.pkl")
    if not checkpoint.load_result(base)["joint_connection"]:
        raise AssertionError("real relaxation run: a single part, no tree")
    kargs = cli.build_parser().parse_args(
        common + ["--save_root", os.path.join(tmp, "real_kin"), "--model",
                  "kinematic", "--tree_search", "0", "--base_result_path",
                  base, "--n_iter", "100", "--assign_iter", "50"])
    out["projection"] = _drive(kargs, "real", sample,
                               os.path.join(tmp, "real_kin", "scans"),
                               "real projection run", arts=arts)
    for stage in ("relaxation", "projection"):
        results, launches = out[stage][:2]
        if "seg_ri" in results or "cd_err" not in results:
            raise AssertionError(f"real {stage} run: results {sorted(results)}")
        for name in ("ball_query", "fps", "blend3", "nn1_bidir_coords",
                     "auction_solve_resident"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"real {stage} run")
        sweep_route_unused(f"real {stage} run", launches)
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


class _Tee:
    """Standard output that is also kept, to read back what a run printed."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()


def printed(fn, *args, **kw):
    """fn(*args, **kw) with its standard output shown as it goes; returns
    (its return value, what it printed)."""
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        out = fn(*args, **kw)
    return out, "".join(tee.parts)


# the default projection command of the tree search's runs: no
# --tree_search flag (-1, auto), a (9, 2048, 2048) LAP every iteration
TREE_SEARCH_PROTOCOL = ("--model kinematic --assign_iter 0 --downsample 2 "
                        "--assign_gap 1 --assign_band 0 --num_parts 20 "
                        "--n_iter 100")
CANDIDATE_LINE = r"tree_search candidate (\d+):.* edges (\[.*\])"


def _tree_search_run(dev, tmp, sample, result_path, name, extra,
                     fits_each):
    """One projection run from the relaxation run's result.pkl with the
    tree search: every launch count set to 0 just before, read where the
    fit hands over to finalize and at the end. The fit stage must launch
    the streamed auction (candidates swept x fits_each x
    --tree_search_iter) + --n_iter times, the energy's presolve once a
    candidate and once in finalize; the saved tree must be the selected
    candidate's and model.ckpt.pkl must reload."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.models import KinematicModel
    from reart_tpu_torch.profiling import phase_report, reset_phases

    what = f"tree search ({name})"
    args = robot_args(f"{TREE_SEARCH_PROTOCOL} --base_result_path "
                      f"{result_path} {extra}", tmp)
    save_dir = os.path.join(tmp, f"tree_search_{name}")
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    fit_launches = {}
    finalize = cli.finalize

    def finalize_after_reading_counts(*a, **kw):
        torch.cuda.synchronize()
        fit_launches.update(launch_counts())
        return finalize(*a, **kw)

    cli.finalize = finalize_after_reading_counts
    t0 = time.perf_counter()
    try:
        # no device is named: the entry points take the card by themselves
        results, out = printed(cli.run_sample, args, "robot", sample,
                               save_dir)
    finally:
        cli.finalize = finalize
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"{what}: {k} = {v} is not finite")
    cands = [json.loads(e) for _, e in re.findall(CANDIDATE_LINE, out)]
    gate = re.findall(r"tree_search auto: .*", out)
    swept = len(cands)
    want = swept * fits_each * args.tree_search_iter + args.n_iter
    if fit_launches["auction_solve_resident_hbm"] != want:
        raise AssertionError(
            f"{what}: {fit_launches['auction_solve_resident_hbm']} launches "
            f"of the streamed auction in the fit stage, expected {swept} "
            f"candidates x {fits_each} x {args.tree_search_iter} + "
            f"{args.n_iter} = {want}")
    if launches["auction_solve_large"] != swept + 1:
        raise AssertionError(f"{what}: {launches['auction_solve_large']} "
                             f"presolves for {swept} candidate energies "
                             f"and finalize's")
    sweep_route_unused(what, launches, presolve_only=False)
    saved = checkpoint.load_result(os.path.join(save_dir, "result.pkl"))
    tree = sorted(map(sorted, saved["joint_connection"]))
    if swept:
        [sel] = re.findall(r"tree_search: selected candidate (\d+)", out)
        if tree != sorted(map(sorted, cands[int(sel)])):
            raise AssertionError(f"{what}: saved tree {tree} is not the "
                                 f"selected candidate's {cands[int(sel)]}")
    model, state = checkpoint.kinematic_model_from_checkpoint(
        checkpoint.load_checkpoint(os.path.join(save_dir, "model.ckpt.pkl")),
        device=dev)
    n_parts = len(tree) + 1
    if (not isinstance(model, KinematicModel)
            or model.theta_list.shape != (len(sample["pc_list"]),
                                          n_parts - 1)
            or [list(e) for e in state.edges] != saved["joint_connection"]
            or not all(torch.isfinite(p).all() for p in model.parameters())):
        raise AssertionError(f"{what}: model.ckpt.pkl does not reload into "
                             f"a finite KinematicModel with its state")
    # the robot fits replace recon by the assignment loss from iteration 0;
    # the holdout score's Chamfer is the fused one with coordinates
    used = ("fps", "blend3", "nn_topk", "nn1_coords", "nn_bidir") + (
        ("nn1_bidir_coords",) if fits_each == 2 else ())
    for kernel in used:
        if launches[kernel] <= 0:
            raise AssertionError(f"{what}: {kernel} was not launched")
    log(f"{what}: gate {gate[0] if gate else 'kept every candidate'}; "
        f"{swept} candidate(s) swept; saved tree {saved['joint_connection']}")
    log(f"{what}: " + ", ".join(f"{k} {v:.4f}" for k, v in results.items()))
    log(f"{what}: {wall:.2f} s; seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"{what}: kernel launches of the fit stage {fit_launches}")
    log(f"{what}: kernel launches {launches}")
    return launches


HINGE_STAR = {(0, 1), (0, 2)}


def hinge_tree_search(dev, tmp):
    """The offset-hinge robot (its arm hinges away from the origin, so a
    chain tree cannot express the second arm's motion) from a result.pkl
    of GT labels and poses and the wrong chain tree, through the default
    tree search under both criteria, on the card and on the CPU: each must
    select the star tree."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.data.synth import make_offset_hinge_sample

    sample = make_offset_hinge_sample()
    base = os.path.join(tmp, "hinge_chain_result.pkl")
    checkpoint.save_result(base, sample["gt_cano_part"],
                           sample["gt_pose_list"][1:], 0, [[1, 0], [2, 1]],
                           {})
    for select in ("energy", "holdout"):
        args = cli.build_parser().parse_args([
            "robot", "--model", "kinematic", "--base_result_path", base,
            "--n_iter", "60", "--start_tau", "1", "--end_tau", "1",
            "--tree_search_iter", "40", "--tree_select", select,
            "--silence", "--save_root", tmp])
        for where in ("cpu", dev):
            save_dir = os.path.join(
                tmp, f"hinge_{select}_{torch.device(where).type}")
            _, out = printed(cli.run_sample, args, "robot", sample, save_dir,
                             device=where)
            saved = checkpoint.load_result(os.path.join(save_dir,
                                                        "result.pkl"))
            edges = {tuple(sorted(e)) for e in saved["joint_connection"]}
            if edges != HINGE_STAR:
                raise AssertionError(
                    f"offset hinge, {select} on {where}: selected "
                    f"{sorted(edges)}, not the star {sorted(HINGE_STAR)}")
            log(f"tree search: offset hinge, --tree_select {select} on "
                f"{torch.device(where).type}: the star selected from the "
                f"chain ({len(re.findall(CANDIDATE_LINE, out))} candidates)")


def tree_search_phase(dev, tmp, sample, result_path):
    """The kinematic stage's tree search at full width, from the relaxation
    run's result.pkl (the six-part table, T=10, N=4096, 20 proposals): (a)
    the default command (no --tree_search flag: auto, gated); (b) a forced
    sweep of 4 candidates at 50 iterations; (c) --tree_select holdout over
    3 candidates at 30 iterations, each candidate with a second short fit
    on its train frames; then (d) the offset-hinge robot on the card and on
    the CPU. Returns the launch counts of (a)-(c), summed."""
    runs = [
        _tree_search_run(dev, tmp, sample, result_path, "default", "", 1),
        _tree_search_run(dev, tmp, sample, result_path, "forced",
                         "--tree_search 4 --tree_search_iter 50", 1),
        _tree_search_run(dev, tmp, sample, result_path, "holdout",
                         "--tree_search 3 --tree_search_iter 30 "
                         "--tree_select holdout", 2),
    ]
    hinge_tree_search(dev, tmp)
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# the relaxation run's protocol at a smaller depth, with the canonical-frame
# sweep: 10 candidate fits of 50 iterations, the last 10 with a LAP every 5
AUTO_CANO_PROTOCOL = ("--n_iter 100 --assign_iter 40 --num_parts 20 "
                      "--downsample 4 --seg_refine 2 --auto_cano "
                      "--auto_cano_iters 50")


def toy_auto_cano(dev):
    """The canonical-frame sweep of the toy robot on the card and on the
    CPU, from the same initial parameters and Gumbel draws: the same frame,
    each candidate's energy within the toy run's bar (RUN_TOL)."""
    from reart_tpu_torch import cli, selection
    from reart_tpu_torch.data.synth import make_toy_robot_sample

    sample = make_toy_robot_sample()
    args = robot_args("--n_iter 600 --assign_iter 400 --num_parts 5 "
                      "--start_tau 2 --end_tau 0.5 --manual_seed 0", "exp")
    cfg = dataclasses.replace(cli.fit_config(args),
                              n_iter=max(100, args.n_iter // 10),
                              use_flow_loss=False)
    shape = (sample["cano_pc"].shape[0], args.num_parts)

    def noise(it):
        return np.random.RandomState(it).gumbel(size=shape).astype(np.float32)

    runs = {}
    for where in ("cpu", dev):
        runs[str(where)] = selection.select_canonical_frame(
            sample["complete_pc_list"], cfg, args.num_parts, seed=0,
            noise=noise, verbose=False, device=where)
    (best, card), (cpu_best, cpu) = runs[str(dev)], runs["cpu"]
    kind, bar = RUN_TOL["total_err"]
    diffs = {i: abs(card[i]["total_err"] - cpu[i]["total_err"])
             / abs(cpu[i]["total_err"]) for i in cpu}
    if best != cpu_best or card.keys() != cpu.keys() or not all(
            d <= bar for d in diffs.values()):
        raise AssertionError(f"auto_cano, toy robot: the card selects {best} "
                             f"{card}, the CPU {cpu_best} {cpu}")
    log(f"auto_cano: toy robot, frame {best} on the card and the CPU; "
        f"energies on the card "
        + ", ".join(f"{i}: {e['total_err']:.4f}" for i, e in card.items())
        + f"; {kind} differences "
        + ", ".join(f"{d:.2e}" for d in diffs.values()) + f" (bar {bar})")


def auto_cano_phase(dev, tmp, sample, seq_dir):
    """`--auto_cano` through the command line's `main` at full width: the
    table sequence of phase 8 on disk, AUTO_CANO_PROTOCOL (a short fit per
    each of the 10 frames, then the relaxation run from the selected one).
    Every candidate's energy must be finite, the result.pkl's cano_idx the
    printed frame, and the candidate fits must launch the resident auction
    and fps. The sequence's GT tree rides in the sample (the card's machine
    reads no graph.gpickle). Then the toy robot's sweep, card against
    CPU."""
    from reart_tpu_torch import checkpoint, cli, selection
    from reart_tpu_torch.profiling import phase_report, reset_phases

    save_root = os.path.join(tmp, "auto_cano")
    argv = ["robot", "--use_flow_loss", "--flow_provider", "gt",
            "--use_assign_loss", "--seq_path", seq_dir, "--save_root",
            save_root, *AUTO_CANO_PROTOCOL.split()]
    seen = {}
    select = selection.select_canonical_frame
    dataset_sample = cli.dataset_sample

    def counted_select(*a, **kw):
        before = launch_counts()
        seen["call"] = (a, kw)  # phase A sweeps the same inputs batched
        with timed_energies() as energy_s:
            seen["out"] = select(*a, **kw)
            torch.cuda.synchronize()
        seen["energy_s"] = energy_s
        seen["launches"] = {k: v - before[k]
                            for k, v in launch_counts().items()}
        return seen["out"]

    def with_gt_edges(*a, **kw):
        loaded = dataset_sample(*a, **kw)
        loaded["gt_edges"] = sample["gt_edges"]
        return loaded

    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    selection.select_canonical_frame = counted_select
    cli.dataset_sample = with_gt_edges
    t0 = time.perf_counter()
    try:
        # no device is named: the command line takes the card by itself
        results, out = printed(cli.main, argv)
    finally:
        selection.select_canonical_frame = select
        cli.dataset_sample = dataset_sample
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    best, energies = seen["out"]
    frames = sample["complete_pc_list"].shape[0]
    [shown] = re.findall(r"auto_cano: selected frame (\d+)", out)
    if list(energies) != list(range(frames)) or not all(
            math.isfinite(e["total_err"]) for e in energies.values()):
        raise AssertionError(f"auto_cano: energies {energies}")
    saved = checkpoint.load_result(os.path.join(
        save_root, os.path.basename(seq_dir), "result.pkl"))
    if not int(shown) == best == saved["cano_idx"]:
        raise AssertionError(f"auto_cano: printed frame {shown}, selected "
                             f"{best}, result.pkl's cano_idx "
                             f"{saved['cano_idx']}")
    for k, v in results.items():
        if not math.isfinite(v):
            raise AssertionError(f"auto_cano run: {k} = {v} is not finite")
    # a candidate fit solves a LAP at iterations 40 and 45 and builds its
    # assignment context by 2 FPS; its energy's graph stage adds more FPS
    if seen["launches"]["auction_solve_resident"] != 2 * frames or \
            seen["launches"]["fps"] < 2 * frames:
        raise AssertionError(f"auto_cano: the candidate fits launched "
                             f"{seen['launches']}: not 2 LAPs and at least "
                             f"2 FPS each")
    if seen["launches"]["auction_solve_large"] != frames:
        raise AssertionError("auto_cano: not one presolve a candidate")
    sweep_route_unused("auto_cano run", launches, presolve_only=False)
    log(f"auto_cano: selected frame {best}; energies "
        + ", ".join(f"{i}: {e['total_err']:.4f}"
                    for i, e in energies.items()))
    log("auto_cano run: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in results.items()))
    log(f"auto_cano run: {wall:.2f} s; seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"auto_cano: kernel launches of the candidate fits and energies "
        f"{seen['launches']}")
    log(f"auto_cano run: kernel launches {launches}")
    seen["stage_s"] = phase_report()["auto_cano"]
    toy_auto_cano(dev)
    return launches, seen


@contextlib.contextmanager
def timed_energies():
    """Seconds of every selection.fit_energy call inside the block, summed
    into the yielded list's one entry (the card's work waited for)."""
    from reart_tpu_torch import selection

    total = [0.0]
    energy = selection.fit_energy

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = energy(*a, **kw)
        torch.cuda.synchronize()
        total[0] += time.perf_counter() - t0
        return out

    selection.fit_energy = timed
    try:
        yield total
    finally:
        selection.fit_energy = energy


def viz_probe():
    """Whether the packages of the JAX package's viz.py are installed on
    this machine, found without importing them (phase D fails if the port
    imported matplotlib or imageio). A missing package is reported, not a
    failure; the port's artifacts need only PIL."""
    import importlib.metadata
    import importlib.util

    found = []
    for name, dist in (("matplotlib", "matplotlib"), ("imageio", "imageio"),
                       ("PIL", "pillow")):
        if importlib.util.find_spec(name) is None:
            found.append(f"{name} absent")
            continue
        try:
            found.append(f"{name} {importlib.metadata.version(dist)}")
        except importlib.metadata.PackageNotFoundError:
            found.append(f"{name} (no version)")
    log("viz probe: " + ", ".join(found))


class ArtifactRuns:
    """The runs whose gif/html artifacts phase D checks: each directory
    with what its sample says it must hold, the seconds of its input.gif
    and of its `finalize/viz` stage, and the pairs of runs on the card and
    on the CPU to compare."""

    def __init__(self):
        self.runs = []
        self.pairs = []

    @staticmethod
    def input_gif(sample, save_dir):
        """`main`'s input.gif before a run (`cli.write_input_gif`), in
        seconds."""
        from reart_tpu_torch import cli

        t0 = time.perf_counter()
        cli.write_input_gif(sample, save_dir)
        return time.perf_counter() - t0

    def add(self, what, save_dir, sample, input_gif_s=None, viz_s=None,
            novel=0, evaluate=False):
        """A run in save_dir on `sample`: input.gif when input_gif_s is
        given, novel_<k>.html for k < novel, no result.pkl or checkpoint
        under --evaluate."""
        self.runs.append(dict(
            what=what, save_dir=save_dir,
            frames=len(sample["complete_pc_list"]),
            points=len(sample["cano_pc"]), gt="gt_flow_list" in sample,
            input_gif_s=input_gif_s, viz_s=viz_s, novel=novel,
            evaluate=evaluate))

    def pair(self, what, card_dir, cpu_dir, exact):
        """The same run on the card and on the CPU. Where `exact` (labels
        and tree already held equal) seg.html and structure.html must be
        byte-equal and every gif within the frame bars; else (two fits
        that may part by an ulp's worth of labels) both are reported."""
        self.pairs.append((what, card_dir, cpu_dir, exact))


def hold_batched(stats, name, label, got, ref, kernel_ms, plain_ms,
                 bound_=None):
    """A kernel at a shape of the batched paths against its plain version,
    every output exact; its ms go to the kernel's other shapes."""
    err = check(f"{name} {label}", got, ref, exact=set(range(len(got))))
    if err != 0.0:
        raise AssertionError(f"{name} {label}: max_abs_err {err}, not 0")
    st = stats[name]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    key = "ms_" + re.sub(r"[^0-9a-z]+", "_", label.lower()).strip("_")
    st[key] = kernel_ms
    log(f"{name} {label}: every output exact (max_abs_err 0); kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms"
        + ("" if bound_ is None else
           f", bound {bound_['bound_ms']:.5f} ms by {bound_['bound_by']}"))


# the batched sweep's energies against the sequential sweep's: each row of
# the rows fit runs the sequential fit's own products and the kernels are
# exact per element, so the energies should be equal to the last bit. From
# the identity start any ulp becomes a +-lr step of the seg MLP, which
# ROADMAP.md §3 item 23 records as 5% in the energy after 40 iterations
# between two implementations (and batched products parted one candidate
# by 60%, item 27): a difference past 5% is a different fit
BATCHED_RTOL = 5e-2


def batched_candidates_phase(dev, stats, seq_sweep):
    """Phase A: the candidate sweep of phase 13 (the table sequence, 10
    frames x 4096 points x 20 parts, AUTO_CANO_PROTOCOL's selection fits)
    as one rows fit, `select_canonical_frame(..., batched=True)` on the
    same inputs; nn1_bidir_coords (90, 4096, 4096), fps (90, 4096) and
    (10, 4096) -> 1024 and the resident auction (90, 1024, 1024) against
    their plain versions; then the same frame, each candidate's total_err
    within BATCHED_RTOL of phase 13's, and the seconds of the rows fits
    against the sequential fits (each stage less its energies)."""
    from reart_tpu_torch import parallel, selection

    a, kw = seq_sweep["call"]
    seq_best, seq_energies = seq_sweep["out"]
    fit_s = {}
    fit_rows = parallel.fit_base_candidates

    def timed_rows(*fa, **fkw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_rows(*fa, **fkw)
        torch.cuda.synchronize()
        fit_s["rows"] = time.perf_counter() - t0
        return out

    for w in kernel_wrappers():
        w.launches = 0
    parallel.fit_base_candidates = timed_rows
    t0 = time.perf_counter()
    try:
        with timed_energies() as energy_s:
            best, energies = selection.select_canonical_frame(
                *a, **{**kw, "batched": True})
            torch.cuda.synchronize()
    finally:
        parallel.fit_base_candidates = fit_rows
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # the kernels first: a kernel wrong at a batched shape shows as itself
    batched_candidate_kernels(dev, stats, a[0])
    diffs = {i: abs(energies[i]["total_err"] - e["total_err"])
             / abs(e["total_err"]) for i, e in seq_energies.items()}
    if best != seq_best or list(energies) != list(seq_energies) or not all(
            d <= BATCHED_RTOL for d in diffs.values()):
        raise AssertionError(
            f"batched candidates: frame {best}, energies "
            f"{ {i: e['total_err'] for i, e in energies.items()} }; the "
            f"sequential sweep frame {seq_best}, energies "
            f"{ {i: e['total_err'] for i, e in seq_energies.items()} }")
    seq_fits = seq_sweep["stage_s"] - seq_sweep["energy_s"][0]
    log(f"batched candidates: frame {best}, as the sequential sweep; "
        "energies " + ", ".join(f"{i}: {e['total_err']:.4f}"
                                for i, e in energies.items())
        + "; relative differences to the sequential sweep "
        + ", ".join(f"{d:.2e}" for d in diffs.values())
        + f" (bar {BATCHED_RTOL}; "
        + ("equal to the last bit)" if energies == seq_energies
           else "not equal to the last bit)"))
    log(f"batched candidates: the rows fits {fit_s['rows']:.2f} s "
        f"(the sweep {wall:.2f} s less its energies "
        f"{energy_s[0]:.2f} s: {wall - energy_s[0]:.2f} s) against the "
        f"sequential fits {seq_fits:.2f} s (phase 13's auto_cano stage "
        f"{seq_sweep['stage_s']:.2f} s less its energies "
        f"{seq_sweep['energy_s'][0]:.2f} s)")
    log(f"batched candidates: kernel launches {launches}")
    for name in ("nn1_bidir_coords", "fps", "auction_solve_resident"):
        if launches[name] <= 0:
            raise AssertionError(f"batched candidates: {name} not launched")
    # the rows fit's LAPs: one (90, 1024, 1024) launch at iterations 40
    # and 45, where the sequential sweep launched 2 a candidate
    if launches["auction_solve_resident"] != 2:
        raise AssertionError(f"batched candidates: "
                             f"{launches['auction_solve_resident']} launches "
                             f"of the resident auction, not 2")
    sweep_route_unused("batched candidates", launches, presolve_only=False)

    return launches


def batched_candidate_kernels(dev, stats, complete):
    """Phase A's kernels at the rows fit's shapes, on the sweep's own
    clouds: nn1_bidir_coords (90, 4096, 4096), fps (90, 4096) and (10,
    4096) -> 1024, the resident auction (90, 1024, 1024) cold and warm."""
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound
    from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn
    from reart_tpu_torch.ops.distance import pairwise_sqdist

    complete = torch.as_tensor(np.asarray(complete), dtype=torch.float32,
                               device=dev)
    t, n = complete.shape[:2]
    k = n // 4  # the selection fits' --downsample 4
    cano_b = complete.contiguous()                       # (10, 4096, 3)
    pc_b = torch.stack([torch.cat([complete[:i], complete[i + 1:]])
                        for i in range(t)]).reshape(-1, n, 3)
    gen = torch.Generator(device=dev).manual_seed(11)
    src = (pc_b + 0.01 * torch.randn(pc_b.shape, generator=gen,
                                     device=dev)).contiguous()
    got = cuda_nn.nn1_bidir_coords(src, pc_b)
    hold_batched(stats, "nn1_bidir_coords", f"({len(src)}, {n}, {n})", got,
                 cuda_nn.nn1_bidir_coords_plain(src, pc_b),
                 many_ms(lambda: cuda_nn.nn1_bidir_coords(src, pc_b), 10, 3),
                 median_ms(lambda: cuda_nn.nn1_bidir_coords_plain(src, pc_b),
                           1),
                 bound(PAIR_FLOPS * len(src) * n * n, (src, pc_b, *got)))
    for x in (pc_b, cano_b):
        ones = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
        got = cuda_fps.fps(x, ones, k)
        hold_batched(stats, "fps", f"({len(x)}, {n}) -> {k}", (got,),
                     (cuda_fps.fps_plain(x, ones, k),),
                     many_ms(lambda: cuda_fps.fps(x, ones, k), 3, 3),
                     median_ms(lambda: cuda_fps.fps_plain(x, ones, k), 1),
                     bound((PAIR_FLOPS + 2) * len(x) * k * n,
                           (x, ones, got)))
    idx = cuda_fps.fps(pc_b, torch.ones(pc_b.shape[:2], dtype=torch.bool,
                                        device=dev), k)
    tgt = gather_points(pc_b, idx)
    perm = torch.randperm(k, generator=gen, device=dev)
    moved = tgt[:, perm] + 0.05 * torch.randn(tgt.shape, generator=gen,
                                              device=dev)
    benefit = (-torch.sqrt(pairwise_sqdist(moved, tgt))).contiguous()
    eps = (5e-3, 1e-4)  # the fit's schedule: eps_min 1e-4, 2 scales, x50
    zero = torch.zeros((benefit.shape[0], k), device=dev)
    cold = cuda_auction.auction_solve_resident(benefit, zero, eps, 100)
    benefit2 = (-torch.sqrt(pairwise_sqdist(
        moved + 0.002 * torch.randn(tgt.shape, generator=gen, device=dev),
        tgt))).contiguous()
    warm_price = cold[1].contiguous()
    shape = f"({len(benefit)}, {k}, {k})"
    for label, bm, p in ((f"{shape} cold", benefit, zero),
                         (f"{shape} warm", benefit2, warm_price)):
        got = cuda_auction.auction_solve_resident(bm, p, eps, 100)
        torch.cuda.synchronize()
        hold_batched(stats, "auction_solve_resident", label, got,
                     cuda_auction.auction_solve_resident_plain(bm, p, eps,
                                                               100),
                     graph_ms(lambda: cuda_auction.auction_solve_resident(
                         bm, p, eps, 100), 10),
                     median_ms(lambda: cuda_auction
                               .auction_solve_resident_plain(bm, p, eps,
                                                             100), 1),
                     bound(2 * len(eps) * bm.numel(), (bm, p, *got)))
    # the first 9 elements of the warm problem alone: the time of these
    # inputs at phase 3's batch, apart from the count of elements
    bm9, p9 = benefit2[:9].contiguous(), warm_price[:9].contiguous()
    stats["auction_solve_resident"]["ms_first_9_of_warm"] = graph_ms(
        lambda: cuda_auction.auction_solve_resident(bm9, p9, eps, 100), 10)
    log(f"auction_solve_resident ({len(bm9)}, {k}, {k}) warm, the first 9 "
        f"elements of the batched problem: "
        f"{stats['auction_solve_resident']['ms_first_9_of_warm']:.4f} ms")


def batch_seq_phase(dev, tmp, stats, sequential, arts):
    """Phase B: `sapien --batch_seq 0,1,2` through `cli.main` under
    SAPIEN_PROTOCOL on three different full-width scenes under one root (8
    views x 4096 points, 6 parts; scene k drawn from seed k with its joints
    at 1 + 0.15 k times the table's rates, each with its flow file): one
    rows fit of (21, 4096, 4096) LAPs, banded with no guard, then three
    finalizes. Each sequence writes result.txt and result.pkl. Scene 0 is
    phase 10's scene: its numbers against phase 10's run (which has the
    band guard) within BATCH_SEQ_TOL, and against a sequential run of scene
    0 without the guard (the rows' arithmetic) within SAPIEN_RUN_TOL. Then
    the banded auction at (21, 4096, 4096) and blend3 at B = 21 against
    their plain versions."""
    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.bench_nn import PAIR_FLOPS, bound
    from reart_tpu_torch.data.sapien import SapienDataset
    from reart_tpu_torch.data.synth import make_sapien_scene
    from reart_tpu_torch.ops import cuda_auction, cuda_nn
    from reart_tpu_torch.ops.assignment import _curve_sort
    from reart_tpu_torch.profiling import phase_report, reset_phases

    root = make_sapien_scene(os.path.join(tmp, "sapien_batch"), n_views=8,
                             n_points=4096, n_parts=6, n_scenes=3)
    save_root = os.path.join(tmp, "sapien_batch_out")
    argv = ["sapien", "--sapien_base_folder", root, "--batch_seq", "0,1,2",
            "--flow_file", os.path.join(root, "flow_{idx}.npz"),
            "--save_root", save_root, *SAPIEN_PROTOCOL.split()]
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    t0 = time.perf_counter()
    # no device is named: the command line takes the card by itself
    results = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    seconds = phase_report()
    if len(results) != 3:
        raise AssertionError(f"batch_seq: {len(results)} results")
    for i, res in enumerate(results):
        save_dir = os.path.join(save_root, str(i))
        for name in ("result.txt", "result.pkl", "model.ckpt.pkl"):
            if not os.path.exists(os.path.join(save_dir, name)):
                raise AssertionError(f"batch_seq: sequence {i} wrote no "
                                     f"{name}")
        for k, v in res.items():
            if not math.isfinite(v):
                raise AssertionError(f"batch_seq {i}: {k} = {v}")
        if read_result_txt(os.path.join(save_dir, "result.txt")).keys() \
                != res.keys():
            raise AssertionError(f"batch_seq {i}: result.txt does not list "
                                 f"the results")
        saved = checkpoint.load_result(os.path.join(save_dir, "result.pkl"))
        log(f"batch_seq: sequence {i}, edges {saved['joint_connection']}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
    if results[1] == results[0] or results[2] == results[0]:
        raise AssertionError("batch_seq: two scenes gave equal results")
    for i in range(3):  # finalize/viz is the three finalizes' sum
        arts.add(f"batch_seq {i}", os.path.join(save_root, str(i)),
                 SapienDataset(root)[i],
                 input_gif_s=seconds[f"input_gif/{i}"],
                 viz_s=seconds["finalize/viz"] / 3)
    log(f"batch_seq: {wall:.2f} s; seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    log(f"batch_seq: kernel launches {launches}")
    # every LAP of the rows fit is banded (no guard): 20, plus the 3
    # energies' presolves on the large kernel
    if launches["auction_solve_banded"] != 20 or \
            launches["auction_solve_large"] != 3:
        raise AssertionError("batch_seq: not 20 banded LAPs and 3 presolves")
    for name in ("nn1_bidir_coords", "blend3", "fps"):
        if launches[name] <= 0:
            raise AssertionError(f"batch_seq: {name} not launched")
    sweep_route_unused("batch_seq", launches, presolve_only=False)

    diffs = within(results[0], sequential, BATCH_SEQ_TOL,
                   "batch_seq scene 0 against phase 10's run")
    log("batch_seq: scene 0 against phase 10's run (band guard on): "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    args = cli.build_parser().parse_args(
        ["sapien", "--sapien_base_folder", root, "--sapien_idx", "0",
         "--flow_file", os.path.join(root, "flow_0.npz"), "--save_root",
         os.path.join(tmp, "sapien_noguard"), *SAPIEN_PROTOCOL.split(),
         "--assign_band_guard", "0"])
    sample = cli.dataset_sample(cli.load_dataset(args), 0)
    noguard, ng_launches, _, _ = _drive(
        args, "sapien", sample, os.path.join(tmp, "sapien_noguard", "0"),
        "sapien relaxation run of scene 0, no band guard")
    diffs = within(results[0], noguard, SAPIEN_RUN_TOL,
                   "batch_seq scene 0 against its sequential run without "
                   "the guard")
    log("batch_seq: scene 0 against its sequential run without the guard: "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
        + ("; equal" if noguard == results[0] else ""))

    # the kernels at the rows fit's shapes, on the three scenes
    scenes = [SapienDataset(root)[k] for k in range(3)]
    rng = np.random.RandomState(5)
    gt = np.concatenate([s["gt_pc_list"] for s in scenes])
    obs = np.concatenate([s["pc_list"] for s in scenes])
    b, n = obs.shape[:2]
    w = min(1024, n // 2)  # the fit's auto band at n = 4096
    src = gt + 0.02 * rng.randn(*gt.shape).astype(np.float32)
    s_src, s_tgt, _, _ = _curve_sort(torch.from_numpy(src).to(dev),
                                     torch.from_numpy(obs).to(dev), w, None)
    s_src, s_tgt = s_src.contiguous(), s_tgt.contiguous()
    eps = (5e-3, 1e-4)
    zero = torch.zeros(s_src.shape[:2], device=dev)
    solve = cuda_auction.auction_solve_banded
    plain = cuda_auction.auction_solve_banded_plain
    cold = solve(s_src, s_tgt, zero, eps, 100, w)
    moved = (s_src + 0.002 * torch.from_numpy(rng.randn(*src.shape).astype(
        np.float32)).to(dev)).contiguous()
    shape = f"({b}, {n}, {n}) w={w}"
    for label, x, p in ((f"{shape} cold", s_src, zero),
                        (f"{shape} warm", moved, cold[1].contiguous())):
        got = solve(x, s_tgt, p, eps, 100, w)
        torch.cuda.synchronize()
        # the band's distances once per epsilon phase (the bidding rows'
        # passes depend on the data and are not counted here)
        hold_batched(stats, "auction_solve_banded", label, got,
                     plain(x, s_tgt, p, eps, 100, w),
                     median_ms(lambda: solve(x, s_tgt, p, eps, 100, w), 5),
                     median_ms(lambda: plain(x, s_tgt, p, eps, 100, w), 1),
                     bound(PAIR_FLOPS * b * n * w * len(eps),
                           (x, s_tgt, p, *got)))
    complete = torch.from_numpy(np.stack(
        [s["complete_pc_list"] for s in scenes])).to(dev)
    anchors = complete[:, :-1].reshape(-1, n, 3).contiguous()
    query = (anchors + 0.01 * torch.from_numpy(
        rng.randn(*anchors.shape).astype(np.float32)).to(dev)).contiguous()
    flows = (complete[:, 1:] - complete[:, :-1]).reshape(-1, n, 3) \
        .contiguous()
    got = cuda_nn.blend3(query, anchors, flows)
    hold_batched(stats, "blend3", f"({len(query)}, {n}, {n})", got,
                 cuda_nn.blend3_plain(query, anchors, flows),
                 many_ms(lambda: cuda_nn.blend3(query, anchors, flows), 10,
                         3),
                 median_ms(lambda: cuda_nn.blend3_plain(query, anchors,
                                                        flows), 1),
                 bound(PAIR_FLOPS * len(query) * n * n,
                       (query, anchors, flows, *got)))
    return launches


# scene 0 of the batch against phase 10's sequential run of the same scene:
# phase 10's band guard solves the first half of the assignment phase dense
# (10 of its 20 LAPs), the rows fit every LAP banded (no guard, as in the
# JAX package), so the two fits part; these bars say both ended in the same
# basin: the RI within 0.1, the errors within a factor of two. The rows'
# arithmetic is held by the run of scene 0 without the guard
BATCH_SEQ_TOL = {"seg_ri": ("abs", 0.1), "recon_err": ("rel", 1.0),
                 "cd_err": ("rel", 1.0), "full_flow_epe": ("rel", 1.0),
                 "per_scan_ri": ("abs", 0.1),
                 "multi_scan_ri": ("abs", 0.1), "ass_err": ("rel", 1.0),
                 "screw_err": ("abs", 0.05), "total_err": ("rel", 1.0)}


def snapshot_phase(dev, tmp, sample, run_result):
    """Phase C: phase 6's relaxation run again with --snapshot_graph
    --snapshot_gap 100 --trace_dir: result.pkl equal to phase 6's bit for
    bit, three snapshot rows in result.txt, a trace that names the Chamfer
    kernel. Then phase 6's and phase 7's models written as the reference's
    torch-format checkpoints: `--resume` of each (with --evaluate) gives
    the numbers of `--resume` of its model.ckpt.pkl."""
    import glob
    import gzip

    from reart_tpu_torch import checkpoint, cli
    from reart_tpu_torch.profiling import phase_report, reset_phases

    trace_dir = os.path.join(tmp, "trace")
    save_dir = os.path.join(tmp, "table_snap")
    args = robot_args(RUN_PROTOCOL + " --snapshot_graph --snapshot_gap 100 "
                      f"--trace_dir {trace_dir}", tmp)
    reset_phases()
    for w in kernel_wrappers():
        w.launches = 0
    t0 = time.perf_counter()
    # no device is named: the entry points take the card by themselves
    cli.run_sample(args, "robot", sample, save_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    got = checkpoint.load_result(os.path.join(save_dir, "result.pkl"))
    ref = checkpoint.load_result(run_result)
    bad = [k for k in ref if k not in got or not np.array_equal(
        np.asarray(got[k]), np.asarray(ref[k]))]
    if bad or got.keys() != ref.keys():
        raise AssertionError(f"snapshots: result.pkl differs from phase 6's "
                             f"at {bad}")
    with open(os.path.join(save_dir, "result.txt")) as f:
        txt = f.read().splitlines()
    at = txt.index("# mid-fit snapshots (--snapshot_metrics)")
    rows = txt[at + 1:]
    with open(os.path.join(os.path.dirname(run_result), "result.txt")) as f:
        if f.read().splitlines() != txt[:at - 1]:
            raise AssertionError("snapshots: result.txt's numbers differ "
                                 "from phase 6's")
    if [r.split(" |")[0] for r in rows] != ["snapshot 100", "snapshot 200",
                                            "snapshot 300"] or not all(
            "total_err" in r and "edges" in r for r in rows):
        raise AssertionError(f"snapshots: rows {rows}")
    for r in rows:
        log(f"snapshots: {r}")
    [trace] = glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz"))
    with gzip.open(trace, "rt") as f:
        text = f.read()
    # the port's kernel symbols (in anonymous namespaces, so the trace
    # shows "(anonymous namespace)::<symbol>(...)")
    symbols = set()
    for src in glob.glob(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "reart_tpu_torch", "csrc", "*.cu")):
        with open(src) as f:
            symbols |= set(re.findall(r"\b(\w+_kernel)\s*\(", f.read()))
    names = sorted(k for k in symbols if k in text)
    if "nn1_bidir_scan_kernel" not in names:
        raise AssertionError(f"snapshots: the trace names no Chamfer kernel; "
                             f"the port's kernels in it: {names}")
    log(f"snapshots: result.pkl bit-equal to phase 6's; {wall:.2f} s; "
        "seconds per stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_report().items()))
    log(f"snapshots: trace {os.path.getsize(trace)} bytes gzipped, "
        f"{len(text)} bytes of JSON, the port's kernels named: {names}")
    log(f"snapshots: kernel launches {launches}")

    # the reference's torch-format checkpoints of phases 6 and 7
    for what, pkl, extra in (
            ("relaxation", os.path.join(tmp, "table", "model.ckpt.pkl"),
             RUN_PROTOCOL),
            ("projection", os.path.join(tmp, "table_kinematic",
                                        "model.ckpt.pkl"),
             "--model kinematic --num_parts 20")):
        payload = checkpoint.load_checkpoint(pkl)
        zipped = os.path.join(tmp, f"{what}.pth")
        if payload.get("seg_part") is None:
            checkpoint.save_torch_base(
                zipped, checkpoint.base_model_from_checkpoint(payload,
                                                              device=dev),
                payload["tau"], payload["cano_idx"])
        else:
            model, state = checkpoint.kinematic_model_from_checkpoint(
                payload, device=dev)
            checkpoint.save_torch_kinematic(zipped, model, state,
                                            payload["tau"],
                                            payload["cano_idx"])
        out = {}
        for fmt, path in (("pickle", pkl), ("torch", zipped)):
            rargs = robot_args(f"{extra} --evaluate --resume {path}", tmp)
            out[fmt] = cli.run_sample(rargs, "robot", sample, os.path.join(
                tmp, f"resume_{what}_{fmt}"))
        if out["torch"] != out["pickle"]:
            raise AssertionError(f"resume of the {what} run: torch-format "
                                 f"{out['torch']} vs pickle {out['pickle']}")
        log(f"resume of the {what} run's torch-format checkpoint "
            f"({os.path.getsize(zipped)} bytes): the numbers of its "
            "model.ckpt.pkl, "
            + ", ".join(f"{k} {v:.4f}" for k, v in out["torch"].items()))
    return launches


# the gifs of a run on the card against the same run on the CPU (phase D):
# each frame's mask of pixels with any channel below GIF_MASK_LEVEL,
# dilated by GIF_DILATE px, overlaps at least GIF_MIN_IOU, and the masks'
# centroids lie within GIF_CENTROID_PX (the bars the CPU tests hold the
# renderer to against the JAX package's matplotlib frames)
GIF_MASK_LEVEL = 240
GIF_DILATE = 2
GIF_MIN_IOU = 0.85
GIF_CENTROID_PX = 2.0
# the frame time the port writes (ROADMAP §3 item 28)
GIF_FRAME_MS = 300


def gif_frames(path, frames):
    """A gif's frames as (H, W, 3) uint8 after checking it: 320 x 320,
    looping, 300 ms a frame and `frames` frames (PIL folds a frame equal to
    the one before into it and adds the durations, so the durations sum to
    frames x 300 ms)."""
    from PIL import Image

    out, total = [], 0
    with Image.open(path) as im:
        if im.size != (320, 320) or im.info.get("loop") != 0:
            raise AssertionError(f"{path}: size {im.size}, loop "
                                 f"{im.info.get('loop')}")
        for k in range(im.n_frames):
            im.seek(k)
            ms = im.info.get("duration")
            if not ms or ms % GIF_FRAME_MS:
                raise AssertionError(f"{path}: frame {k} lasts {ms} ms")
            total += ms
            out.append(np.asarray(im.convert("RGB")))
    if total != frames * GIF_FRAME_MS:
        raise AssertionError(f"{path}: {total} ms over {len(out)} frames, "
                             f"expected {frames} frames of {GIF_FRAME_MS}")
    return out


def html_sets(path):
    """The point sets of a canvas viewer: [(points, colours)]."""
    with open(path) as f:
        text = f.read()
    if "<canvas" not in text or "const DATA=" not in text:
        raise AssertionError(f"{path}: not the canvas viewer")
    data = json.loads(text.split("const DATA=")[1].split(";\n")[0])
    return [(len(d["p"]) // 3, len(d["c"])) for d in data]


def _frame_mask(frame):
    return (np.asarray(frame) < GIF_MASK_LEVEL).any(axis=-1)


def _dilated(mask):
    r = GIF_DILATE
    padded = np.pad(mask, r)
    out = np.zeros_like(mask)
    for dr in range(2 * r + 1):
        for dc in range(2 * r + 1):
            out |= padded[dr:dr + mask.shape[0], dc:dc + mask.shape[1]]
    return out


def artifacts_phase(arts):
    """Phase D: the artifacts of every recorded run. Each directory holds
    exactly the gifs and html files its run writes: input.gif (runs through
    the command line's main path), recon.gif, gt.gif where the sample has
    GT flow, seg.html, structure.html, novel_<k>.html after a robot
    projection; each gif T frames of 320 x 320, looping, 300 ms a frame;
    each html the canvas viewer with sets of the cloud's size. Card against
    CPU, where labels and tree are held equal: the html byte-equal, the
    gifs within the frame bars (other pairs reported). matplotlib and
    imageio were never imported.
    Prints each full-width run's input.gif and finalize/viz seconds."""
    for run in arts.runs:
        where, t, n = run["save_dir"], run["frames"], run["points"]
        names = set(os.listdir(where))
        want = {"recon.gif", "seg.html", "structure.html", "result.txt"}
        want |= {"input.gif"} if run["input_gif_s"] is not None else set()
        want |= {"gt.gif"} if run["gt"] else set()
        want |= {f"novel_{k}.html" for k in range(run["novel"])}
        extra = {"result.pkl", "model.ckpt.pkl"}
        if run["evaluate"]:
            if names & extra:
                raise AssertionError(f"{run['what']}: --evaluate wrote "
                                     f"{sorted(names & extra)}")
        else:
            want |= extra
        if names != want:
            raise AssertionError(f"{run['what']}: {where} holds "
                                 f"{sorted(names)}, expected {sorted(want)}")
        for name in sorted(names):
            if name.endswith(".gif"):
                gif_frames(os.path.join(where, name), t)
        two = [(n, n), (n, n)]
        for name, sets in (("seg.html", two if run["gt"] else [(n, n)]),
                           *((f"novel_{k}.html", two)
                             for k in range(run["novel"]))):
            got = html_sets(os.path.join(where, name))
            if got != sets:
                raise AssertionError(f"{run['what']}: {name} sets {got}, "
                                     f"expected {sets}")
        structure = html_sets(os.path.join(where, "structure.html"))
        if structure[0] != (n, n) or len(structure) not in (2, 3):
            raise AssertionError(f"{run['what']}: structure.html sets "
                                 f"{structure}")
        log(f"artifacts: {run['what']}: {sorted(names - {'result.txt'} - extra)}"
            f" ({t} frames, {n} points)")
    for what, card_dir, cpu_dir, exact in arts.pairs:
        equal = []
        for name in ("seg.html", "structure.html"):
            with open(os.path.join(card_dir, name), "rb") as a, \
                    open(os.path.join(cpu_dir, name), "rb") as b:
                equal.append(a.read() == b.read())
        if exact and not all(equal):
            raise AssertionError(f"artifacts: {what}: seg.html, "
                                 f"structure.html byte-equal {equal}")
        t = next(r["frames"] for r in arts.runs if r["save_dir"] == card_dir)
        worst_iou, worst_shift = 1.0, 0.0
        for name in sorted(os.listdir(card_dir)):
            if not name.endswith(".gif"):
                continue
            for a, b in zip(gif_frames(os.path.join(card_dir, name), t),
                            gif_frames(os.path.join(cpu_dir, name), t)):
                ma, mb = _frame_mask(a), _frame_mask(b)
                da, db = _dilated(ma), _dilated(mb)
                iou = (da & db).sum() / max((da | db).sum(), 1)
                shift = max(np.abs(np.mean(np.nonzero(ma), axis=1)
                                   - np.mean(np.nonzero(mb), axis=1)))
                worst_iou = min(worst_iou, iou)
                worst_shift = max(worst_shift, shift)
        if exact and (worst_iou < GIF_MIN_IOU
                      or worst_shift > GIF_CENTROID_PX):
            raise AssertionError(f"artifacts: {what}: the card's gifs against "
                                 f"the CPU's: IoU {worst_iou}, centroid "
                                 f"{worst_shift} px")
        log(f"artifacts: {what}, card against CPU: seg.html, structure.html "
            f"byte-equal {equal}; gifs: the least IoU {worst_iou:.4f}, the "
            f"largest centroid shift {worst_shift:.3f} px")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("matplotlib", "imageio"))
    if loaded:
        raise AssertionError(f"artifacts: the port imported {loaded}")
    for run in arts.runs:
        if run["viz_s"] is not None:
            log(f"artifacts: {run['what']}: input.gif "
                f"{run['input_gif_s']:.3f} s, finalize/viz "
                f"{run['viz_s']:.3f} s")
    log(f"artifacts: {len(arts.runs)} directories, {len(arts.pairs)} card "
        "against CPU pairs; matplotlib and imageio never imported")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keep_dir", default=None,
                        help="a directory to copy the full-width sapien "
                             "relaxation run's result.pkl into (phase 10)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs "
              "only on a CUDA GPU", file=sys.stderr)
        return 1
    import reart_tpu_torch  # noqa: F401  (precision defaults)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - start
        return out

    card = timed("device", device_phase)
    viz_probe()
    arts = ArtifactRuns()
    timed("build", build_phase)
    stats = timed("kernels", kernel_phase, dev)
    timed("reference fit", reference_phase, dev)
    with tempfile.TemporaryDirectory() as tmp:
        timed("toy robot", toy_robot_phase, dev, tmp, arts)
        timed("finalize", finalize_phase, dev, tmp, arts)
        timed("projection check", kinematic_check_phase, dev, tmp, arts)
        timed("backbone check", backbone_check_phase, dev)
        fit_launches = timed("nao fit", fit_phase, dev)
        run_launches, sample, result_path = timed("run", run_phase, dev,
                                                  tmp, arts)
        projection_launches = timed("projection run", projection_run_phase,
                                    dev, tmp, sample, result_path, arts)
        corr_launches, seq_dir, norm_file, corr_path = timed(
            "corr", corr_train_phase, dev, tmp, sample)
        corr_flow_launches = timed("corr-flow run", corr_flow_run_phase, dev,
                                   tmp, sample, seq_dir, norm_file,
                                   corr_path, stats)
        tree_search_launches = timed("tree search", tree_search_phase, dev,
                                     tmp, sample, result_path)
        auto_cano_launches, seq_sweep = timed(
            "auto_cano", auto_cano_phase, dev, tmp, sample, seq_dir)
        batched_launches = timed("batched candidates",
                                 batched_candidates_phase, dev, stats,
                                 seq_sweep)
        timed("toy sapien", toy_sapien_phase, dev, tmp)
        sapien, sapien_run = timed("sapien chain", sapien_chain_phase, dev,
                                   tmp, arts, args.keep_dir)
        batch_seq_launches = timed("batch_seq", batch_seq_phase, dev, tmp,
                                   stats, sapien_run, arts)
        real = timed("real chain", real_chain_phase, dev, tmp, arts)
        snapshot_launches = timed("snapshots", snapshot_phase, dev, tmp,
                                  sample, result_path)
        timed("artifacts", artifacts_phase, arts)
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)  # once more, where the end of a long log still shows it
    kernels = []
    for name, (src, rep) in KERNELS.items():
        st = stats[name]
        # launches: over the full-width main paths, each driven from counts
        # of 0 (robot: the relaxation run, the projection run, the corr
        # training run, the relaxation run from corr flow, the three tree
        # search runs, the --auto_cano run, the batched candidate sweep,
        # the relaxation run with snapshots; sapien: both runs, the
        # --batch_seq run; real: the corr training run and both runs)
        paths = (run_launches, projection_launches, corr_launches,
                 corr_flow_launches, tree_search_launches,
                 auto_cano_launches, *sapien.values(), *real.values(),
                 batched_launches, batch_seq_launches, snapshot_launches)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(p[name] for p in paths),
                 "launches_run": run_launches[name],
                 "launches_projection": projection_launches[name],
                 "launches_corr_train": corr_launches[name],
                 "launches_corr_flow_run": corr_flow_launches[name],
                 "launches_tree_search": tree_search_launches[name],
                 "launches_auto_cano": auto_cano_launches[name],
                 "launches_batched_candidates": batched_launches[name],
                 "launches_batch_seq": batch_seq_launches[name],
                 "launches_snapshots": snapshot_launches[name],
                 "launches_sapien_run": sapien["relaxation"][name],
                 "launches_sapien_projection": sapien["projection"][name],
                 "launches_real_corr_train": real["corr"][name],
                 "launches_real_run": real["relaxation"][name],
                 "launches_real_projection": real["projection"][name],
                 "launches_fit": fit_launches[name],
                 "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                 "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                 "bound_by": st["bound_by"],
                 # a single PyTorch call computes none of these functions
                 # but BatchNorm (F.batch_norm + ReLU, a yardstick only)
                 "library_ms": st.get("library_ms"), "shape": st["shape"],
                 # the other shapes timed in phase 3
                 "other_ms": {k: v for k, v in st.items()
                              if k.startswith("ms_")}}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

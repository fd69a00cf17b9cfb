#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reart_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build:  compiles reart_tpu_torch/csrc/*.cu (sm_90a) into the kernel
             library and prints the build time and ptxas resource lines;
  3. kernels vs plain: every kernel of the relaxation fit's path against its
             plain PyTorch version on the card, at the fit's shapes plus a
             ragged one; indices exact, floats within FLOAT_TOL; median ms;
  4. reference: a toy fit on the card against the same fit on the CPU;
  5. the slice: fit_base at nao scale (bench.py's synthetic sequence and
             config, 60 iterations), with every kernel's launch count.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports neither jax nor reart_tpu.
"""

import json
import subprocess
import sys
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

KERNELS = {
    "nn1_bidir_coords": ("reart_tpu_torch/csrc/nn1_bidir_coords.cu",
                         "reart_tpu/ops/pallas_nn.py:503"),
    "blend3": ("reart_tpu_torch/csrc/blend3.cu",
               "reart_tpu/ops/pallas_nn.py:623"),
    "fps": ("reart_tpu_torch/csrc/fps.cu",
            "reart_tpu/ops/pallas_fps.py:31"),
    "auction_solve_resident": ("reart_tpu_torch/csrc/auction.cu",
                               "reart_tpu/ops/pallas_auction.py:193"),
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
        err = max(err, float((g.double() - r.double()).abs().max()))
    return err


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())  # the card's name and power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")


def build_phase():
    from reart_tpu_torch.ops import _build

    path, seconds, build_log = _build.build()
    _build.load_library()
    log(f"build: {path} in {seconds:.1f} s "
        f"({'built now' if seconds else 'already built'})")
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"  ptxas: {line.strip()}")


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
    src = (pcs + 0.01 * randn(9, 4096, 3)).contiguous()
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
    stats["nn1_bidir_coords"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: cuda_nn.nn1_bidir_coords(src, pcs), 20),
        plain_ms=median_ms(lambda: cuda_nn.nn1_bidir_coords_plain(src, pcs),
                           5))

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
    stats["blend3"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: cuda_nn.blend3(query, anchors, flows), 20),
        plain_ms=median_ms(lambda: cuda_nn.blend3_plain(query, anchors,
                                                        flows), 5))

    # row 12: FPS of the assign context, (1, 4096) and (9, 4096) -> 1024
    ones1 = torch.ones((1, 4096), dtype=torch.bool, device=dev)
    ones9 = torch.ones((9, 4096), dtype=torch.bool, device=dev)
    half = torch.rand((9, 4096), generator=gen, device=dev) < 0.5
    half[:, :7] = False
    cano1 = cano[None].contiguous()
    cases = [("(1, 4096) -> 1024", cano1, ones1, 1024),
             ("(9, 4096) -> 1024", pcs, ones9, 1024),
             ("masked (9, 4096) -> 1024", pcs, half, 1024),
             ("ragged (2, 300) -> 64", randn(2, 300, 3),
              torch.ones((2, 300), dtype=torch.bool, device=dev), 64)]
    err = 0.0
    for label, x, m, k in cases:
        got = cuda_fps.fps(x, m, k)
        ref = cuda_fps.fps_plain(x, m, k)
        err = max(err, check(f"fps {label}", (got,), (ref,), exact={0}))
        if not bool(m.gather(1, got).all()):
            raise AssertionError(f"fps {label}: picked a masked-out point")
        log(f"fps {label}: order exact")
    stats["fps"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: cuda_fps.fps(pcs, ones9, 1024), 10),
        plain_ms=median_ms(lambda: cuda_fps.fps_plain(pcs, ones9, 1024), 3))
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
    stats["auction_solve_resident"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: cuda_auction.auction_solve_resident(
            benefit2, warm_price, eps, 100), 10),
        plain_ms=median_ms(lambda: cuda_auction.auction_solve_resident_plain(
            benefit2, warm_price, eps, 100), 3))
    stats["auction_solve_resident"]["ms_cold"] = median_ms(
        lambda: cuda_auction.auction_solve_resident(benefit, zero, eps, 100),
        10)
    for name, s in stats.items():
        log(f"timing {name}: kernel {s['ms']:.4f} ms, plain "
            f"{s['plain_ms']:.4f} ms "
            + " ".join(f"{k} {v:.4f}" for k, v in s.items()
                       if k.startswith("ms_")))
    return stats


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
    init = BaseModel(p, t - 1, generator=torch.Generator().manual_seed(0))
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
        model = BaseModel(p, t - 1)
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


def slice_phase(dev):
    """fit_base at nao scale: T=10, N=4096, P=20, flow + assign losses,
    assign_gap 5, downsample 4 (LAP 9 x 1024^2), 30 + 30 iterations."""
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.models.base_model import gumbel_noise
    from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn
    from reart_tpu_torch.train import FitConfig, FlowContext, fit_base

    cano, pcs, complete = sequence(dev)
    c = complete.cpu().numpy()
    flow_ctx = FlowContext.from_lists([c[i] for i in range(9)],
                                      [c[i + 1] - c[i] for i in range(9)],
                                      device=dev)
    cfg = FitConfig(n_iter=60, use_assign_loss=True, use_flow_loss=True,
                    assign_iter=30, assign_gap=5, downsample=4)

    def make_model(seed):
        return BaseModel(20, 9, generator=torch.Generator().manual_seed(seed),
                         device=dev)

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

    wrappers = (cuda_nn.nn1_bidir_coords, cuda_nn.blend3, cuda_fps.fps,
                cuda_auction.auction_solve_resident)
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
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the fit")
    n_recon = cfg.assign_iter
    recon_s = marks[n_recon] - marks[0]
    assign_s = t_end - marks[n_recon]
    log(f"slice: fit_base nao scale, {cfg.n_iter} iters: total_loss "
        f"{total[0]:.4f} -> {total[-1]:.4f}; recon+flow phase "
        f"{n_recon / recon_s:.2f} iters/s (incl. the FPS assign-context "
        f"build), assign+flow phase "
        f"{(cfg.n_iter - n_recon) / assign_s:.2f} iters/s")
    log(f"slice: kernel launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs "
              "only on a CUDA GPU", file=sys.stderr)
        return 1
    import reart_tpu_torch  # noqa: F401  (precision defaults)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    stats = kernel_phase(dev)
    reference_phase(dev)
    launches = slice_phase(dev)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

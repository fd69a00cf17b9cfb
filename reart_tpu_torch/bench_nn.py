"""Time the neighbour kernels nn_topk and ball_query on the card.

    python -m reart_tpu_torch.bench_nn [--sweep]
    PYTHONPATH=<a checkout> python <this file> --wrappers_only

Part 1, the wrappers: `ops.cuda_nn.nn_topk` at every shape the paths
launch (the seg-refinement table, 20 candidate clouds a frame against their
frame, k=1; (9, 4096, 4096) at k=1 and k=3; one 4096-point cloud against
itself at k=8; IK's label transfer, 6 points against 4096; the backbone's
four 3-NN shapes), `ball_query` at SA1 r=0.2 K=128 of the nine flow clouds
and a training batch's five groupings, and, as controls that share none of
the redesigned code, `nn_bidir` at (9, 4096, 4096) and `nn1_coords` at
(400, 20, 20). Each output is checked against its plain version (indices
and distances exact), then timed on the device: a CUDA graph of many calls
replayed between two CUDA events, the median of 5 (ms a call). Only public
wrappers are called, so with PYTHONPATH set to another checkout and
--wrappers_only the same file times that checkout's kernels.

Part 2, the options: variants of the kernel library with one option size of
`ops._build.DEFINES` changed each (REART_NN_QPT, the queries an nn_topk
thread carries; REART_BQ_V, the points a ball_query lane looks at per
step), each into its own file under reart_tpu_torch/_build/; every
variant is checked against the plain versions, then each is timed twice,
in the order A B ... B A on one card.

With --sweep, then: every (queries a thread, slices) of nn_topk and every
block size of ball_query at each shape, the library as built, each checked
and timed once (how `nn_topk_plan` and `ball_query_warps` were chosen).

Prints one line a shape or variant with the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from reart_tpu_torch.ops import _build, cuda_fps
from reart_tpu_torch.ops import cuda_nn as C


def graph_ms(fn, launches=20, reps=5):
    """Device ms of one call: `launches` calls captured into a CUDA graph,
    replayed between two CUDA events; median over `reps`."""
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


def clouds(dev):
    """The inputs, made from seeds: bench.py's nao-scale sequence (a cloud
    and nine shifted copies) for the cloud-scale searches; for the backbone,
    the nine frames of chip_smoke.py's articulated table normalised into
    the unit ball, and a training batch of 8 clouds of 1024 of their points,
    each with its two FPS levels (512 and 128 centroids)."""
    from reart_tpu_torch.data.synth import (
        make_robot_sample,
        unit_ball_normalization,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rng = np.random.RandomState(0)
    cano = torch.from_numpy(rng.randn(4096, 3).astype(np.float32)).to(dev)
    pcs = torch.stack([cano + 0.02 * i for i in range(1, 10)]).contiguous()
    src = (pcs + 0.01 * randn(9, 4096, 3)).contiguous()
    table = (pcs[:, None] + 0.01 * randn(9, 20, 4096, 3)).contiguous()
    sample = make_robot_sample(n_frames=10, n_points=4096, n_parts=6, seed=0)
    centroid, scale = unit_ball_normalization(sample)
    frames = torch.from_numpy((sample["complete_pc_list"] - centroid)
                              * np.float32(scale)).to(dev)[:-1].contiguous()
    pick = torch.stack([torch.randperm(4096, generator=gen, device=dev)[:1024]
                        for _ in range(8)])
    train = torch.gather(frames[torch.arange(8, device=dev) % 9], 1,
                         pick[..., None].expand(-1, -1, 3)).contiguous()
    levels = {}
    for group, x in (("flow", frames), ("train", train)):
        out = [x]
        for npoint in (512, 128):
            y = out[-1]
            mask = torch.ones(y.shape[:2], dtype=torch.bool, device=dev)
            idx = cuda_fps.fps(y, mask, npoint)
            out.append(torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
                       .contiguous())
        levels[group] = out
    return dict(cano=cano, pcs=pcs, src=src, table=table, levels=levels)


def topk_shapes(x):
    """label -> (query, ref, k) of every nn_topk shape the paths launch."""
    shapes = {
        "k=1 (9, 20, 4096) vs (9, 1, 4096), the table": (
            x["table"], x["pcs"][:, None], 1),
        "k=1 (9, 4096, 4096)": (x["src"], x["pcs"], 1),
        "k=3 (9, 4096, 4096)": (x["src"], x["pcs"], 3),
        "k=8 (4096, 3) against itself": (x["cano"], x["cano"], 8),
        "k=1 IK (6, 3) vs (4096, 3)": (x["cano"][:6] + 0.01, x["cano"], 1),
    }
    for group, lv in x["levels"].items():
        for q, r in ((lv[1], lv[2]), (lv[0], lv[1])):
            shapes[f"k=3 {group} {tuple(q.shape[:2])} vs "
                   f"{tuple(r.shape[:2])}"] = (q, r, 3)
    return shapes


def ball_shapes(x):
    """label -> (radius, K, xyz, new_xyz): SA1 r=0.2 K=128 of the flow
    clouds, and the five groupings of a training batch."""
    from reart_tpu_torch.models.pointnet2 import SA1, SA2

    flow, train = x["levels"]["flow"], x["levels"]["train"]
    shapes = {"SA1 r=0.2 K=128 flow (9, 4096) x (9, 512)": (
        0.2, 128, flow[0], flow[1])}
    for layer, spec, lo in (("SA1", SA1, 0), ("SA2", SA2, 1)):
        for r, k in zip(spec[1], spec[2]):
            shapes[f"{layer} r={r} K={k} train "
                   f"{tuple(train[lo].shape[:2])} x "
                   f"{tuple(train[lo + 1].shape[:2])}"] = (
                r, k, train[lo], train[lo + 1])
    return shapes


def same(got, ref):
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def plain_topk(q, r, k):
    qf, rf, ref_div, batch = C._flatten_query_ref("nn_topk", q, r)
    return tuple(t.reshape(batch + t.shape[-2:])
                 for t in C.nn_topk_plain(qf, rf, k, ref_div))


def wrappers(card, x):
    """Part 1: each wrapper at each shape, checked, then timed."""
    for label, (q, r, k) in topk_shapes(x).items():
        if not same(C.nn_topk(q, r, k), plain_topk(q, r, k)):
            raise AssertionError(f"nn_topk {label}: differs from the plain "
                                 f"version")
        ms = graph_ms(lambda: C.nn_topk(q, r, k),
                      5 if "table" in label else 50)
        print(f"{card}: nn_topk {label}: {ms:.5f} ms", flush=True)
    total = 0.0
    for label, (rad, k, xyz, new) in ball_shapes(x).items():
        got = C.ball_query(rad, k, xyz, new)
        if not torch.equal(got, C.ball_query_plain(rad, k, xyz, new)):
            raise AssertionError(f"ball_query {label}: differs from the "
                                 f"plain version")
        ms = graph_ms(lambda: C.ball_query(rad, k, xyz, new), 100)
        total += ms if "train" in label else 0.0
        print(f"{card}: ball_query {label}: {ms:.5f} ms", flush=True)
    print(f"{card}: ball_query the training batch's five: {total:.5f} ms",
          flush=True)
    src, pcs = x["src"], x["pcs"]
    if not same(C.nn_bidir(src, pcs), C.nn_bidir_plain(src, pcs)):
        raise AssertionError("nn_bidir differs from the plain version")
    print(f"{card}: nn_bidir (9, 4096, 4096): "
          f"{graph_ms(lambda: C.nn_bidir(src, pcs)):.5f} ms", flush=True)
    a = x["cano"][:400].reshape(20, 20, 3)
    pq = a[:, None].expand(20, 20, 20, 3).reshape(400, 20, 3).contiguous()
    pr = a[None].expand(20, 20, 20, 3).reshape(400, 20, 3).contiguous()
    if not same(C.nn1_coords(pq, pr), C.nn1_coords_plain(pq, pr)):
        raise AssertionError("nn1_coords differs from the plain version")
    print(f"{card}: nn1_coords (400, 20, 20): "
          f"{graph_ms(lambda: C.nn1_coords(pq, pr), 100):.5f} ms",
          flush=True)


# ---------------------------------------------------------------------------
# part 2: the options
# ---------------------------------------------------------------------------

# name -> option sizes over ops._build.DEFINES
VARIANTS = {
    "as built": {},
    "2 queries a thread": {"REART_NN_QPT": 2},
    "8 queries a thread": {"REART_NN_QPT": 8},
    "ball_query V=1": {"REART_BQ_V": 1},
    "ball_query V=2": {"REART_BQ_V": 2},
    "ball_query V=8": {"REART_BQ_V": 8},
}


def topk_launch(lib, qpt_built, q, r, k, force=None):
    """nn_topk through `lib`'s C entry point, as the wrapper launches it,
    for a library built with REART_NN_QPT = qpt_built; `force`, a (queries
    a thread, slices) pair, replaces the plan."""
    qf, rf, ref_div, batch = C._flatten_query_ref("nn_topk", q, r)
    qf, rf = qf.contiguous(), rf.contiguous()
    b, n, m = qf.shape[0], qf.shape[1], rf.shape[1]
    bf, nf = b // ref_div, n * ref_div
    qpt, slices = force or C.nn_topk_plan(
        bf, nf, m, k, _build.sm_count(qf.device), qpt_built)
    d = torch.empty((b, n, k), dtype=torch.float32, device=qf.device)
    i = torch.empty((b, n, k), dtype=torch.int64, device=qf.device)
    _build.check_launch("nn_topk", lib.reart_nn_topk(
        qf.data_ptr(), rf.data_ptr(), bf, nf, m, k, qpt, slices,
        d.data_ptr(), i.data_ptr(), _build.stream_of(qf)))
    return d.reshape(batch + (n, k)), i.reshape(batch + (n, k))


def ball_launch(lib, rad, k, xyz, new, warps=None):
    b, n, s = xyz.shape[0], xyz.shape[1], new.shape[1]
    out = torch.empty((b, s, k), dtype=torch.int64, device=xyz.device)
    warps = warps or C.ball_query_warps(b, s, _build.sm_count(xyz.device))
    _build.check_launch("ball_query", lib.reart_ball_query(
        xyz.data_ptr(), new.data_ptr(), b, n, s, C.radius_sq(rad), k, warps,
        out.data_ptr(), _build.stream_of(xyz)))
    return out


def options(card, x):
    """Part 2: the variants, checked, then timed in turns."""
    topk = {k: v for k, v in topk_shapes(x).items()
            if "train" not in k and "flow" not in k}
    balls = ball_shapes(x)
    calls = {}   # (variant, label) -> fn
    libs = {name: (_build.load_library(d), {**_build.DEFINES, **d})
            for name, d in VARIANTS.items()}
    for name, (lib, defs) in libs.items():
        qb = defs["REART_NN_QPT"]
        for label, (q, r, k) in topk.items():
            calls[(name, "nn_topk " + label)] = (
                lambda lib=lib, qb=qb, q=q, r=r, k=k:
                topk_launch(lib, qb, q, r, k), plain_topk(q, r, k))
        for label, (rad, k, xyz, new) in balls.items():
            calls[(name, "ball_query " + label)] = (
                lambda lib=lib, rad=rad, k=k, xyz=xyz, new=new:
                ball_launch(lib, rad, k, xyz, new),
                (C.ball_query_plain(rad, k, xyz, new),))
    for (name, label), (fn, ref) in calls.items():
        got = fn()
        if not same(got if isinstance(got, tuple) else (got,), ref):
            raise AssertionError(f"{name}, {label}: differs from the plain "
                                 f"version")
    print(f"{card}: every variant equals the plain versions (indices and "
          f"distances)", flush=True)
    times = {key: [] for key in calls}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for (vname, label), (fn, _) in calls.items():
            if vname == name:
                times[(vname, label)].append(graph_ms(
                    fn, 5 if "table" in label else 50))
    for name in libs:
        print(f"{card}: {name}: " + "; ".join(
            f"{label} {t[0]:.5f}, {t[1]:.5f} ms"
            for (vname, label), t in times.items() if vname == name),
            flush=True)


def sweep(card, x):
    """Every (queries a thread, slices) of nn_topk and every block size of
    ball_query at each shape, with the library as built, each checked and
    timed once; the plans' choices are marked *."""
    lib = _build.load_library()
    sms = _build.sm_count(x["cano"].device)
    for label, (q, r, k) in topk_shapes(x).items():
        ref = plain_topk(q, r, k)
        qf, rf, ref_div, _ = C._flatten_query_ref("nn_topk", q, r)
        plan = C.nn_topk_plan(qf.shape[0] // ref_div, qf.shape[1] * ref_div,
                              rf.shape[1], k, sms)
        out = []
        for qpt in sorted({1, 2, C.NN_QPT}):
            for s in (1, 2, 4, 8, 16):
                fn = (lambda qpt=qpt, s=s:
                      topk_launch(lib, C.NN_QPT, q, r, k, force=(qpt, s)))
                if not same(fn(), ref):
                    raise AssertionError(f"nn_topk {label} ({qpt}, {s})")
                mark = "*" if (qpt, s) == plan else ""
                ms = graph_ms(fn, 5 if "table" in label else 20)
                out.append(f"({qpt}, {s}){mark} {ms:.5f}")
        print(f"{card}: sweep nn_topk {label}: " + "; ".join(out),
              flush=True)
    for label, (rad, k, xyz, new) in ball_shapes(x).items():
        ref = C.ball_query_plain(rad, k, xyz, new)
        plan = C.ball_query_warps(xyz.shape[0], new.shape[1], sms)
        out = []
        for w in range(C.BQ_MIN_WARPS, C.BQ_MAX_WARPS + 1):
            fn = lambda w=w: ball_launch(lib, rad, k, xyz, new, w)  # noqa
            if not torch.equal(fn(), ref):
                raise AssertionError(f"ball_query {label} W={w}")
            mark = "*" if w == plan else ""
            out.append(f"W={w}{mark} {graph_ms(fn, 50):.5f}")
        print(f"{card}: sweep ball_query {label}: " + "; ".join(out),
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--wrappers_only", action="store_true",
                        help="part 1 only (another checkout's wrappers)")
    parser.add_argument("--sweep", action="store_true",
                        help="also every runtime choice at every shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_nn: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    x = clouds(dev)
    wrappers(card, x)
    if not args.wrappers_only:
        options(card, x)
    if args.sweep:
        sweep(card, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the neighbour kernels nn_bidir, nn1_coords, nn_topk and ball_query
on the card.

    python -m reart_tpu_torch.bench_nn [--sweep]
    PYTHONPATH=<a checkout> python <this file> --wrappers_only

Part 1, the wrappers: `ops.cuda_nn.nn_bidir` at the Chamfer metric's frame
stacks (the robot runs' 9, the sapien runs' 7 and the real runs' 5 frames
of 4096 points, as chip_smoke.py's full-width runs call it);
`nn1_coords` at the graph stage's (P^2, 20, 20) for P = 20 and the P = 6, 5
and 4 of those runs, and at (9, 4096, 4096); beside them, in the same
harness, an empty
kernel (the launch floor; a checkout without one prints "not built");
`nn_topk` at every shape the paths launch (the seg-refinement table, 20
candidate clouds a frame against their frame, k=1; (9, 4096, 4096) at k=1
and k=3; one 4096-point cloud against itself at k=8; IK's label transfer,
6 points against 4096; the backbone's four 3-NN shapes), `ball_query` at
SA1 r=0.2 K=128 of the nine flow clouds and a training batch's five
groupings, and, as a control that shares none of their code,
`nn1_bidir_coords` at (9, 4096, 4096). Each output is checked against its
plain version (indices, coordinates and distances exact), then timed on
the device: a CUDA graph of many calls replayed between two CUDA events,
the median of 5 (ms a call), beside its bound (`bound`: the card's peaks;
ball_query's depends on the data, chip_smoke.py phase 3 reckons it). Only
public wrappers are called, so with
PYTHONPATH set to another checkout and --wrappers_only the same file times
that checkout's kernels.

Part 2, the options: variants of the kernel library with one option size of
`ops._build.DEFINES` changed each (REART_NN_QPT, the queries an nn_topk
thread carries; REART_BQ_V, the points a ball_query lane looks at per
step), each into its own file under reart_tpu_torch/_build/; every variant is checked against
the plain versions, then each is timed twice, in the order A B ... B A on
one card.

With --sweep, then: every (warps, run, blocks) of nn_bidir, every warps a
block of nn1_coords' packed route, every (queries a thread, slices) of
nn_topk and every block size of ball_query at each shape, the library as
built, each checked and timed once (how `nn_bidir_plan`,
`nn1_coords_plan`, `nn_topk_plan` and `ball_query_warps` were chosen; each
line names the fastest choice and the plan's distance from it).

Prints one line a shape or variant with the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
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


# published peaks of one H100 SXM at its full 700 W: float32 outside the
# tensor cores, and device memory (chip_smoke.py's bounds use these too)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# one squared distance: 3 subtractions, 3 products, 2 additions
PAIR_FLOPS = 8


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


def bound_text(pairs, tensors):
    """`bound` of `pairs` (query, reference) pairs, as a line's words."""
    b = bound(PAIR_FLOPS * pairs, tensors)
    return f"bound {b['bound_ms']:.7f} ms by {b['bound_by']}"


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
    stacks = {t: tuple((cano + 0.01 * randn(t, 4096, 3)).contiguous()
                       for _ in range(2)) for t in (7, 5)}
    pairs = {}
    for p in (20, 6, 5, 4):
        a = cano[:p * 20].reshape(p, 20, 3)
        pairs[p] = (a[:, None].expand(p, p, 20, 3).reshape(p * p, 20, 3)
                    .contiguous(),
                    a[None].expand(p, p, 20, 3).reshape(p * p, 20, 3)
                    .contiguous())
    return dict(cano=cano, pcs=pcs, src=src, table=table, levels=levels,
                stacks=stacks, pairs=pairs)


def bidir_shapes(x):
    """label -> (src, tgt) of nn_bidir: the frame stacks of the paths."""
    shapes = {"(9, 4096, 4096)": (x["src"], x["pcs"])}
    shapes.update({f"({t}, 4096, 4096)": x["stacks"][t] for t in (7, 5)})
    return shapes


def coords_shapes(x):
    """label -> (query, ref) of nn1_coords: the graph stage's part pairs,
    and one cloud-scale batch (the topk route)."""
    shapes = {f"({p * p}, 20, 20)": x["pairs"][p] for p in (20, 6, 5, 4)}
    shapes["(9, 4096, 4096)"] = (x["src"], x["pcs"])
    return shapes


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
        out = C.nn_topk(q, r, k)
        if not same(out, plain_topk(q, r, k)):
            raise AssertionError(f"nn_topk {label}: differs from the plain "
                                 f"version")
        ms = graph_ms(lambda: C.nn_topk(q, r, k),
                      5 if "table" in label else 50)
        pairs = q.numel() // 3 * r.shape[-2]
        print(f"{card}: nn_topk {label}: {ms:.5f} ms; "
              f"{bound_text(pairs, (q, r, *out))}", flush=True)
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
    for label, (a, b) in bidir_shapes(x).items():
        out = C.nn_bidir(a, b)
        if not same(out, C.nn_bidir_plain(a, b)):
            raise AssertionError(f"nn_bidir {label}: differs from the plain "
                                 f"version")
        pairs = a.shape[0] * a.shape[1] * b.shape[1]
        print(f"{card}: nn_bidir {label}: "
              f"{graph_ms(lambda: C.nn_bidir(a, b)):.5f} ms; "
              f"{bound_text(pairs, (a, b, *out))}", flush=True)
    for label, (q, r) in coords_shapes(x).items():
        out = C.nn1_coords(q, r)
        if not same(out, C.nn1_coords_plain(q, r)):
            raise AssertionError(f"nn1_coords {label}: differs from the "
                                 f"plain version")
        ms = graph_ms(lambda: C.nn1_coords(q, r),
                      100 if q.shape[1] <= 32 else 20)
        pairs = q.shape[0] * q.shape[1] * r.shape[1]
        print(f"{card}: nn1_coords {label}: {ms:.5f} ms; "
              f"{bound_text(pairs, (q, r, *out))}", flush=True)
    lib = _build.load_library()
    empty = getattr(lib, "reart_empty_kernel", None)
    if empty is None:
        print(f"{card}: empty kernel: not built in this checkout", flush=True)
    else:
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int

        def launch_empty():  # on the current stream: the capture's too
            _build.check_launch("empty kernel", empty(
                torch.cuda.current_stream().cuda_stream))

        print(f"{card}: empty kernel (the launch floor): "
              f"{graph_ms(launch_empty, 100):.5f} ms", flush=True)
    src, pcs = x["src"], x["pcs"]
    if not same(C.nn1_bidir_coords(src, pcs),
                C.nn1_bidir_coords_plain(src, pcs)):
        raise AssertionError("nn1_bidir_coords differs from the plain "
                             "version")
    print(f"{card}: nn1_bidir_coords (9, 4096, 4096), control: "
          f"{graph_ms(lambda: C.nn1_bidir_coords(src, pcs)):.5f} ms",
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


def bidir_launch(lib, a, b, force=None):
    """nn_bidir through `lib`'s C entry point, as the wrapper launches it;
    `force`, a (warps, run, blocks) triple, replaces the plan."""
    n_b, n, m = a.shape[0], a.shape[1], b.shape[1]
    warps, run, blocks = force or C.nn_bidir_plan(
        n_b, n, m, _build.sm_count(a.device))
    f32 = dict(dtype=torch.float32, device=a.device)
    i64 = dict(dtype=torch.int64, device=a.device)
    fd, fi = torch.empty((n_b, n), **f32), torch.empty((n_b, n), **i64)
    bd, bi = torch.empty((n_b, m), **f32), torch.empty((n_b, m), **i64)
    fkey, bkey = torch.empty((n_b, n), **i64), torch.empty((n_b, m), **i64)
    _build.check_launch("nn_bidir", lib.reart_nn_bidir(
        a.data_ptr(), b.data_ptr(), n_b, n, m, warps, run, blocks,
        fd.data_ptr(), fi.data_ptr(), bd.data_ptr(), bi.data_ptr(),
        fkey.data_ptr(), bkey.data_ptr(), _build.stream_of(a)))
    return fd, fi, bd, bi


def coords_launch(lib, q, r, plan):
    """nn1_coords through `lib`'s C entry point with the route `plan`."""
    b, n = q.shape[0], q.shape[1]
    d = torch.empty((b, n), dtype=torch.float32, device=q.device)
    i = torch.empty((b, n), dtype=torch.int64, device=q.device)
    c = torch.empty((b, n, 3), dtype=torch.float32, device=q.device)
    _build.check_launch("nn1_coords", lib.reart_nn1_coords(
        q.data_ptr(), r.data_ptr(), b, n, r.shape[1], int(plan[0] == "topk"),
        plan[1], plan[2], d.data_ptr(), i.data_ptr(), c.data_ptr(),
        _build.stream_of(q)))
    return d, i, c


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

    def report(what, label, plan, timed):
        """timed: [(choice, ms)]; the plan's choice is marked *."""
        fastest = min(timed, key=lambda t: t[1])
        mine = dict(timed)[plan]
        print(f"{card}: sweep {what} {label}: " + "; ".join(
            f"{c}{'*' if c == plan else ''} {ms:.5f}" for c, ms in timed)
            + f"; fastest {fastest[0]}, the plan "
            f"{100 * (mine / fastest[1] - 1):.1f}% slower", flush=True)

    for label, (a, b) in bidir_shapes(x).items():
        ref = C.nn_bidir_plain(a, b)
        plan = C.nn_bidir_plan(a.shape[0], a.shape[1], b.shape[1], sms)
        timed = []
        units = C.nn_bidir_units(a.shape[0], a.shape[1], b.shape[1], 8, 16)
        for choice in sorted({plan} | {(w, run, g) for w in (4, 8)
                                       for run in (8, 16)
                                       for g in (sms, 2 * sms, 3 * sms,
                                                 4 * sms, units)}):
            fn = (lambda choice=choice:
                  bidir_launch(lib, a, b, force=choice))
            if not same(fn(), ref):
                raise AssertionError(f"nn_bidir {label} {choice}")
            timed.append((choice, graph_ms(fn, 20)))
        report("nn_bidir", label, plan, timed)
    for label, (q, r) in coords_shapes(x).items():
        if q.shape[1] > C.NN1C_MAX_PACKED:
            continue
        ref = C.nn1_coords_plain(q, r)
        plan = C.nn1_coords_plan(q.shape[0], q.shape[1], r.shape[1], sms)
        timed = []
        for w in range(1, C.NN1C_MAX_WARPS + 1):
            choice = ("packed", plan[1], w)
            fn = lambda choice=choice: coords_launch(lib, q, r, choice)  # noqa
            if not same(fn(), ref):
                raise AssertionError(f"nn1_coords {label} {choice}")
            timed.append((choice, graph_ms(fn, 100)))
        report("nn1_coords", label, plan, timed)
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

"""The port's tracing (reart_tpu_torch/profiling.py) on the CPU: off means
off (no annotation, span, hook or counter, and the same numbers bit for
bit as with tracing on), the spans of the backbone's training and of the
fit under a CPU torch.profiler with their parents and their annotations'
times, `phase_timer`, and the LAP counters against the plain auction."""

import collections
import glob
import gzip
import json
import os
import pickle

import numpy as np
import pytest
import torch
from torch import profiler

from reart_tpu_torch import cli, profiling
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.models.base_model import BaseModel
from reart_tpu_torch.models.pointnet2 import PointNet2Msg2
from reart_tpu_torch.ops import assignment, cuda_auction
from reart_tpu_torch.train import corr, engine

torch.set_num_threads(1)

CORR_CFG = corr.CorrTrainConfig(n_points=128, batch=1, steps=1)
BLOCKS = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1", "head")
STEP_CHILDREN = ("corr.draws", "corr.synth", "corr.forward", "corr.loss",
                 "corr.backward", "corr.update")


def _frames():
    pcs = make_toy_robot_sample()["complete_pc_list"]
    return torch.as_tensor(pcs / np.linalg.norm(pcs, axis=-1).max(),
                           dtype=torch.float32)


def _corr_step():
    """One `_train_step` from fixed weights and draws -> (loss, gradients,
    weights and running statistics)."""
    frames = _frames()
    model = PointNet2Msg2(64, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=CORR_CFG.lr)
    draws = corr.draw_pairs(torch.Generator().manual_seed(1),
                            frames.shape[0], frames.shape[1], CORR_CFG)
    src, tgt, gt_pos, scale = corr.synth_pair(draws, frames, CORR_CFG)
    loss = corr._train_step(model, opt, CORR_CFG, src, tgt, gt_pos, scale)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def corr_steps(tmp_path_factory):
    """The same training step with tracing off (no span, annotation, hook
    or counter allowed) and under a CPU torch.profiler, with what the
    traced one recorded: (off, on, spans.json, the trace's events)."""
    mp = pytest.MonkeyPatch()

    def refuse(*_a, **_k):
        raise AssertionError("tracing is off")

    with mp.context() as m:
        m.setattr(profiling, "_Span", refuse)
        m.setattr(torch.Tensor, "register_hook", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        profiling.reset()
        off = _corr_step()
        assert profiling.snapshot()["counters"] == {}
    log_dir = str(tmp_path_factory.mktemp("corr_trace"))
    with profiling.device_trace(log_dir, cuda=False):
        on = _corr_step()
    with open(os.path.join(log_dir, "spans.json")) as f:
        spans = json.load(f)
    [path] = glob.glob(os.path.join(log_dir, "*.pt.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return off, on, spans, events


def test_a_corr_step_is_bit_equal_with_tracing_on_and_off(corr_steps):
    (loss0, grads0, state0), (loss1, grads1, state1), _, _ = corr_steps
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys() and state0.keys() == state1.keys()
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    for k in state0:
        assert torch.equal(state0[k], state1[k]), k


def _tree(spans):
    names = {s["id"]: s["name"] for s in spans}
    return collections.Counter((s["name"], names.get(s["parent"]))
                               for s in spans)


def test_the_corr_step_spans_and_their_parents(corr_steps):
    _, _, spans, _ = corr_steps
    tree = _tree(spans["spans"])
    # 25 ConvBN layers: a forward `bn` under its block, a backward `bn`
    # under corr.backward (the span open when backward() was called)
    assert tree[("bn", "corr.backward")] == 25
    assert sum(v for (n, p), v in tree.items()
               if n == "bn" and p in BLOCKS) == 25
    assert {b: tree[(b, "corr.forward")] for b in BLOCKS} == dict.fromkeys(
        BLOCKS, 1)
    for name in ("corr.forward", "corr.loss", "corr.backward",
                 "corr.update"):
        assert tree[(name, None)] == 1, name
    assert sum(tree.values()) == 50 + 7 + 4


def test_every_span_carries_its_annotations_time(corr_steps):
    # the shared clock: each span's ts / dur is its own user_annotation's
    _, _, spans, events = corr_steps
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ann[e["name"]].append((e["ts"], e["dur"], e["tid"]))
    seen = collections.Counter()
    for s in spans["spans"]:
        k = seen[s["name"]]
        seen[s["name"]] += 1
        assert (s["ts"], s["dur"], s["thread"]) == sorted(
            ann[s["name"]])[k], s
    assert seen["bn"] == len(ann["bn"]) == 50


def test_the_corr_command_traces_its_training(robot_dir, tmp_path):
    """`corr --trace_dir`: the trace, and spans.json with the run, its step
    and the step's phases in order, and the step counter."""
    cat = os.path.basename(robot_dir.rstrip("/"))
    norm = str(tmp_path / "normalize.pkl")
    with open(norm, "wb") as f:
        pickle.dump({cat: {"centroid": np.zeros(3, np.float32),
                           "scale": 1.0}}, f)
    trace_dir = tmp_path / "trace"
    cli.main(["corr", "--device", "cpu", "--data_domain", "robot",
              "--seq_path", robot_dir, "--normalize_file", norm,
              "--num_points", "360", "--steps", "1", "--batch", "1",
              "--train_points", "128", "--save_path",
              str(tmp_path / "c.pkl"), "--trace_dir", str(trace_dir)])
    assert glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz"))
    with open(trace_dir / "spans.json") as f:
        spans = json.load(f)
    assert spans["counters"] == {"corr.steps": 1}
    tree = _tree(spans["spans"])
    assert tree[("corr.train", None)] == 1
    assert tree[("corr.step", "corr.train")] == 1
    assert tree[("corr.log", "corr.train")] == 1
    step = [s["id"] for s in spans["spans"] if s["name"] == "corr.step"]
    order = [s["name"] for s in spans["spans"] if s["parent"] == step[0]]
    assert order == list(STEP_CHILDREN)
    assert all(s["ts"] is not None for s in spans["spans"])


def test_phase_timer_fills_phase_report_and_nests_as_spans():
    profiling.reset_phases()
    with profiling.phase_timer("outer", verbose=False):
        pass
    with profiling.tracing():
        with profiling.phase_timer("outer", verbose=False):
            with profiling.phase_timer("inner", verbose=False):
                pass
        spans = profiling.snapshot()["spans"]
    report = profiling.phase_report()
    assert set(report) == {"outer", "inner"} and report["outer"] >= 0.0
    assert [(s["name"], s["parent"]) for s in spans] == [("outer", None),
                                                         ("inner", 0)]
    assert not profiling.enabled()


def _toy_fit():
    """20 iterations of the toy robot, a LAP every 2 of the last 10."""
    pcs = make_toy_robot_sample()["complete_pc_list"]
    cfg = engine.FitConfig(n_iter=20, assign_iter=10, use_assign_loss=True,
                           assign_gap=2, downsample=2)
    model = BaseModel(5, pcs.shape[0] - 1, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    _, hist = engine.fit_base(model, cfg, pcs[0], pcs[1:], device="cpu")
    return hist, {k: v.clone() for k, v in model.state_dict().items()}


def test_a_fit_is_bit_equal_with_tracing_on_and_off_and_counts_its_work():
    hist0, state0 = _toy_fit()
    profiling.reset()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]):
        hist1, state1 = _toy_fit()
        snap = profiling.snapshot()
    for k in hist0:
        assert torch.equal(hist0[k], hist1[k]), k
    for k in state0:
        assert torch.equal(state0[k], state1[k]), k
    tree = _tree(snap["spans"])
    assert tree[("fit.iteration", None)] == 20
    for child in ("fit.forward", "fit.loss", "fit.backward", "fit.update"):
        assert tree[(child, "fit.iteration")] == 20, child
    # a LAP every 2 iterations of the 10 assignment ones, each solved by
    # the resident route on the CPU (180 rows)
    assert tree[("fit.lap", None)] == 5
    for child in ("fit.lap.forward", "fit.lap.solve"):
        assert tree[(child, "fit.lap")] == 5, child
    assert snap["counters"]["fit.iterations"] == 20
    assert snap["counters"]["lap.solves.resident"] == 5
    assert "lap.rows_at_bound" in snap["counters"]


def _plain(cost, sweeps, num_scales):
    """The plain auction's stats and unassigned rows at the bound."""
    benefit = -cost
    eps = [1e-4 * 50.0 ** k for k in range(num_scales - 1, -1, -1)]
    r2c, _, stats = cuda_auction.auction_solve_resident_plain(
        benefit, torch.zeros(cost.shape[0], cost.shape[2]), eps, sweeps,
        return_stats=True)
    return int(stats[..., 0].sum()), int((r2c < 0).sum())


@pytest.mark.parametrize("shape,use_resident,route", [
    ((2, 40, 50), False, "sweeps"),
    ((1, 1025, 1025), None, "hbm"),
])
def test_the_lap_counters_match_the_plain_auction(shape, use_resident,
                                                  route):
    cost = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    sweeps, at_bound = _plain(cost, 2, 2)
    assert at_bound > 0  # the bound stops it short
    with profiling.tracing():
        assignment.auction_lap(cost, eps_min=1e-4, num_scales=2,
                               scale_factor=50.0, max_sweeps=2,
                               use_resident=use_resident)
        counters = profiling.snapshot()["counters"]
    assert counters == {f"lap.solves.{route}": 1, "lap.sweeps": sweeps,
                        "lap.rows_at_bound": at_bound}


def test_the_banded_solve_counts_its_sweeps():
    g = torch.Generator().manual_seed(4)
    src, tgt = torch.rand((2, 256, 3), generator=g), torch.rand(
        (2, 256, 3), generator=g)
    with profiling.tracing():
        assignment.auction_lap_points(src, tgt, band=128, max_sweeps=3)
        counters = profiling.snapshot()["counters"]
    s_src, s_tgt, _, _ = assignment._curve_sort(src, tgt, 128, None)
    _, _, stats = cuda_auction.auction_solve_banded_plain(
        s_src, s_tgt, torch.zeros(2, 256), (5e-3, 1e-4), 3, 128,
        return_stats=True)
    assert counters == {"lap.solves.banded": 1,
                        "lap.sweeps": int(stats[..., 0].sum())}


def test_off_the_lap_asks_for_no_stats(monkeypatch):
    seen = []
    solve = cuda_auction.auction_solve_resident_hbm

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return solve(*args, **kwargs)

    monkeypatch.setattr(assignment, "auction_solve_resident_hbm", spy)
    profiling.reset()
    cost = torch.rand((1, 1025, 1025), generator=torch.Generator())
    assignment.auction_lap(cost, num_scales=1, max_sweeps=1)
    assert seen == [{}] and profiling.snapshot()["counters"] == {}

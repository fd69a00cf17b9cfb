"""Mid-fit snapshots and the fit's trace in the port, on the CPU.

Both snapshot rows against reart_tpu's on the same labels and poses (a
robot and a sapien sample): the same keys, part counts and edges exactly,
floats within rtol 1e-5 (the selection energy's bar in
tests/test_torch_selection.py). A fit with snapshots equals the same fit
without them bit for bit, parameters and history; result.txt lists the
rows; a row that fails is raised by `finish()`; `--trace_dir` writes a
trace file.
"""

import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reart_tpu import cli as jcli
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu_torch import cli
from reart_tpu_torch.data.sapien import SapienDataset
from reart_tpu_torch.data.synth import make_sapien_scene, make_toy_robot_sample

torch.set_num_threads(1)


def _perturbed(sample, seed, n_cols=5):
    """Labels and poses as a fit leaves them: GT parts over n_cols pose
    columns, some points on a wrong part, a few on a label of their own,
    every pose a little off (tests/test_torch_selection.py's)."""
    rng = np.random.RandomState(seed)
    gt = sample["gt_cano_part"]
    cols = rng.permutation(n_cols)
    seg = cols[gt]
    wrong = rng.choice(len(seg), 25, replace=False)
    seg[wrong] = cols[rng.randint(0, 3, 25)]
    seg[rng.choice(len(seg), 5, replace=False)] = cols[3]
    t = sample["pc_list"].shape[0]
    trans = np.tile(np.eye(4, dtype=np.float32), (t, n_cols, 1, 1))
    trans[:, cols[:3]] = sample["gt_pose_list"][1:]
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(t * n_cols, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(t * n_cols, 3).astype(np.float32))))
    return seg, (noise.reshape(t, n_cols, 4, 4) @ trans).astype(np.float32)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = make_sapien_scene(str(tmp_path_factory.mktemp("snap_sapien")),
                             n_views=4, n_points=300, n_parts=3)
    sapien = SapienDataset(root)[0]
    return {"robot": make_toy_robot_sample(), "sapien": sapien}


CASES = [("robot", 0), ("robot", 1), ("sapien", 0), ("sapien", 2)]


def _close(got, ref):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, (list, int)):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("domain, seed", CASES)
def test_snapshot_metrics_row_matches_jax(samples, domain, seed):
    sample = samples[domain]
    seg, trans = _perturbed(sample, seed)
    ref = jcli.snapshot_metrics_row(domain, sample, 0, seg, trans)
    got = cli.snapshot_metrics_row(domain, sample, 0, seg,
                                   torch.from_numpy(trans))
    _close(got, ref)


@pytest.mark.parametrize("domain, seed", CASES)
def test_snapshot_graph_row_matches_jax(samples, domain, seed):
    sample = samples[domain]
    seg, trans = _perturbed(sample, seed)
    jargs = jcli.build_parser().parse_args([domain])
    args = cli.build_parser().parse_args([domain])
    ref = jcli.snapshot_graph_row(jargs, domain, sample, seg, trans)
    got = cli.snapshot_graph_row(args, domain, sample, seg,
                                 torch.from_numpy(trans))
    assert ref["parts"] > 1
    _close(got, ref)


ROBOT_RUN = ("--n_iter 300 --assign_iter 200 --num_parts 5 --start_tau 2 "
             "--end_tau 0.5 --use_flow_loss --flow_provider gt "
             "--use_assign_loss --snapshot_gap 100 --silence")


def test_fit_with_snapshots_equals_fit_without():
    """engine.fit with the evaluator's callback: the same parameters and
    history, bit for bit, as without it; one row a crossed multiple."""
    from reart_tpu_torch.models.base_model import BaseModel
    from reart_tpu_torch.train import fit_base

    sample = make_toy_robot_sample()
    args = cli.build_parser().parse_args(["robot", *ROBOT_RUN.split()])
    cfg = cli.fit_config(args)
    n, p = sample["cano_pc"].shape[0], args.num_parts
    cano = torch.from_numpy(sample["cano_pc"])

    def noise(it):
        return np.random.RandomState(it).gumbel(size=(n, p)).astype(
            np.float32)

    def run(evaluator=None):
        model = BaseModel(p, 3, device="cpu",
                          generator=torch.Generator().manual_seed(2))
        kw = {} if evaluator is None else dict(
            snapshot_cb=evaluator.callback, snapshot_every=100)
        return fit_base(model, cfg, sample["cano_pc"], sample["pc_list"],
                        noise=noise, device="cpu", **kw)

    snap = cli.SnapshotEvaluator(
        "robot", sample, 0,
        lambda m: cli._final_forward(m, None, cano, (n, p)),
        graph_args=args, device="cpu")
    m_snap, h_snap = run(snap)
    rows = snap.finish()
    m_ref, h_ref = run()
    for (k, v), w in zip(m_ref.state_dict().items(),
                         m_snap.state_dict().values()):
        assert torch.equal(v, w), k
    for k in h_ref:
        assert torch.equal(h_ref[k], h_snap[k]), k
    assert [r.split(" |")[0] for r in rows] == ["snapshot 100",
                                                "snapshot 200"]
    assert "total_err" in rows[0] and "seg_ri" in rows[0]


def test_result_txt_lists_the_snapshot_rows(tmp_path):
    sample = make_toy_robot_sample()
    args = cli.build_parser().parse_args(
        ["robot", "--device", "cpu", *ROBOT_RUN.split(), "--snapshot_metrics"])
    cli.run_sample(args, "robot", sample, str(tmp_path / "toy"), device="cpu")
    txt = open(tmp_path / "toy" / "result.txt").read().splitlines()
    at = txt.index("# mid-fit snapshots (--snapshot_metrics)")
    assert txt[at - 1] == "" and txt[at - 2].startswith("total_err")
    rows = txt[at + 1:]
    assert [r.split(" |")[0] for r in rows] == ["snapshot 100",
                                                "snapshot 200"]
    assert all("cd_err" in r and "total_err" not in r for r in rows)


def test_a_failing_row_raises_from_finish():
    sample = make_toy_robot_sample()

    def broken(_model):
        raise RuntimeError("no forward")

    snap = cli.SnapshotEvaluator("robot", sample, 0, broken, device="cpu")
    snap.callback(5, torch.nn.Linear(2, 2))
    snap.callback(10, torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="no forward"):
        snap.finish()


def test_trace_dir_writes_a_trace(tmp_path):
    """`--trace_dir` on the CPU: a gzipped Chrome trace of the fit, host
    activity only, naming the fit's operators."""
    sample = make_toy_robot_sample()
    trace_dir = tmp_path / "trace"
    args = cli.build_parser().parse_args(
        ["robot", "--device", "cpu", "--n_iter", "20", "--assign_iter", "10",
         "--num_parts", "5", "--use_assign_loss", "--silence", "--trace_dir",
         str(trace_dir)])
    cli.run_sample(args, "robot", sample, str(tmp_path / "toy"), device="cpu")
    [path] = glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::bmm" in names or "aten::mm" in names
    assert not any(e.get("cat") == "kernel" for e in events)

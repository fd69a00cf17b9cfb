"""The slice as a whole on the CPU: `finalize` of both packages on the same
sample, labels and poses; the port's command line on the toy robot
sequence; and the result files read across the two packages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import checkpoint as jax_ckpt
from reart_tpu import cli as jax_cli
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu.models.base_model import base_forward as jax_base_forward
from reart_tpu.models.base_model import init_base_params
from reart_tpu_torch import checkpoint as ckpt
from reart_tpu_torch import cli
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.interop import base_params_from_jax
from reart_tpu_torch.models.base_model import base_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_txt(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (line.split(": ") for line in f.read().splitlines() if line)}


def _perturbed_fit(sample, seed):
    """Labels and poses as a fit leaves them: GT parts scattered over 5
    pose columns, some points on a wrong part, a handful on a label of
    their own, every pose a little off."""
    rng = np.random.RandomState(seed)
    gt = sample["gt_cano_part"]
    cols = rng.permutation(5)
    seg = cols[gt]
    wrong = rng.choice(len(seg), 25, replace=False)
    seg[wrong] = cols[rng.randint(0, 3, 25)]
    seg[rng.choice(len(seg), 5, replace=False)] = cols[3]
    trans = np.tile(np.eye(4, dtype=np.float32), (3, 5, 1, 1))
    trans[:, cols[:3]] = sample["gt_pose_list"][1:]
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(15, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(15, 3).astype(np.float32))))
    return seg, (noise.reshape(3, 5, 4, 4) @ trans).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_finalize_matches_jax(robot_dir, tmp_path, seed):
    common = ["robot", "--seq_path", robot_dir, "--num_points", "360",
              "--num_parts", "5", "--seg_refine", "2"]
    jargs = jax_cli.build_parser().parse_args(common)
    targs = cli.build_parser().parse_args(common + ["--device", "cpu",
                                                    "--silence"])
    jdataset = jax_cli.load_dataset(jargs, "robot")
    jsample, tsample = jdataset[0], cli.load_dataset(targs)[0]
    for k in jsample:  # the port's loader is a copy: the same sample
        np.testing.assert_array_equal(tsample[k], jsample[k])
    seg, trans = _perturbed_fit(jsample, seed)
    params = jax.tree.map(np.asarray,
                          init_base_params(jax.random.PRNGKey(0), 5, 3))

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jres = jax_cli.finalize(jargs, "robot", jdataset, jsample, seg.copy(),
                            trans.copy(), params, None, jdir, 1.0)
    tres = cli.finalize(targs, "robot", tsample, seg.copy(), trans.copy(),
                        base_params_from_jax(params, device="cpu"), None,
                        tdir, 1.0, device="cpu")
    jtxt = _read_txt(os.path.join(jdir, "result.txt"))
    ttxt = _read_txt(os.path.join(tdir, "result.txt"))
    assert list(ttxt) == list(jtxt) == list(tres)
    for k in ("seg_ri", "ted", "retarget_err"):
        assert tres[k] == jres[k], k
    for k in jres:
        # float32 metrics of the same labels and poses: rtol 1e-3; the
        # screw energy is a small cost of near-exact screws: atol 1e-4
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    jpk = jax_ckpt.load_result(os.path.join(jdir, "result.pkl"))
    tpk = ckpt.load_result(os.path.join(tdir, "result.pkl"))
    assert tpk["joint_connection"] == jpk["joint_connection"]
    np.testing.assert_array_equal(tpk["pred_cano_part"],
                                  jpk["pred_cano_part"])
    np.testing.assert_array_equal(tpk["pred_pose_list"],
                                  jpk["pred_pose_list"])
    assert tpk["cano_idx"] == jpk["cano_idx"] == 0
    assert len(np.unique(tpk["pred_cano_part"])) == 3


def test_result_files_load_in_the_other_package(tmp_path):
    sample = make_toy_robot_sample()
    seg, trans = sample["gt_cano_part"], sample["gt_pose_list"][1:]
    edges = [[1, 0], [2, 0]]
    tpath, jpath = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    ckpt.save_result(tpath, torch.from_numpy(seg), torch.from_numpy(trans),
                     0, edges, sample)
    jax_ckpt.save_result(jpath, jnp.asarray(seg), jnp.asarray(trans), 0,
                         edges, sample)
    for load in (jax_ckpt.load_result, ckpt.load_result):
        a, b = load(tpath), load(jpath)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert type(b[k]) is np.ndarray
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k

    # the model checkpoint: the JAX package's parameter layout
    model = base_params_from_jax(
        jax.tree.map(np.asarray, init_base_params(jax.random.PRNGKey(1), 4,
                                                  3)), device="cpu")
    cpath = str(tmp_path / "model.ckpt.pkl")
    ckpt.save_checkpoint(cpath, model, 0.5, 2)
    payload = jax_ckpt.load_checkpoint(cpath)
    assert payload["tau"] == 0.5 and payload["cano_idx"] == 2
    cano = np.random.RandomState(0).randn(40, 3).astype(np.float32)
    _, seg_j, trans_j = jax_base_forward(
        jax.tree.map(jnp.asarray, payload["state_dict"]), jnp.asarray(cano),
        jax.random.PRNGKey(0), 1.0)
    back = ckpt.base_model_from_checkpoint(ckpt.load_checkpoint(cpath),
                                           device="cpu")
    with torch.no_grad():
        _, seg_t, trans_t = base_forward(back, torch.from_numpy(cano),
                                         torch.zeros(40, 4), 1.0)
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_allclose(trans_t.numpy(), np.asarray(trans_j),
                               rtol=1e-6, atol=1e-7)


def test_command_line_on_the_toy_robot(robot_dir, tmp_path):
    save_root = str(tmp_path / "exp")
    results = cli.main([
        "robot", "--device", "cpu", "--seq_path", robot_dir, "--save_root",
        save_root, "--num_points", "360", "--use_flow_loss",
        "--flow_provider", "gt", "--use_assign_loss", "--n_iter", "600",
        "--assign_iter", "400", "--num_parts", "5", "--start_tau", "2",
        "--end_tau", "0.5", "--silence"])
    seq_dir = os.path.join(save_root, os.path.basename(robot_dir))
    for name in ("result.txt", "result.pkl", "model.ckpt.pkl"):
        assert os.path.exists(os.path.join(seq_dir, name)), name
    txt = _read_txt(os.path.join(seq_dir, "result.txt"))
    assert list(txt) == ["flow_epe", "flow_acc5", "flow_acc10", "flow_angle",
                         "seg_ri", "recon_err", "cd_err", "retarget_err",
                         "ted", "ass_err", "screw_err", "group_err",
                         "total_err"]
    assert all(np.isfinite(v) for v in txt.values())
    # the healthy bar of a 3-part toy
    assert txt["seg_ri"] > 0.9 and txt["ted"] == 0.0, txt
    assert txt["flow_epe"] < 2.0, txt
    assert results["seg_ri"] == pytest.approx(txt["seg_ri"], abs=1e-3)
    result = jax_ckpt.load_result(os.path.join(seq_dir, "result.pkl"))
    n_parts = int(result["pred_cano_part"].max()) + 1
    assert n_parts == 3
    assert result["pred_pose_list"].shape == (3, n_parts, 4, 4)
    assert len(result["joint_connection"]) == n_parts - 1


def test_run_in_memory_matches_run_from_disk(robot_dir, tmp_path):
    """The toy made in memory is the sequence of the `robot_dir` fixture:
    the same sample, GT edges in place of graph.gpickle."""
    args = cli.build_parser().parse_args(
        ["robot", "--seq_path", robot_dir, "--num_points", "360"])
    disk = cli.load_dataset(args)[0]
    mem = make_toy_robot_sample()
    for k in disk:
        if k == "gt_pose_list":  # ordered by a set of part ids on disk
            continue
        np.testing.assert_allclose(mem[k], disk[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    from reart_tpu_torch.data.common import load_gt_graph

    _, edges = load_gt_graph(robot_dir)
    assert sorted(edges) == sorted(mem["gt_edges"])


def test_parts_not_ported_yet_say_so(tmp_path):
    sample = make_toy_robot_sample()
    base = ["robot", "--device", "cpu", "--save_root", str(tmp_path)]
    args = cli.build_parser().parse_args(base + ["--model", "kinematic"])
    with pytest.raises(NotImplementedError, match="2b"):
        cli.run_sample(args, "robot", sample, str(tmp_path), device="cpu")
    args = cli.build_parser().parse_args(base + ["--use_flow_loss"])
    with pytest.raises(NotImplementedError, match="slice 3"):
        cli.setup_flow(args, sample, "cpu")
    args = cli.build_parser().parse_args(base)
    assert cli.setup_flow(args, sample, "cpu") is None
    with pytest.raises(NotImplementedError, match="2b"):
        cli.finalize(args, "robot", sample, None, None, None, object(),
                     str(tmp_path), 1.0, device="cpu")
    with pytest.raises(NotImplementedError):
        cli.finalize(args, "sapien", sample, None, None, None, None,
                     str(tmp_path), 1.0, device="cpu")
    cfg = cli.fit_config(cli.build_parser().parse_args(
        base + ["--n_iter", "7", "--assign_sweeps", "9"]))
    assert (cfg.n_iter, cfg.assign_sweeps, cfg.always_recon) == (7, 9, False)


def test_command_line_imports_no_jax_and_defaults_to_the_card():
    code = (
        "import sys, reart_tpu_torch, reart_tpu_torch.cli; "
        "from reart_tpu_torch.__main__ import main; "
        "bad = [m for m in ('jax', 'reart_tpu', 'networkx') "
        "if m in sys.modules]; assert not bad, bad; "
        "args = reart_tpu_torch.cli.build_parser().parse_args(['robot']); "
        "assert args.device is None; "
        "import torch; torch.cuda.is_available = lambda: True; "
        "assert reart_tpu_torch.resolve_device(args.device).type == 'cuda'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # without a card the command line fails loudly; it does not fall back
    proc = subprocess.run(
        [sys.executable, "-m", "reart_tpu_torch", "robot", "--seq_path",
         "nowhere"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr

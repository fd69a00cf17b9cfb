"""The slice as a whole on the CPU: `finalize` of both packages on the same
sample, labels and poses, for a base model and for a kinematic model; the
kinematic model both packages build from one result.pkl; the port's command
line on the toy robot sequence, both stages; a fit that is killed and
resumed; and the result files and checkpoints read across the two
packages."""

import dataclasses
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
from reart_tpu.models.kinematic import kinematic_forward as jax_kin_forward
from reart_tpu_torch import checkpoint as ckpt
from reart_tpu_torch import cli
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.interop import (
    base_params_from_jax,
    kinematic_params_from_jax,
    kinematic_params_to_numpy,
)
from reart_tpu_torch.models.base_model import base_forward
from reart_tpu_torch.models.kinematic import kinematic_forward
from reart_tpu_torch.train import FitConfig, FlowContext, fit_kinematic

torch.set_num_threads(1)

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
    # result.pkl holds the dataset's sample, not the poses that ride
    # beside it for inverse kinematics
    sample = {k: v for k, v in make_toy_robot_sample().items()
              if k not in cli.IK_KEYS}
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
    with pytest.raises(ValueError, match="base_result_path"):
        cli.run_sample(args, "robot", sample, str(tmp_path), device="cpu")
    # the tree search is ported (slice 5a): at the JAX package's default
    # (-1, auto) and at K > 1 it needs the observed clouds; without them
    # the stored tree is built as it is
    assert args.tree_search == -1
    result = {"cano_idx": 0, "pred_cano_part": sample["gt_cano_part"],
              "pred_pose_list": sample["gt_pose_list"][1:],
              "joint_connection": [[1, 0], [2, 0]]}
    for ts in (-1, 8):
        args.tree_search = ts
        _, state = cli.build_kinematic_from_result(
            args, "robot", sample["cano_pc"], result, device="cpu")
        assert {tuple(sorted(e)) for e in state.edges} == {(0, 1), (0, 2)}
    # a torch-format (zip) checkpoint loads since slice 5b; one of another
    # canonical frame is refused
    from reart_tpu_torch.checkpoint import save_torch_base
    from reart_tpu_torch.models.base_model import BaseModel

    zipped = str(tmp_path / "model.pth.tar")
    save_torch_base(zipped, BaseModel(20, 3, device="cpu"), 1.0, 1)
    args = cli.build_parser().parse_args(base + ["--resume", zipped])
    with pytest.raises(ValueError, match="cano_idx"):
        cli.run_sample(args, "robot", sample, str(tmp_path), device="cpu")
    args = cli.build_parser().parse_args(base)
    assert cli.setup_flow(args, sample, "cpu") is None
    # --save_vis (slice 5c) is accepted in every domain and changes
    # nothing: every run writes the artifacts, as in the JAX package
    for domain in ("robot", "sapien", "real"):
        assert cli.build_parser().parse_args([domain, "--save_vis"]).save_vis
    written = {}
    for extra in ([], ["--save_vis"]):
        save_dir = str(tmp_path / f"vis{len(extra)}")
        cli.run_sample(cli.build_parser().parse_args(
            base + ["--n_iter", "2", "--num_parts", "5", "--silence"]
            + extra), "robot", sample, save_dir, device="cpu")
        written[len(extra)] = sorted(os.listdir(save_dir))
    assert written[0] == written[1]
    assert {"recon.gif", "seg.html", "structure.html"} <= set(written[1])
    cfg = cli.fit_config(cli.build_parser().parse_args(
        base + ["--n_iter", "7", "--assign_sweeps", "9"]))
    assert (cfg.n_iter, cfg.assign_sweeps, cfg.always_recon) == (7, 9, False)
    # the banded LAP's flags carry the JAX package's defaults
    jcfg = jax_cli.fit_config(jax_cli.build_parser().parse_args(["robot"]),
                              "robot")
    assert (cfg.assign_band, cfg.assign_band_guard, cfg.assign_band_reprobe) \
        == (jcfg.assign_band, jcfg.assign_band_guard,
            jcfg.assign_band_reprobe) == (-1, 0.05, 1000)
    # every domain's flags shared with the JAX package carry its defaults
    for domain in ("robot", "sapien", "real", "corr"):
        ours = vars(cli.build_parser().parse_args([domain]))
        theirs = vars(jax_cli.build_parser().parse_args([domain]))
        shared = sorted(set(ours) & set(theirs))
        assert len(shared) > 15
        assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
        if domain != "corr":
            tcfg = cli.fit_config(cli.build_parser().parse_args([domain]))
            jcfg = jax_cli.fit_config(
                jax_cli.build_parser().parse_args([domain]), domain)
            for f in dataclasses.fields(tcfg):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def _base_result(sample, seed=0):
    """A relaxation result as `finalize` leaves it: GT labels, GT poses a
    little off, the stored tree."""
    rng = np.random.RandomState(seed)
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(9, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(9, 3).astype(np.float32))))
    trans = (noise.reshape(3, 3, 4, 4) @ sample["gt_pose_list"][1:])
    return {"pred_cano_part": sample["gt_cano_part"],
            "pred_pose_list": trans.astype(np.float32), "cano_idx": 0,
            "joint_connection": [[1, 0], [2, 0]]}


def _kinematic_args(robot_dir, extra=()):
    common = ["robot", "--seq_path", robot_dir, "--num_points", "360",
              "--model", "kinematic", *extra]
    return (jax_cli.build_parser().parse_args(common),
            cli.build_parser().parse_args(common + [
                "--device", "cpu", "--silence", "--tree_search", "0"]))


@pytest.mark.parametrize("stored_tree", [True, False])
def test_build_kinematic_from_result_matches_jax(robot_dir, stored_tree):
    """One result.pkl through both packages: the same tree, edge order and
    initial parameters, with the stored tree and with the MST built here."""
    jargs, targs = _kinematic_args(robot_dir)
    jsample = jax_cli.load_dataset(jargs, "robot")[0]
    result = _base_result(jsample)
    if not stored_tree:
        result["joint_connection"] = []
    jparams, jstate = jax_cli.build_kinematic_from_result(
        jargs, "robot", jnp.asarray(jsample["cano_pc"]), result)
    tparams, tstate = cli.build_kinematic_from_result(
        targs, "robot", jsample["cano_pc"], result, device="cpu")
    assert tstate.edges == jstate.edges
    assert tstate.reverse_topo == jstate.reverse_topo
    assert tstate.edge_index == jstate.edge_index
    assert tstate.prismatic_mask is None and jstate.prismatic_mask is None
    np.testing.assert_array_equal(tstate.path_edges.numpy(),
                                  np.asarray(jstate.path_edges))
    np.testing.assert_array_equal(tstate.seg_part.numpy(),
                                  np.asarray(jstate.seg_part))
    tnp = kinematic_params_to_numpy(tparams)
    assert sorted(tnp) == sorted(jparams) == ["axis_list", "moment_list",
                                              "theta_list"]
    for k, v in tnp.items():
        # screws of float32 dual quaternions: rtol 1e-4, atol 1e-5
        np.testing.assert_allclose(v, np.asarray(jparams[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_finalize_with_a_kinematic_state_matches_jax(robot_dir, tmp_path):
    """Both `finalize`s on the same kinematic model: the same result.txt
    (seg_ri, ted and the tree exact, the rest rtol 1e-3, the retargeting
    error of 200 AMSGrad steps included), and each package restoring the
    checkpoint the other wrote."""
    jargs, targs = _kinematic_args(robot_dir)
    jdataset = jax_cli.load_dataset(jargs, "robot")
    jsample = jdataset[0]
    tsample = cli.dataset_sample(cli.load_dataset(targs))
    jparams, jstate = jax_cli.build_kinematic_from_result(
        jargs, "robot", jnp.asarray(jsample["cano_pc"]),
        _base_result(jsample))
    tparams, tstate = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")
    _, jseg, jtrans = jax_kin_forward(jparams, jstate,
                                      jnp.asarray(jsample["cano_pc"]))
    with torch.no_grad():
        _, tseg, ttrans = kinematic_forward(
            tparams, tstate, torch.from_numpy(jsample["cano_pc"]))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jres = jax_cli.finalize(jargs, "robot", jdataset, jsample,
                            np.asarray(jseg), np.asarray(jtrans), jparams,
                            jstate, jdir, 1.0)
    tres = cli.finalize(targs, "robot", tsample, tseg, ttrans, tparams,
                        tstate, tdir, 1.0, device="cpu")
    jtxt = _read_txt(os.path.join(jdir, "result.txt"))
    ttxt = _read_txt(os.path.join(tdir, "result.txt"))
    assert list(ttxt) == list(jtxt) == list(tres)
    for k in ("seg_ri", "ted"):
        assert tres[k] == jres[k], k
    assert 0.0 < tres["retarget_err"] < 5.0
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    jpk = jax_ckpt.load_result(os.path.join(jdir, "result.pkl"))
    tpk = ckpt.load_result(os.path.join(tdir, "result.pkl"))
    assert tpk.keys() == jpk.keys()
    assert tpk["joint_connection"] == jpk["joint_connection"] \
        == [list(e) for e in tstate.edges]
    np.testing.assert_array_equal(tpk["pred_cano_part"],
                                  jpk["pred_cano_part"])

    # the port's checkpoint in the JAX package, and the other way round
    cano = jnp.asarray(jsample["cano_pc"])
    payload = jax_ckpt.load_checkpoint(os.path.join(tdir, "model.ckpt.pkl"))
    back_state = jax_ckpt.restore_kinematic_state(payload)
    back_params = jax.tree.map(jnp.asarray, payload["state_dict"])
    assert back_state.edges == jstate.edges
    np.testing.assert_allclose(
        np.asarray(jax_kin_forward(back_params, back_state, cano)[0]),
        np.asarray(jax_kin_forward(jparams, jstate, cano)[0]), rtol=1e-6,
        atol=1e-6)
    model, state = ckpt.kinematic_model_from_checkpoint(
        ckpt.load_checkpoint(os.path.join(jdir, "model.ckpt.pkl")),
        device="cpu")
    assert state.edges == tstate.edges and state.num_parts == 3
    with torch.no_grad():
        again = kinematic_forward(model, state,
                                  torch.from_numpy(jsample["cano_pc"]))[2]
    np.testing.assert_allclose(again.numpy(), ttrans.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_two_stage_chain_on_the_toy_robot(robot_dir, tmp_path):
    """`--model base`, then `--model kinematic` from its result.pkl, through
    the command line: the healthy bar of the kinematic stage, a finite
    retargeting error, and a checkpoint the JAX package restores. Then
    `--resume --evaluate` from that checkpoint: the same numbers, no fit,
    no energy, no result.pkl (the artifacts only)."""
    root = str(tmp_path / "exp")
    common = ["robot", "--device", "cpu", "--seq_path", robot_dir,
              "--num_points", "360", "--use_flow_loss", "--flow_provider",
              "gt", "--use_assign_loss", "--num_parts", "5", "--silence"]
    cli.main(common + ["--save_root", root, "--n_iter", "600",
                       "--assign_iter", "400", "--start_tau", "2",
                       "--end_tau", "0.5"])
    seq = os.path.basename(robot_dir)
    kin_root = str(tmp_path / "kin")
    kinematic = common + [
        "--model", "kinematic", "--tree_search", "0", "--downsample", "2",
        "--assign_iter", "0", "--assign_gap", "1"]
    results = cli.main(kinematic + [
        "--save_root", kin_root, "--n_iter", "60", "--base_result_path",
        os.path.join(root, seq, "result.pkl")])
    kin_dir = os.path.join(kin_root, seq)
    txt = _read_txt(os.path.join(kin_dir, "result.txt"))
    assert list(txt) == list(results)
    assert txt["seg_ri"] > 0.9 and txt["ted"] == 0.0, txt
    assert txt["flow_epe"] < 2.0, txt
    assert np.isfinite(txt["retarget_err"]) and txt["retarget_err"] < 10.0
    assert not os.path.exists(os.path.join(kin_dir, "fit_state.pkl"))
    payload = jax_ckpt.load_checkpoint(os.path.join(kin_dir,
                                                    "model.ckpt.pkl"))
    state = jax_ckpt.restore_kinematic_state(payload)
    assert state.num_parts == 3 and len(state.edges) == 2
    assert sorted(payload["state_dict"]) == ["axis_list", "moment_list",
                                             "theta_list"]

    eval_root = str(tmp_path / "eval")
    again = cli.main(kinematic + [
        "--save_root", eval_root, "--evaluate", "--resume",
        os.path.join(kin_dir, "model.ckpt.pkl")])
    # no result.pkl or checkpoint; the artifacts, as in the JAX package
    assert sorted(os.listdir(os.path.join(eval_root, seq))) == [
        "gt.gif", "input.gif", "novel_0.html", "recon.gif", "result.txt",
        "seg.html", "structure.html"]
    assert "total_err" not in again and "ass_err" not in again
    for k, v in again.items():
        np.testing.assert_allclose(v, results[k], rtol=1e-5, err_msg=k)


def test_killed_fit_resumes_to_the_same_history(tmp_path, capsys):
    """A projection fit stopped after iteration 14 (its last save fell on
    the LAP boundary at 11) and called again with the same checkpoint_dir:
    the same history and parameters as a fit that was never stopped."""
    sample = make_toy_robot_sample()
    args = cli.build_parser().parse_args(
        ["robot", "--device", "cpu", "--tree_search", "0"])
    gt = sample["complete_gt_pc_list"]
    flow_ctx = FlowContext.from_lists(
        [gt[i] for i in range(3)], [gt[i + 1] - gt[i] for i in range(3)],
        device="cpu")
    cfg = FitConfig(n_iter=20, assign_iter=8, assign_gap=3, downsample=2,
                    use_flow_loss=True, use_assign_loss=True)

    def run(**kw):
        params, state = cli.build_kinematic_from_result(
            args, "robot", sample["cano_pc"], _base_result(sample),
            device="cpu")
        return fit_kinematic(params, state, cfg, sample["pc_list"],
                             flow_ctx=flow_ctx, device="cpu", **kw)

    ref_params, ref_hist = run()

    class Killed(Exception):
        pass

    def kill(done, _model):
        if done >= 14:
            raise Killed

    ckpt_dir = str(tmp_path / "fit")
    with pytest.raises(Killed):
        run(checkpoint_dir=ckpt_dir, checkpoint_every=5, snapshot_cb=kill,
            snapshot_every=1)
    assert os.listdir(ckpt_dir) == ["fit_state.pkl"]
    params, hist = run(checkpoint_dir=ckpt_dir, checkpoint_every=5,
                       log_every=10)
    out = capsys.readouterr().out
    assert "[fit] resuming from iteration 11" in out
    assert "iteration 19 | total_loss" in out
    assert os.listdir(ckpt_dir) == []  # the fit completed
    for k, v in ref_hist.items():
        np.testing.assert_array_equal(hist[k].numpy(), v.numpy(), err_msg=k)
    for (k, v), w in zip(ref_params.state_dict().items(),
                         params.state_dict().values()):
        np.testing.assert_array_equal(w.numpy(), v.numpy(), err_msg=k)


def test_command_line_imports_no_jax_and_defaults_to_the_card():
    code = (
        "import sys, reart_tpu_torch, reart_tpu_torch.cli; "
        "from reart_tpu_torch.__main__ import main; "
        "import reart_tpu_torch.ik, reart_tpu_torch.models.kinematic, "
        "reart_tpu_torch.graph.kinematics, reart_tpu_torch.flow, "
        "reart_tpu_torch.models.pointnet2, reart_tpu_torch.train.corr, "
        "reart_tpu_torch.interop, reart_tpu_torch.sapien_eval, "
        "reart_tpu_torch.data.sapien, reart_tpu_torch.data.real, "
        "reart_tpu_torch.data.mesh, reart_tpu_torch.selection; "
        "bad = [m for m in ('jax', 'optax', 'reart_tpu', 'networkx') "
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

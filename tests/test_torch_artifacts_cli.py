"""The artifacts on the command line, both packages on the CPU: the same
files in the same directories from `main` (relaxation, then projection,
with --save_vis and without), `finalize`'s seg.html and structure.html
byte for byte from the same labels and poses, an input.gif in each
directory of `--batch_seq`, and inverse kinematics' novel_<k>.html views
coloured by the forward's labels."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from reart_tpu import checkpoint as jax_ckpt
from reart_tpu import cli as jax_cli
from reart_tpu import ik as jax_ik
from reart_tpu.models import kinematic as jk
from reart_tpu.models.base_model import init_base_params
from reart_tpu.models.kinematic import kinematic_forward as jax_kin_forward
from reart_tpu_torch import cli, ik, viz
from reart_tpu_torch.data.synth import make_sapien_scene, make_toy_robot_sample
from reart_tpu_torch.interop import base_params_from_jax, kinematic_params_from_jax
from reart_tpu_torch.models.kinematic import kinematic_forward

torch.set_num_threads(1)

# what every relaxation run of a robot sequence with GT leaves
RELAXATION_FILES = ["gt.gif", "input.gif", "model.ckpt.pkl", "recon.gif",
                    "result.pkl", "result.txt", "seg.html", "structure.html"]


def _gt_result(sample):
    """A relaxation result.pkl's payload: GT labels, GT poses, the tree."""
    return {"pred_cano_part": sample["gt_cano_part"],
            "pred_pose_list": sample["gt_pose_list"][1:].astype(np.float32),
            "cano_idx": 0, "joint_connection": [[1, 0], [2, 0]]}


def _html_data(path):
    with open(path) as f:
        return json.loads(f.read().split("const DATA=")[1].split(";\n")[0])


def _gif_frames(path):
    with Image.open(path) as im:
        assert im.size == (viz.FRAME_PX, viz.FRAME_PX)
        assert im.info["loop"] == 0 and im.info["duration"] == 300
        return im.n_frames


@pytest.mark.parametrize("save_vis", [False, True])
def test_command_lines_write_the_jax_artifacts(robot_dir, tmp_path,
                                               save_vis):
    common = ["robot", "--seq_path", robot_dir, "--num_points", "360",
              "--num_parts", "5", "--use_flow_loss", "--flow_provider", "gt"]
    common += ["--save_vis"] if save_vis else []
    seq = os.path.basename(robot_dir)
    jsample = jax_cli.load_dataset(jax_cli.build_parser().parse_args(
        common), "robot")[0]
    stored = str(tmp_path / "gt_result.pkl")
    jax_ckpt.save_result(stored, jsample["gt_cano_part"],
                         _gt_result(jsample)["pred_pose_list"], 0,
                         [[1, 0], [2, 0]], jsample)
    stages = {
        "relaxation": ["--n_iter", "30", "--assign_iter", "1000"],
        "projection": ["--model", "kinematic", "--base_result_path", stored,
                       "--tree_search", "0", "--n_iter", "4",
                       "--assign_iter", "0", "--downsample", "2",
                       "--assign_gap", "1"]}
    for stage, extra in stages.items():
        listed = {}
        for who, main, own in (
                ("jax", jax_cli.main, []),
                ("torch", cli.main, ["--device", "cpu", "--silence"])):
            root = str(tmp_path / who / stage)
            main(common + extra + own + ["--save_root", root])
            assert os.listdir(root) == [seq]
            listed[who] = sorted(os.listdir(os.path.join(root, seq)))
        want = RELAXATION_FILES + (["novel_0.html"]
                                   if stage == "projection" else [])
        assert listed["torch"] == listed["jax"] == sorted(want), stage
        out = str(tmp_path / "torch" / stage / seq)
        assert _gif_frames(os.path.join(out, "input.gif")) == 4
        assert _gif_frames(os.path.join(out, "recon.gif")) == 4


@pytest.mark.parametrize("model", ["base", "kinematic"])
def test_finalize_artifacts_match_jax(robot_dir, tmp_path, model):
    """`finalize` of both packages from the same labels and poses: seg.html
    and structure.html byte for byte, the gifs of the whole sequence; on
    the kinematic model the retargeting views with the same colours and
    points within the viewer's rounding."""
    common = ["robot", "--seq_path", robot_dir, "--num_points", "360",
              "--num_parts", "5"]
    if model == "kinematic":
        common += ["--model", "kinematic"]
    jargs = jax_cli.build_parser().parse_args(common)
    targs = cli.build_parser().parse_args(
        common + ["--device", "cpu", "--silence", "--tree_search", "0"])
    jdataset = jax_cli.load_dataset(jargs, "robot")
    jsample = jdataset[0]
    tsample = cli.dataset_sample(cli.load_dataset(targs))
    result = _gt_result(jsample)
    if model == "base":
        # the GT parts scattered over 5 pose columns, as a fit leaves them
        cols = np.array([3, 0, 4])
        seg = cols[jsample["gt_cano_part"]]
        trans = np.tile(np.eye(4, dtype=np.float32), (3, 5, 1, 1))
        trans[:, cols] = result["pred_pose_list"]
        jparams = jax.tree.map(np.asarray,
                               init_base_params(jax.random.PRNGKey(0), 5, 3))
        tparams = base_params_from_jax(jparams, device="cpu")
        jstate = tstate = None
        jin = tin = (seg, trans)
    else:
        jparams, jstate = jax_cli.build_kinematic_from_result(
            jargs, "robot", jnp.asarray(jsample["cano_pc"]), result)
        tparams, tstate = kinematic_params_from_jax(
            jax.tree.map(np.asarray, jparams), jstate, device="cpu")
        _, jseg, jtrans = jax_kin_forward(jparams, jstate,
                                          jnp.asarray(jsample["cano_pc"]))
        jin = (np.asarray(jseg), np.asarray(jtrans))
        with torch.no_grad():
            _, tseg, ttrans = kinematic_forward(
                tparams, tstate, torch.from_numpy(jsample["cano_pc"]))
        tin = (tseg, ttrans)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jax_cli.finalize(jargs, "robot", jdataset, jsample, *jin, jparams, jstate,
                     jdir, 1.0)
    cli.finalize(targs, "robot", tsample, *tin, tparams, tstate, tdir, 1.0,
                 device="cpu")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("seg.html", "structure.html"):
        with open(os.path.join(tdir, name), "rb") as a, \
                open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("recon.gif", "gt.gif"):
        assert _gif_frames(os.path.join(tdir, name)) == 4
    novel = sorted(n for n in os.listdir(tdir) if n.startswith("novel_"))
    assert novel == (["novel_0.html"] if model == "kinematic" else [])
    for name in novel:
        got = _html_data(os.path.join(tdir, name))
        ref = _html_data(os.path.join(jdir, name))
        assert [s["c"] for s in got] == [s["c"] for s in ref]
        # points of 200 AMSGrad steps in each package, rounded to 4 places
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g["p"], r["p"], rtol=0, atol=2e-4)


def test_batch_seq_writes_input_gif_in_each_directory(tmp_path, capsys):
    root = make_sapien_scene(str(tmp_path / "scenes"), n_views=4,
                             n_points=300, n_parts=3, n_scenes=2)
    save_root = str(tmp_path / "exp")
    cli.main(["sapien", "--device", "cpu", "--sapien_base_folder", root,
              "--batch_seq", "0,1", "--save_root", save_root, "--n_iter",
              "20", "--assign_iter", "1000", "--use_flow_loss",
              "--flow_file", os.path.join(root, "flow_{idx}.npz"),
              "--num_parts", "5", "--downsample", "2"])
    out = capsys.readouterr().out
    assert sorted(os.listdir(save_root)) == ["0", "1"]
    for i in ("0", "1"):
        assert f"[phase] input_gif/{i}" in out
        assert sorted(os.listdir(os.path.join(save_root, i))) \
            == RELAXATION_FILES
        assert _gif_frames(os.path.join(save_root, i, "input.gif")) == 4


def test_ik_writes_novel_views_with_the_forwards_labels(tmp_path):
    """`ik(..., save_dir, save_vis=True)`: one novel_<k>.html per novel pose,
    the solved cloud in the colours of the kinematic forward's labels
    beside the GT novel cloud in the GT parts; the JAX package writes the
    same files."""
    sample = make_toy_robot_sample()
    seg, cano = sample["gt_cano_part"], sample["cano_pc"]
    # the parts relabelled, so that the forward's labels are not the GT's
    relabel = np.array([2, 0, 1])
    edges = [(relabel[1], relabel[0]), (relabel[2], relabel[0])]
    jstate = jk.make_kinematic_state(relabel[seg], cano, edges,
                                     int(relabel[0]))
    jparams = jk.init_kinematic_params(
        3, 2, axis_list=np.array([[0, 0, 1], [0, 0, 1]], np.float32),
        moment_list=np.zeros((2, 3), np.float32),
        theta_list=np.array([[0.25, -0.2], [0.5, -0.4], [0.75, -0.6]],
                            np.float32))
    params, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")

    class Dataset:
        pose_list = sample["pose_list"]
        cano_idx = sample["cano_idx"]
        novel_pose_list = sample["novel_pose_list"]

        def __getitem__(self, item):
            return sample

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert ik.ik(sample, "kinematic", params, state=state, n_iter=20,
                 device="cpu") < 9999.0
    assert not os.path.exists(tdir)  # nothing without save_vis
    ik.ik(sample, "kinematic", params, state=state, n_iter=20,
          save_dir=tdir, save_vis=True, device="cpu")
    jax_ik.ik(Dataset(), "kinematic", jparams, state=jstate, n_iter=20,
              save_dir=jdir, save_vis=True)
    names = [f"novel_{k}.html" for k in range(len(sample["novel_pose_list"]))]
    assert len(names) == 2
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == names
    with torch.no_grad():
        labels = kinematic_forward(params, state,
                                   torch.from_numpy(cano))[1].numpy()
    assert not np.array_equal(labels, seg)
    for name in names:
        pred, gt = _html_data(os.path.join(tdir, name))
        assert pred["c"] == viz._rgb_hex(viz.part_colors(labels))
        assert gt["c"] == viz._rgb_hex(viz.part_colors(seg))
        assert [s["c"] for s in _html_data(os.path.join(jdir, name))] \
            == [pred["c"], gt["c"]]

"""The real domain of the port against the JAX package on the CPU: mesh
reading (OBJ, and a minimal GLB written here) and surface sampling (arrays
equal), the sequence's samples (equal), the correspondence normalisation of
real and sapien sequences (equal), `finalize` of both packages on the same
labels and poses of a scan sequence without GT (the tree exact, cd_err and
the energy rtol 1e-3, atol 1e-4), and the port's command line: `corr
--data_domain real`, then `real --flow_provider corr`, both stages."""

import json
import os
import struct

import numpy as np
import pytest
import torch

import jax

from reart_tpu import cli as jax_cli
from reart_tpu.data import mesh as jax_mesh
from reart_tpu.data.real import RealSequence as JaxRealSequence
from reart_tpu.data.real import normalize_stats as jax_normalize_stats
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu.models.base_model import init_base_params
from reart_tpu_torch import checkpoint as ckpt
from reart_tpu_torch import cli
from reart_tpu_torch.data import mesh
from reart_tpu_torch.data.real import RealSequence, normalize_stats
from reart_tpu_torch.data.synth import make_sapien_scene, write_real_scene
from reart_tpu_torch.interop import base_params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Three OBJ frames: a body, a hinged flap and a slider."""
    return write_real_scene(str(tmp_path_factory.mktemp("real") / "scans"), 3)


def _write_glb(path, verts, faces, node):
    """A one-mesh binary glTF: float32 positions, uint16 indices, and the
    node that places the mesh."""
    pos = np.asarray(verts, np.float32).tobytes()
    idx = np.asarray(faces, np.uint16).tobytes()
    idx += b"\0" * (-len(idx) % 4)
    binbuf = pos + idx
    gltf = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(binbuf)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
            {"buffer": 0, "byteOffset": len(pos),
             "byteLength": 2 * np.size(faces)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": np.size(faces),
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "nodes": [dict(node, mesh=0)],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binbuf), 0x004E4942) + binbuf)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def test_meshes_and_sampling_equal_jax(scans, tmp_path):
    obj = os.path.join(scans, "scan_1.obj")
    quad = tmp_path / "quad.obj"  # a polygon face, fan-triangulated
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    for path in (obj, str(quad)):
        for a, b in zip(mesh.load_mesh(path), jax_mesh.load_mesh(path)):
            np.testing.assert_array_equal(a, b)
    verts, faces = mesh.load_obj(obj)
    for i, node in enumerate([
            {}, {"translation": [0.1, -0.2, 0.3], "scale": [2, 1, 0.5],
                 "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
            {"matrix": list(np.eye(4).ravel() * 2)}]):
        path = str(tmp_path / f"m{i}.glb")
        _write_glb(path, verts, faces, node)
        got, want = mesh.load_glb(path), jax_mesh.load_glb(path)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mesh.load_mesh(path)[1], faces)
    pts = mesh.sample_surface(verts, faces, 500, np.random.RandomState(3))
    np.testing.assert_array_equal(pts, jax_mesh.sample_surface(
        verts, faces, 500, np.random.RandomState(3)))
    with pytest.raises(ValueError, match="unsupported"):
        mesh.load_mesh(str(tmp_path / "x.ply"))


def test_sequence_and_normalisation_equal_jax(scans, tmp_path):
    for cano in (0, 2):
        seq, jseq = RealSequence(scans, 256, cano), JaxRealSequence(scans,
                                                                    256, cano)
        a, b = seq[0], jseq[0]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(seq.centroid, jseq.centroid)
        assert seq.scale == jseq.scale
        args = cli.build_parser().parse_args(["real", "--seq_path", scans])
        jargs = jax_cli.build_parser().parse_args(["real", "--seq_path",
                                                   scans])
        sample = cli.dataset_sample(seq)
        c, s = cli.corr_normalization(args, "real", sample)
        jc, js = jax_cli.corr_normalization(jargs, "real", jseq,
                                            b["complete_pc_list"])
        np.testing.assert_array_equal(c, jc)
        assert s == js
    verts = mesh.load_obj(os.path.join(scans, "scan_0.obj"))[0]
    for a, b in zip(normalize_stats(verts), jax_normalize_stats(verts)):
        np.testing.assert_array_equal(a, b)
    # sapien: the unit ball of the sequence's clouds
    root = make_sapien_scene(str(tmp_path / "sapien"), n_views=3,
                             n_points=120, n_parts=2)
    args = cli.build_parser().parse_args(
        ["sapien", "--sapien_base_folder", root, "--sapien_idx", "0"])
    sample = cli.dataset_sample(cli.load_dataset(args), 0)
    c, s = cli.corr_normalization(args, "sapien", sample)
    jc, js = jax_cli.corr_normalization(None, "sapien", None,
                                        sample["complete_pc_list"])
    np.testing.assert_array_equal(c, jc)
    assert s == js


def test_corr_training_frames_equal_jax(scans):
    """`corr --data_domain real` pools the frames of every --seq_path, each
    normalised by its canonical mesh, as the JAX package does."""
    argv = ["corr", "--data_domain", "real", "--seq_path", scans, scans,
            "--num_points", "200"]
    frames, sizes = cli._corr_training_frames(
        cli.build_parser().parse_args(argv))
    jframes, jsizes = jax_cli._corr_training_frames(
        jax_cli.build_parser().parse_args(argv))
    assert sizes == jsizes == [3, 3]
    np.testing.assert_allclose(frames, jframes, rtol=1e-6, atol=1e-7)


def test_finalize_matches_jax(scans, tmp_path):
    common = ["real", "--seq_path", scans, "--num_points", "300",
              "--num_parts", "4"]
    jargs = jax_cli.build_parser().parse_args(common)
    targs = cli.build_parser().parse_args(common + ["--device", "cpu",
                                                    "--silence"])
    jdataset = jax_cli.load_dataset(jargs, "real")
    jsample = jdataset[0]
    tsample = cli.dataset_sample(cli.load_dataset(targs))
    # labels by the scene's geometry (body, flap, slider) on 4 pose
    # columns, poses near the identity
    cano = jsample["cano_pc"]
    seg = np.where(cano[:, 0] > 0.5, 2, np.where(cano[:, 2] < -0.26, 0, 3))
    rng = np.random.RandomState(0)
    trans = np.asarray(jax_se3_exp_tw(
        jax.numpy.asarray(0.05 * rng.randn(8, 3).astype(np.float32)),
        jax.numpy.asarray(0.05 * rng.randn(8, 3).astype(np.float32)))
    ).reshape(2, 4, 4, 4)
    params = jax.tree.map(np.asarray,
                          init_base_params(jax.random.PRNGKey(0), 4, 2))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jres = jax_cli.finalize(jargs, "real", jdataset, jsample, seg.copy(),
                            trans.copy(), params, None, jdir, 1.0)
    tres = cli.finalize(targs, "real", tsample, seg.copy(), trans.copy(),
                        base_params_from_jax(params, device="cpu"), None,
                        tdir, 1.0, device="cpu")
    assert list(tres) == list(jres) == ["cd_err", "ass_err", "screw_err",
                                        "total_err"]
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    a = ckpt.load_result(os.path.join(tdir, "result.pkl"))
    b = ckpt.load_result(os.path.join(jdir, "result.pkl"))
    assert a.keys() == b.keys() and "normalize" not in a
    assert a["joint_connection"] == b["joint_connection"]
    np.testing.assert_array_equal(a["pred_cano_part"], b["pred_cano_part"])


def test_command_line_corr_then_both_stages(scans, tmp_path):
    save = str(tmp_path / "corr.pkl")
    corr = cli.main(["corr", "--device", "cpu", "--data_domain", "real",
                     "--seq_path", scans, "--num_points", "256", "--steps",
                     "1", "--batch", "1", "--train_points", "128",
                     "--save_path", save])
    assert np.isfinite(corr["loss"]) and os.path.exists(save)
    common = ["real", "--device", "cpu", "--seq_path", scans,
              "--num_points", "256", "--use_flow_loss", "--corr_model_path",
              save, "--num_parts", "5", "--silence"]
    root = str(tmp_path / "exp")
    base = cli.main(common + ["--save_root", root, "--n_iter", "300",
                              "--use_assign_loss", "--assign_iter", "200",
                              "--end_tau", "0.5"])
    txt = os.path.join(root, "scans", "result.txt")
    with open(txt) as f:
        keys = [line.split(":")[0] for line in f.read().splitlines()]
    assert keys == list(base) == ["cd_err", "ass_err", "screw_err",
                                  "total_err"]
    assert "seg_ri" not in keys and np.isfinite(list(base.values())).all()
    result = ckpt.load_result(os.path.join(root, "scans", "result.pkl"))
    assert len(result["joint_connection"]) >= 1  # an articulated result
    kin = cli.main(common + [
        "--save_root", str(tmp_path / "kin"), "--model", "kinematic",
        "--tree_search", "0", "--n_iter", "20", "--base_result_path",
        os.path.join(root, "scans", "result.pkl")])
    assert list(kin) == list(base)
    assert np.isfinite(list(kin.values())).all()

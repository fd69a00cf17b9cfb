"""The sapien domain of the port against the JAX package on the CPU: the
dataset's samples and the scene generator (arrays equal), every function of
sapien_eval (rtol 1e-5), the kinematic model built for a sapien tree (the
tree, joint types and prismatic mask exact; screws, distances and the root
trajectory rtol 1e-4, atol 1e-5: float32 dual quaternions), `finalize` of
both packages on the same labels and poses, base and kinematic (labels,
tree and RI exact, the rest rtol 1e-3, atol 1e-4), each package restoring
the other's model.ckpt.pkl, the msync flow provider against a stand-in
package, the port's command line on a toy scene, both stages, and `corr
--data_domain sapien` (its training frames equal, within rtol 1e-6) with a
run from its anchors."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import checkpoint as jax_ckpt
from reart_tpu import cli as jax_cli
from reart_tpu import sapien_eval as JS
from reart_tpu.data.sapien import SapienDataset as JaxSapienDataset
from reart_tpu.data.synth import make_sapien_scene as jax_make_sapien_scene
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu.models.base_model import init_base_params
from reart_tpu.models.kinematic import kinematic_forward as jax_kin_forward
from reart_tpu_torch import checkpoint as ckpt
from reart_tpu_torch import cli
from reart_tpu_torch import sapien_eval as S
from reart_tpu_torch.data.sapien import SapienDataset
from reart_tpu_torch.data.synth import make_sapien_scene
from reart_tpu_torch.interop import (
    base_params_from_jax,
    kinematic_params_from_jax,
    kinematic_params_to_numpy,
)
from reart_tpu_torch.models.kinematic import kinematic_forward

torch.set_num_threads(1)


def _rotz4(a):
    m = np.eye(4)
    m[0, 0], m[0, 1] = np.cos(a), -np.sin(a)
    m[1, 0], m[1, 1] = np.sin(a), np.cos(a)
    return m


def _two_part_scene(root):
    """The 2-part, 3-view fixture of tests/test_cli_sapien_real.py: a body
    and a lid, the camera rotating a little per view."""
    os.makedirs(os.path.join(root, "data"))
    rng = np.random.RandomState(0)
    body = rng.uniform([-0.5, -0.5, -0.2], [0.5, 0.5, 0.2], (100, 3))
    lid = rng.uniform([-0.5, 0.3, 0.2], [0.5, 0.5, 0.4], (100, 3))
    cano = np.concatenate([body, lid]).astype(np.float32)
    homo = np.concatenate([cano, np.ones((200, 1))], 1)
    pcs, trans = [], {"cam": [], 1: [], 2: []}
    for v in range(3):
        cam, m_lid = _rotz4(0.05 * v), _rotz4(0.3 * v)
        trans["cam"].append(cam)
        trans[1].append(np.eye(4))
        trans[2].append(m_lid)
        world = homo.copy()
        world[100:] = homo[100:] @ m_lid.T
        pcs.append((world @ np.linalg.inv(cam).T)[:, :3].astype(np.float32))
    np.savez(os.path.join(root, "data", "000000.npz"), pc=np.stack(pcs),
             segm=np.stack([np.repeat([1, 2], 100)] * 3),
             trans=np.asarray(trans, dtype=object))
    with open(os.path.join(root, "meta.json"), "w") as f:
        f.write('{"test": [0]}')
    return root


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A small scene of the part table: 4 views x 300 points, 3 parts (a
    static body, a hinged lid, a drawer)."""
    return make_sapien_scene(str(tmp_path_factory.mktemp("sapien")),
                             n_views=4, n_points=300, n_parts=3)


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_samples_and_scene_equal_jax(tmp_path, scene):
    two = _two_part_scene(str(tmp_path / "two"))
    for root in (two, scene):
        for cano in (0, 1):
            _same_sample(SapienDataset(root, cano)[0],
                         JaxSapienDataset(root, cano)[0])
    # the port's scene generator writes the JAX package's scene
    jroot = jax_make_sapien_scene(str(tmp_path / "jax"), n_views=4,
                                  n_points=300, n_parts=3)
    for name in ("data/000000.npz", "flow.npz"):
        a = np.load(os.path.join(scene, name), allow_pickle=True)
        b = np.load(os.path.join(jroot, name), allow_pickle=True)
        for k in a.files:
            if k == "trans":
                ta, tb = a[k].item(), b[k].item()
                assert ta.keys() == tb.keys()
                for p in ta:
                    np.testing.assert_array_equal(np.stack(ta[p]),
                                                  np.stack(tb[p]))
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sapien_eval_matches_jax(scene, tmp_path):
    rng = np.random.RandomState(1)
    sample = SapienDataset(scene)[0]
    trans = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.3 * rng.randn(4 * 3, 3).astype(np.float32)),
        jnp.asarray(0.2 * rng.randn(4 * 3, 3).astype(np.float32)))
    ).reshape(4, 3, 4, 4)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        S.compute_align_trans(torch.from_numpy(trans),
                              torch.from_numpy(trans[:, 1])).numpy(),
        np.asarray(JS.compute_align_trans(jnp.asarray(trans),
                                          jnp.asarray(trans[:, 1]))), **tol)
    np.testing.assert_allclose(
        S.compute_rel_trans(torch.from_numpy(trans), 2).numpy(),
        np.asarray(JS.compute_rel_trans(jnp.asarray(trans), 2)), **tol)
    segs = rng.randint(0, 3, (4, 300))
    pcs = sample["complete_pc_list"]
    full = S.compute_full_flow(pcs, segs, trans, device="cpu")
    jfull = np.asarray(JS.compute_full_flow(pcs, segs, trans))
    np.testing.assert_allclose(full.numpy(), jfull, **tol)
    assert S.eval_full_flow(full, sample["gt_full_flow"]) == pytest.approx(
        JS.eval_full_flow(jfull, sample["gt_full_flow"]), rel=1e-5)
    pred = sample["gt_pc_list"] + 0.01 * rng.randn(3, 300, 3).astype(
        np.float32)
    np.testing.assert_array_equal(
        S.seg_propagation_list(sample["pc_list"], pred,
                               sample["gt_cano_part"], device="cpu"),
        JS.seg_propagation_list(sample["pc_list"], pred,
                                sample["gt_cano_part"]))
    path = os.path.join(scene, "flow.npz")
    for a, b in zip(S.load_precomputed_flow(path),
                    JS.load_precomputed_flow(path)):
        np.testing.assert_array_equal(a, b)
    np.savez(str(tmp_path / "noconf.npz"), flow=np.ones((2, 5, 3)))
    assert S.load_precomputed_flow(str(tmp_path / "noconf.npz"))[1].shape \
        == (2, 5)


def _args(scene, extra=()):
    common = ["sapien", "--sapien_base_folder", scene, "--sapien_idx", "0",
              "--num_parts", "5", *extra]
    return (jax_cli.build_parser().parse_args(common),
            cli.build_parser().parse_args(common + ["--device", "cpu",
                                                    "--silence"]))


def _perturbed_fit(sample, seed):
    """Labels and poses as a fit leaves them: the 3 GT parts scattered over
    5 pose columns, some points on a wrong part, a handful on a label of
    their own, every pose a little off."""
    rng = np.random.RandomState(seed)
    cols = rng.permutation(5)
    seg = cols[sample["gt_cano_part"]]
    wrong = rng.choice(len(seg), 12, replace=False)
    seg[wrong] = cols[rng.randint(0, 3, 12)]
    seg[rng.choice(len(seg), 4, replace=False)] = cols[3]
    trans = np.tile(np.eye(4, dtype=np.float32), (3, 5, 1, 1))
    trans[:, cols[:3]] = sample["gt_pose_list"][1:]
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(15, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(15, 3).astype(np.float32))))
    return seg, (noise.reshape(3, 5, 4, 4) @ trans).astype(np.float32)


def _read_txt(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (line.split(": ") for line in f.read().splitlines() if line)}


def _same_results(jdir, tdir, jres, tres, exact):
    jtxt = _read_txt(os.path.join(jdir, "result.txt"))
    ttxt = _read_txt(os.path.join(tdir, "result.txt"))
    assert list(ttxt) == list(jtxt) == list(tres)
    for k in exact:
        assert tres[k] == jres[k], k
    for k in jres:
        # float32 metrics of the same labels and poses: rtol 1e-3; the
        # screw energy is a small cost of near-exact screws: atol 1e-4
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_finalize_matches_jax(scene, tmp_path):
    jargs, targs = _args(scene)
    jdataset = jax_cli.load_dataset(jargs, "sapien")
    jsample = jdataset[0]
    tsample = cli.dataset_sample(cli.load_dataset(targs), 0)
    seg, trans = _perturbed_fit(jsample, 0)
    params = jax.tree.map(np.asarray,
                          init_base_params(jax.random.PRNGKey(0), 5, 3))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jres = jax_cli.finalize(jargs, "sapien", jdataset, jsample, seg.copy(),
                            trans.copy(), params, None, jdir, 1.0)
    tres = cli.finalize(targs, "sapien", tsample, seg.copy(), trans.copy(),
                        base_params_from_jax(params, device="cpu"), None,
                        tdir, 1.0, device="cpu")
    assert "full_flow_epe" in tres and "ted" not in tres
    _same_results(jdir, tdir, jres, tres,
                  ("seg_ri", "per_scan_ri", "multi_scan_ri"))
    jpk = jax_ckpt.load_result(os.path.join(jdir, "result.pkl"))
    tpk = ckpt.load_result(os.path.join(tdir, "result.pkl"))
    assert tpk.keys() == jpk.keys() and "gt_full_flow" in tpk
    assert tpk["joint_connection"] == jpk["joint_connection"]
    np.testing.assert_array_equal(tpk["pred_cano_part"],
                                  jpk["pred_cano_part"])
    np.testing.assert_array_equal(tpk["gt_full_flow"], jpk["gt_full_flow"])


def test_kinematic_model_finalize_and_checkpoints_match_jax(scene, tmp_path):
    """One sapien tree through both packages' kinematic_from_tree: the same
    tree, joint types (the drawer prismatic), screws, distances and root
    trajectory; both finalize on that model give the same result.txt; each
    package restores the other's model.ckpt.pkl."""
    jargs, targs = _args(scene, ["--model", "kinematic", "--tree_search",
                                 "0"])
    jdataset = jax_cli.load_dataset(jargs, "sapien")
    jsample = jdataset[0]
    tsample = cli.dataset_sample(cli.load_dataset(targs), 0)
    seg = jsample["gt_cano_part"]
    rng = np.random.RandomState(2)
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(9, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(9, 3).astype(np.float32))))
    trans = (noise.reshape(3, 3, 4, 4)
             @ jsample["gt_pose_list"][1:]).astype(np.float32)
    conn = np.array([[1, 0], [2, 0]])
    cano = jsample["cano_pc"]
    jparams, jstate = jax_cli.kinematic_from_tree(
        jargs, "sapien", jnp.asarray(cano), jnp.asarray(seg),
        jnp.asarray(trans), conn)
    tparams, tstate = cli.kinematic_from_tree(targs, "sapien", cano, seg,
                                              trans, conn, device="cpu")
    assert tstate.edges == jstate.edges
    assert tstate.reverse_topo == jstate.reverse_topo
    assert tstate.has_root_trans and jstate.has_root_trans
    np.testing.assert_array_equal(tstate.prismatic_mask.numpy(),
                                  np.asarray(jstate.prismatic_mask))
    assert sorted(map(bool, tstate.prismatic_mask.tolist())) == [False, True]
    tnp = kinematic_params_to_numpy(tparams)
    assert sorted(tnp) == sorted(jparams) == [
        "axis_list", "distance_list", "moment_list", "root_6d", "root_t",
        "theta_list"]
    for k, v in tnp.items():
        np.testing.assert_allclose(v, np.asarray(jparams[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)

    # finalize on the JAX model in both packages
    jp, js = kinematic_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       jstate, device="cpu")
    _, jseg, jtrans = jax_kin_forward(jparams, jstate, jnp.asarray(cano))
    with torch.no_grad():
        _, tseg, ttrans = kinematic_forward(jp, js, torch.from_numpy(cano))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jres = jax_cli.finalize(jargs, "sapien", jdataset, jsample,
                            np.asarray(jseg), np.asarray(jtrans), jparams,
                            jstate, jdir, 1.0)
    tres = cli.finalize(targs, "sapien", tsample, tseg, ttrans, jp, js, tdir,
                        1.0, device="cpu")
    _same_results(jdir, tdir, jres, tres,
                  ("seg_ri", "per_scan_ri", "multi_scan_ri"))

    # the port's checkpoint in the JAX package, and the other way round
    payload = jax_ckpt.load_checkpoint(os.path.join(tdir, "model.ckpt.pkl"))
    back_state = jax_ckpt.restore_kinematic_state(payload)
    back = jax.tree.map(jnp.asarray, payload["state_dict"])
    assert back_state.edges == jstate.edges
    np.testing.assert_array_equal(np.asarray(back_state.prismatic_mask),
                                  np.asarray(jstate.prismatic_mask))
    np.testing.assert_allclose(
        np.asarray(jax_kin_forward(back, back_state, jnp.asarray(cano))[0]),
        np.asarray(jax_kin_forward(jparams, jstate, jnp.asarray(cano))[0]),
        rtol=1e-6, atol=1e-6)
    model, state = ckpt.kinematic_model_from_checkpoint(
        ckpt.load_checkpoint(os.path.join(jdir, "model.ckpt.pkl")),
        device="cpu")
    assert state.edges == tstate.edges and state.has_root_trans
    with torch.no_grad():
        again = kinematic_forward(model, state, torch.from_numpy(cano))[2]
    np.testing.assert_allclose(again.numpy(), ttrans.numpy(), rtol=1e-6,
                               atol=1e-6)


def _write_fake_msync(root):
    """A stand-in for the external multibody-sync repository: its module
    layout and call surface (FlowNet, ConfNet, get_network_input), with a
    FlowNet that returns tgt - src."""
    import textwrap

    pkg = root / "msync"
    (pkg / "models").mkdir(parents=True)
    (pkg / "config").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "models" / "__init__.py").write_text("")
    (pkg / "models" / "flow_net.py").write_text(textwrap.dedent("""
        import torch, torch.nn as nn

        class FlowNet(nn.Module):
            def __init__(self):
                super().__init__()
                self.scale = nn.Parameter(torch.ones(1))

            def forward(self, src, tgt, src2, tgt2):
                flow = (self.scale * (tgt - src)).transpose(-1, -2)
                return flow.unsqueeze(0), None, None, None, None
    """))
    (pkg / "models" / "conf_net.py").write_text(textwrap.dedent("""
        import torch, torch.nn as nn

        def get_network_input(src, tgt, flow):
            return flow

        class ConfNet(nn.Module):
            def __init__(self):
                super().__init__()
                self.bias = nn.Parameter(torch.zeros(1))

            def forward(self, x):
                return None, x.norm(dim=-1) + self.bias
    """))
    (pkg / "config" / "articulated-full.yaml").write_text("type: full\n")
    torch.save({"model_state": {"flow_net.scale": torch.ones(1),
                                "conf_net.bias": torch.zeros(1)}},
               root / "best.pth.tar")
    return (str(pkg / "config" / "articulated-full.yaml"),
            str(root / "best.pth.tar"))


def test_msync_flow_provider(tmp_path):
    cfg_path, ckpt_path = _write_fake_msync(tmp_path)
    pcs = np.random.RandomState(0).randn(3, 50, 3).astype(np.float32)
    out = str(tmp_path / "flows.npz")
    try:
        flow, conf = S.compute_flow_msync(pcs, cfg_path, ckpt_path,
                                          save_path=out)
        jflow, jconf = JS.compute_flow_msync(pcs, cfg_path, ckpt_path)
    finally:  # leave the stand-in out of later tests
        sys.path[:] = [p for p in sys.path if p != str(tmp_path)]
        for m in [m for m in sys.modules if m.startswith("msync")]:
            del sys.modules[m]
    assert flow.shape == (2, 50, 3) and conf.shape == (2, 50)
    np.testing.assert_allclose(flow, pcs[1:] - pcs[:-1], atol=1e-5)
    np.testing.assert_array_equal(flow, jflow)
    np.testing.assert_array_equal(conf, jconf)
    for a, b in zip(S.load_precomputed_flow(out), (flow, conf)):
        np.testing.assert_array_equal(a, b)
    assert str(tmp_path) not in sys.path

    cfg = tmp_path / "none" / "msync" / "config" / "articulated-full.yaml"
    cfg.parent.mkdir(parents=True)
    cfg.write_text("type: full\n")
    with pytest.raises(ImportError, match="multibody-sync"):
        S.compute_flow_msync(pcs, str(cfg), "x.pth")
    assert not any(m.startswith("msync") for m in sys.modules)


def test_command_line_on_the_toy_scene(scene, tmp_path):
    """Both stages from the scene's --flow_file on the CPU: the bar of the
    JAX package's sapien drive (multi-scan RI > 0.7), the result files, and
    result.pkl carrying the sample's full flow to the projection run."""
    root = str(tmp_path / "exp")
    common = ["sapien", "--device", "cpu", "--sapien_base_folder", scene,
              "--sapien_idx", "0", "--flow_file",
              os.path.join(scene, "flow.npz"), "--use_flow_loss",
              "--use_assign_loss", "--num_parts", "5", "--downsample", "2",
              "--silence"]
    base = cli.main(common + ["--save_root", root, "--n_iter", "200",
                              "--assign_iter", "120", "--end_tau", "0.5"])
    assert list(base) == ["seg_ri", "recon_err", "cd_err", "full_flow_epe",
                          "per_scan_ri", "multi_scan_ri", "ass_err",
                          "screw_err", "total_err"]
    assert base["multi_scan_ri"] > 0.7, base
    result = ckpt.load_result(os.path.join(root, "0", "result.pkl"))
    assert "gt_full_flow" in result and "normalize" not in result
    kin = cli.main(common + [
        "--save_root", str(tmp_path / "kin"), "--model", "kinematic",
        "--tree_search", "0", "--n_iter", "30", "--assign_iter", "0",
        "--base_result_path", os.path.join(root, "0", "result.pkl")])
    assert list(kin) == list(base)
    assert kin["multi_scan_ri"] > 0.7, kin
    assert np.isfinite(list(kin.values())).all()
    payload = jax_ckpt.load_checkpoint(os.path.join(tmp_path, "kin", "0",
                                                    "model.ckpt.pkl"))
    assert payload["has_root_trans"] and "root_6d" in payload["state_dict"]


def test_corr_on_the_toy_scene_then_corr_flow(scene, tmp_path):
    """`corr --data_domain sapien` pools the frames of every --sapien_idx,
    normalised into the unit ball as the JAX package normalises them, and
    trains; `sapien --flow_provider corr` fits from that file's anchors."""
    common = ["--sapien_base_folder", scene, "--sapien_idx", "0"]
    jargs = jax_cli.build_parser().parse_args(
        ["corr", "--data_domain", "sapien", *common])
    targs = cli.build_parser().parse_args(
        ["corr", "--data_domain", "sapien", *common])
    frames, sizes = cli._corr_training_frames(targs)
    jframes, jsizes = jax_cli._corr_training_frames(jargs)
    assert sizes == jsizes == [4]
    np.testing.assert_allclose(frames, jframes, rtol=1e-6, atol=1e-7)
    save = str(tmp_path / "corr.pkl")
    out = cli.main(["corr", "--device", "cpu", "--data_domain", "sapien",
                    *common, "--steps", "1", "--batch", "1",
                    "--train_points", "128", "--save_path", save])
    assert np.isfinite(out["loss"]) and os.path.exists(save)
    res = cli.main(["sapien", "--device", "cpu", *common, "--flow_provider",
                    "corr", "--corr_model_path", save, "--use_flow_loss",
                    "--num_parts", "4", "--n_iter", "30", "--downsample",
                    "2", "--silence", "--save_root", str(tmp_path / "exp")])
    assert np.isfinite(list(res.values())).all() and "multi_scan_ri" in res

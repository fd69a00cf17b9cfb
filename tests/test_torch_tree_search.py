"""The kinematic-tree search of the port against reart_tpu on the CPU:
`graph.tree_candidates` and `cli._axis_excess` exactly, `tree_search_build`
on the offset-hinge robot (the same candidates and selected tree, each
candidate's energy within rtol 1e-3), the command line recovering the star
tree under both criteria, and the parser's new flags."""

import os
import pickle
import re
from types import SimpleNamespace

import networkx as nx
import numpy as np
import pytest
import torch

import jax

from reart_tpu import cli as jax_cli
from reart_tpu import metrics as jax_metrics
from reart_tpu.data.common import Node
from reart_tpu.graph.mst import mst as jax_mst
from reart_tpu.graph.mst import tree_candidates as jax_tree_candidates
from reart_tpu_torch import checkpoint as ckpt
from reart_tpu_torch import cli
from reart_tpu_torch import metrics
from reart_tpu_torch.data.synth import (
    make_offset_hinge_sample,
    write_robot_sequence,
)
from reart_tpu_torch.graph import mst, tree_candidates
from reart_tpu_torch.interop import kinematic_model_from_numpy

torch.set_num_threads(1)


def _costs(seed, p, tied=False):
    rng = np.random.RandomState(seed)
    cost = rng.rand(p, p) * 2
    if tied:  # few distinct values: many equal deltas and equal costs
        cost = np.round(cost * 2) / 2
    return cost + 1e4 * np.eye(p)


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("p", [4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("k", [3, 8, 40])
def test_tree_candidates_match_jax(p, tied, k):
    cost = _costs(p * 7 + k, p, tied)
    got, got_d = tree_candidates(cost, k=k, return_deltas=True)
    ref, ref_d = jax_tree_candidates(cost, k=k, return_deltas=True)
    _same(got, ref)
    assert got_d == ref_d  # exact: the same float64 differences


@pytest.mark.parametrize("p", [1, 2])
def test_tree_candidates_at_most_two_parts_match_jax(p):
    cost = _costs(p, p)
    got, got_d = tree_candidates(cost, k=8, return_deltas=True)
    ref, ref_d = jax_tree_candidates(cost, k=8, return_deltas=True)
    _same(got, ref)
    assert got_d == ref_d == [0.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_candidates_with_labels_match_jax(seed):
    p = 6
    cost = _costs(seed, p, tied=seed == 2)
    uni = np.arange(p) * 3 + 1
    got = tree_candidates(cost, uni_label=uni, k=6)
    _same(got, jax_tree_candidates(cost, uni_label=uni, k=6))
    for t in got:
        assert np.isin(t, uni).all()


def test_tree_candidates_asymmetric_orientation_matches_jax():
    """The inserted edge keeps the cheaper of its two orientations."""
    rng = np.random.RandomState(5)
    cost = rng.rand(7, 7) * 3 + 1e4 * np.eye(7)
    _same(tree_candidates(cost, k=20), jax_tree_candidates(cost, k=20))


# the invariants of tests/test_tree_search.py, held on the port


def test_tree_candidates_invariants(rng):
    p = 7
    cost = rng.rand(p, p) * 2 + 1e4 * np.eye(p)
    cands = tree_candidates(cost, k=6)
    assert len(cands) <= 6
    assert np.array_equal(cands[0], mst(cost, keep_index=True))
    assert np.array_equal(cands[0], jax_mst(cost, keep_index=True))
    seen = set()
    for t in cands:
        g = nx.Graph()
        g.add_nodes_from(range(p))
        g.add_edges_from(map(tuple, t))
        assert nx.is_tree(g)
        key = frozenset(map(tuple, np.sort(t, axis=1)))
        assert key not in seen  # deduplicated
        seen.add(key)


def test_tree_candidates_deltas(rng):
    p = 6
    cost = rng.rand(p, p) * 2 + 1e4 * np.eye(p)
    cands, deltas = tree_candidates(cost, k=5, return_deltas=True)
    assert len(deltas) == len(cands)
    assert deltas[0] == 0.0
    assert all(d >= 0.0 for d in deltas)
    assert deltas[1:] == sorted(deltas[1:])


def test_tree_candidates_degenerate():
    cost = np.array([[1e4, 1.0], [2.0, 1e4]])
    cands = tree_candidates(cost, k=8)
    assert len(cands) == 1 and cands[0].shape == (1, 2)


# _axis_excess: the fixtures of tests/test_tree_search.py, as float32 model
# values in both packages


def _excess_inputs():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    seg = np.zeros(200, np.int64)
    seg[100:] = 1
    return pts, seg


def _both_excess(values, pris, return_detail=True):
    pts, seg = _excess_inputs()
    values = {k: np.asarray(v, np.float32) for k, v in values.items()}
    jstate = SimpleNamespace(edges=np.array([[1, 0]]),
                             prismatic_mask=np.asarray(pris))
    tstate = SimpleNamespace(edges=((1, 0),),
                             prismatic_mask=torch.tensor(pris))
    ref = jax_cli._axis_excess(values, jstate, pts, seg,
                               return_detail=return_detail)
    got = cli._axis_excess(kinematic_model_from_numpy(values, device="cpu"),
                           tstate, torch.from_numpy(pts),
                           torch.from_numpy(seg), return_detail=return_detail)
    assert got == ref  # exact: the same float64 numpy on the same values
    return got


THETA = [[0.0], [0.4], [0.8]]
FAR = {"axis_list": [[0.0, 0.0, 1.0]], "moment_list": [[0.0, -100.0, 0.0]],
       "theta_list": THETA}


@pytest.mark.parametrize("case", [
    "sane", "far", "still", "prismatic", "two_frame", "one_sided",
    "zero_axis"])
def test_axis_excess_matches_jax(case):
    values, pris = dict(FAR), [False]
    if case == "sane":
        values["moment_list"] = [[0.0, 0.0, 0.0]]
    elif case == "still":
        values["theta_list"] = [[0.0], [1e-3], [2e-3]]
    elif case == "prismatic":
        pris = [True]
    elif case == "two_frame":
        values["theta_list"] = [[0.7]]
    elif case == "one_sided":
        values["theta_list"] = [[0.4], [0.8]]
    elif case == "zero_axis":
        values["axis_list"] = [[0.0, 0.0, 0.0]]
    mean, detail = _both_excess(values, pris)
    if case in ("sane", "prismatic", "zero_axis"):
        assert mean == 0.0
    if case in ("prismatic", "zero_axis"):
        assert detail == []
    if case == "far":
        [(e, child, exc, th_amp)] = detail
        assert (e, child) == (0, 1) and exc == mean > 50.0
        assert abs(th_amp - 0.8) < 1e-6 and exc * th_amp > 40.0
    if case == "still":
        assert detail[0][2] * detail[0][3] < 0.3
    if case == "two_frame":  # the canonical frame's theta = 0 counts
        assert abs(detail[0][3] - 0.7) < 1e-6
    if case == "one_sided":
        assert abs(detail[0][3] - 0.8) < 1e-6
    assert _both_excess(values, pris, return_detail=False) == mean


# the offset-hinge robot


@pytest.fixture(scope="module")
def offset_hinge_dir(tmp_path_factory):
    """The offset-hinge robot on disk, with the GT graph both packages'
    loaders read."""
    root = tmp_path_factory.mktemp("offsetrobot")
    write_robot_sequence(str(root), make_offset_hinge_sample())
    nodes = {pid: Node([f"link_{pid}"]) for pid in (0, 1, 2)}
    g = nx.DiGraph()
    g.add_edge(nodes[1], nodes[0])
    g.add_edge(nodes[2], nodes[0])
    with open(root / "graph.gpickle", "wb") as f:
        pickle.dump(g, f)
    with open(root / "part_mapping.pkl", "wb") as f:
        pickle.dump({
            "face_part_mapping": {},
            "node_part_mapping": {pid: [f"link_{pid}"] for pid in (0, 1, 2)},
        }, f)
    return str(root)


WRONG_CHAIN = [[1, 0], [2, 1]]  # arm_r under arm_l


@pytest.fixture(scope="module")
def base_result(offset_hinge_dir, tmp_path_factory):
    """The relaxation result of GT labels, GT poses and the wrong chain."""
    sample = cli.load_dataset(cli.build_parser().parse_args(
        ["robot", "--seq_path", offset_hinge_dir, "--num_points", "360"]))[0]
    path = str(tmp_path_factory.mktemp("result") / "base_result.pkl")
    with open(path, "wb") as f:
        pickle.dump({"pred_cano_part": sample["gt_cano_part"],
                     "pred_pose_list": sample["gt_pose_list"][1:],
                     "cano_idx": 0, "joint_connection": WRONG_CHAIN}, f)
    return path


def test_offset_hinge_in_memory_is_the_sequence_on_disk(offset_hinge_dir):
    args = cli.build_parser().parse_args(
        ["robot", "--seq_path", offset_hinge_dir, "--num_points", "360"])
    disk = cli.dataset_sample(cli.load_dataset(args))
    jdisk = jax_cli.load_dataset(args, "robot")[0]
    mem = make_offset_hinge_sample()
    for k in jdisk:
        np.testing.assert_array_equal(disk[k], jdisk[k], err_msg=k)
        np.testing.assert_allclose(mem[k], disk[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    from reart_tpu_torch.data.common import load_gt_graph

    assert sorted(load_gt_graph(offset_hinge_dir)[1]) == sorted(
        mem["gt_edges"])


def _record_energies(monkeypatch, module):
    seen = []
    energy = module.energy

    def recording(*a, **kw):
        out = energy(*a, **kw)
        seen.append(out["total_err"])
        return out

    monkeypatch.setattr(module, "energy", recording)
    return seen


def _candidates(out):
    return [(int(i), eval(edges)) for i, edges in re.findall(
        r"tree_search candidate (\d+):.* edges (\[.*\])", out)]


@pytest.mark.parametrize("select", ["energy", "holdout"])
def test_tree_search_build_matches_jax(offset_hinge_dir, base_result,
                                       monkeypatch, capsys, select):
    """Both packages' tree search on the wrong stored chain in auto mode,
    flow and assignment losses off (so both fits run the same arithmetic):
    the same candidates in the same order, the same selected tree, each
    candidate's energy within rtol 1e-3. (The winners' screws are not
    compared: the GT hinges leave the axes' tilt a direction of near-zero
    gradient, where Adam turns each package's rounding into steps of the
    learning rate, as at the relaxation's identity start, ROADMAP.md §3.)"""
    flags = ["robot", "--seq_path", offset_hinge_dir, "--num_points", "360",
             "--model", "kinematic", "--tree_search_iter", "20",
             "--tree_select", select, "--start_tau", "1", "--end_tau", "1"]
    jargs = jax_cli.build_parser().parse_args(flags)
    targs = cli.build_parser().parse_args(flags + ["--device", "cpu"])
    sample = jax_cli.load_dataset(jargs, "robot")[0]
    result = ckpt.load_result(base_result)

    jseen = _record_energies(monkeypatch, jax_metrics)
    jparams, jstate = jax_cli.build_kinematic_from_result(
        jargs, "robot", jax.numpy.asarray(sample["cano_pc"]), result,
        pc_list=jax.numpy.asarray(sample["pc_list"]),
        cfg=jax_cli.fit_config(jargs, "robot"), flow_ctx=None,
        key=jax.random.PRNGKey(0))
    jout = capsys.readouterr().out
    tseen = _record_energies(monkeypatch, metrics)
    tparams, tstate = cli.build_kinematic_from_result(
        targs, "robot", sample["cano_pc"], result, pc_list=sample["pc_list"],
        cfg=cli.fit_config(targs), flow_ctx=None, device="cpu")
    tout = capsys.readouterr().out

    assert _candidates(tout) == _candidates(jout)
    assert len(_candidates(tout)) == 3  # the stored chain is among them
    assert re.findall(r"selected candidate \d+", tout) == re.findall(
        r"selected candidate \d+", jout)
    assert tstate.edges == jstate.edges
    assert {tuple(sorted(e)) for e in tstate.edges} == {(0, 1), (0, 2)}
    np.testing.assert_allclose(tseen, jseen, rtol=1e-3, atol=1e-7)
    assert sorted(tparams.state_dict()) == sorted(jparams)


def test_sapien_tree_search_build_matches_jax(tmp_path, monkeypatch,
                                              capsys):
    """Off the robot domain: a 4-part sapien scene (revolute and prismatic
    joints, poses aligned to the root part for the costs, a root
    trajectory, no group term), GT labels and poses with the star stored;
    the same candidates, order and selection in both packages, each
    candidate's energy within rtol 1e-3 or atol 5e-6 (recon only: the same
    arithmetic in both fits)."""
    from reart_tpu_torch.data.synth import make_sapien_scene

    root = make_sapien_scene(str(tmp_path / "scene"), n_views=4,
                             n_points=300, n_parts=4)
    flags = ["sapien", "--sapien_base_folder", root, "--sapien_idx", "0",
             "--model", "kinematic", "--tree_search_iter", "20"]
    jargs = jax_cli.build_parser().parse_args(flags)
    targs = cli.build_parser().parse_args(flags + ["--device", "cpu"])
    sample = jax_cli.load_dataset(jargs, "sapien")[0]
    p = sample["gt_pose_list"].shape[1]
    result = {"pred_cano_part": sample["gt_cano_part"],
              "pred_pose_list": sample["gt_pose_list"][1:], "cano_idx": 0,
              "joint_connection": [[i, 0] for i in range(1, p)]}

    jseen = _record_energies(monkeypatch, jax_metrics)
    _, jstate = jax_cli.build_kinematic_from_result(
        jargs, "sapien", jax.numpy.asarray(sample["cano_pc"]), result,
        pc_list=jax.numpy.asarray(sample["pc_list"]),
        cfg=jax_cli.fit_config(jargs, "sapien"), flow_ctx=None,
        key=jax.random.PRNGKey(0))
    jout = capsys.readouterr().out
    tseen = _record_energies(monkeypatch, metrics)
    _, tstate = cli.build_kinematic_from_result(
        targs, "sapien", sample["cano_pc"], result,
        pc_list=sample["pc_list"], cfg=cli.fit_config(targs), flow_ctx=None,
        device="cpu")
    tout = capsys.readouterr().out

    assert _candidates(tout) == _candidates(jout)
    assert len(_candidates(tout)) > 1
    assert re.findall(r"selected candidate \d+", tout) == re.findall(
        r"selected candidate \d+", jout)
    assert tstate.edges == jstate.edges
    np.testing.assert_array_equal(tstate.prismatic_mask.numpy(),
                                  np.asarray(jstate.prismatic_mask))
    # energies of 4e-5 to 2e-3 (raw squared metres off the robot domain):
    # where a fit reaches the noise floor its float32 residual shows, up to
    # 1.2e-6 apart after 20 Adam steps; atol 5e-6 beside rtol 1e-3
    np.testing.assert_allclose(tseen, jseen, rtol=1e-3, atol=5e-6)


@pytest.mark.parametrize("extra, star", [
    (["--tree_search_iter", "40"], True),         # the default: auto
    (["--tree_search", "0"], False),              # the stored tree as it is
    (["--tree_select", "holdout", "--tree_search_iter", "40"], True),
])
def test_command_line_recovers_the_star(offset_hinge_dir, base_result,
                                        tmp_path, extra, star):
    """The port's command line on the offset-hinge robot from the wrong
    stored chain, as tests/test_tree_search.py runs the JAX one: the
    default auto sweep and the holdout criterion select the true star,
    --tree_search 0 keeps the stored tree."""
    save_root = str(tmp_path / "exp")
    cli.main(["robot", "--device", "cpu", "--seq_path", offset_hinge_dir,
              "--save_root", save_root, "--model", "kinematic",
              "--base_result_path", base_result, "--n_iter", "60",
              "--num_points", "360", "--start_tau", "1", "--end_tau", "1",
              "--snapshot_gap", "1000", "--silence", *extra])
    seq = os.path.basename(offset_hinge_dir)
    payload = ckpt.load_checkpoint(os.path.join(save_root, seq,
                                                "model.ckpt.pkl"))
    state = ckpt.restore_kinematic_state(payload, device="cpu")
    edges = {tuple(sorted(e)) for e in state.edges}
    assert edges == ({(0, 1), (0, 2)} if star else {(0, 1), (1, 2)})


NEW_FLAGS = ("tree_search", "tree_search_iter", "tree_search_margin",
             "tree_select", "auto_cano", "auto_cano_iters", "use_nproc",
             "use_cuda")


def _action(parser, domain, dest):
    sub = parser._subparsers._group_actions[0].choices[domain]
    return next(a for a in sub._actions if a.dest == dest)


@pytest.mark.parametrize("dest", NEW_FLAGS)
def test_parser_flags_match_jax(dest):
    for domain in ("robot", "sapien", "real"):
        ours = _action(cli.build_parser(), domain, dest)
        theirs = _action(jax_cli.build_parser(), domain, dest)
        assert (ours.default, ours.choices, ours.type, ours.nargs,
                ours.const, ours.option_strings) == (
            theirs.default, theirs.choices, theirs.type, theirs.nargs,
            theirs.const, theirs.option_strings), (domain, dest)

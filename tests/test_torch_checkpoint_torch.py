"""The reference's torch-format checkpoints in the port, on the CPU.

The port's save -> load round trip (parameters and state exactly); a file
that reart_tpu's `save_torch_*` wrote loads into the port and computes
the same forward as the JAX model (rtol 1e-5), and the port's file loads
into reart_tpu's `load_torch_*` (parameters and state exactly); `--resume`
of a zip file gives the results of `--resume` of the pickle checkpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import checkpoint as jck
from reart_tpu.models import kinematic as jk
from reart_tpu.models.base_model import base_forward as jax_base_forward
from reart_tpu.models.base_model import init_base_params
from reart_tpu_torch import checkpoint as ck
from reart_tpu_torch.interop import (
    base_params_from_jax,
    base_params_to_numpy,
    kinematic_params_from_jax,
    kinematic_params_to_numpy,
)
from reart_tpu_torch.models.base_model import base_forward
from reart_tpu_torch.models.kinematic import kinematic_forward

torch.set_num_threads(1)

N, T = 50, 4
EDGES, ROOT = [(3, 1), (1, 0), (2, 0)], 0


def _base_tree(seed=0):
    tree = jax.tree.map(np.asarray, init_base_params(
        jax.random.PRNGKey(seed), 5, T - 1))
    rng = np.random.RandomState(seed)
    tree["proposal_6d"] = tree["proposal_6d"] + (
        0.1 * rng.randn(*tree["proposal_6d"].shape)).astype(np.float32)
    tree["proposal_t"] = (0.1 * rng.randn(*tree["proposal_t"].shape)
                          ).astype(np.float32)
    return tree


def _kinematic(prismatic, seed=0):
    """A 4-part JAX KinematicState and parameters (prismatic joints and a
    root trajectory with `prismatic`)."""
    rng = np.random.RandomState(seed)
    e = len(EDGES)
    axis = rng.randn(e, 3).astype(np.float32)
    kw = dict(axis_list=axis / np.linalg.norm(axis, axis=1, keepdims=True),
              moment_list=0.3 * rng.randn(e, 3).astype(np.float32),
              theta_list=0.4 * rng.randn(T - 1, e).astype(np.float32))
    joint_types = None
    if prismatic:
        kw["distance_list"] = 0.2 * rng.randn(T - 1, e).astype(np.float32)
        kw["root_trans"] = np.tile(np.eye(4, dtype=np.float32), (T - 1, 1, 1))
        joint_types = ["revolute", "prismatic", "revolute"]
    cano = rng.randn(N, 3).astype(np.float32)
    seg = np.concatenate([np.arange(e + 1), rng.randint(0, e + 1, N - e - 1)])
    state = jk.make_kinematic_state(seg, cano, EDGES, ROOT,
                                    joint_types=joint_types,
                                    has_root_trans=prismatic)
    params = jax.tree.map(np.asarray, jk.init_kinematic_params(T - 1, e,
                                                                **kw))
    return params, state, cano


def _same_state(a, b):
    for k in ("seg_part", "cano_pc", "path_edges"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    pa, pb = a.prismatic_mask, b.prismatic_mask
    assert (pa is None) == (pb is None)
    if pa is not None:
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert tuple(map(tuple, a.edges)) == tuple(map(tuple, b.edges))
    assert tuple(a.reverse_topo) == tuple(b.reverse_topo)
    assert bool(a.has_root_trans) == bool(b.has_root_trans)


def test_base_round_trip(tmp_path):
    model = base_params_from_jax(_base_tree(), device="cpu")
    path = str(tmp_path / "base.pth")
    ck.save_torch_base(path, model, 0.5, 2)
    assert ck.is_torch_checkpoint(path)
    back, tau, cano_idx = ck.load_torch_base(path, device="cpu")
    assert (tau, cano_idx) == (0.5, 2)
    for (k, v), w in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(v, w), k
    sd = torch.load(path, weights_only=False)["state_dict"]
    assert sd["seg_head.model.0.weight"].shape == (128, 3, 1)
    assert sd["seg_head.model.2.weight"].shape == (5, 128, 1)


@pytest.mark.parametrize("prismatic", [False, True])
def test_kinematic_round_trip(tmp_path, prismatic):
    params, jstate, _ = _kinematic(prismatic)
    model, state = kinematic_params_from_jax(params, jstate, device="cpu")
    path = str(tmp_path / "kin.pth")
    ck.save_torch_kinematic(path, model, state, 1.0, 0)
    back, back_state, tau, cano_idx = ck.load_torch_kinematic(path,
                                                             device="cpu")
    assert (tau, cano_idx) == (1.0, 0)
    for (k, v), w in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(v, w), k
    _same_state(state, back_state)
    payload = torch.load(path, weights_only=False)
    assert payload["edge_index"] == {"3_1": 0, "1_0": 1, "2_0": 2}
    assert payload["paths_to_base"][3] == [3, 1, 0]
    assert ("joint_type_list" in payload) == prismatic


def test_jax_base_file_loads_into_the_port(tmp_path):
    tree = _base_tree(1)
    path = str(tmp_path / "jax_base.pth")
    jck.save_torch_base(path, jax.tree.map(jnp.asarray, tree), 0.7, 1)
    model, tau, cano_idx = ck.load_torch_base(path, device="cpu")
    assert (tau, cano_idx) == (0.7, 1)
    cano = np.random.RandomState(0).randn(N, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax_base_forward(jax.tree.map(jnp.asarray, tree),
                           jnp.asarray(cano), key, 1.0)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (N, 5))))
    got = base_forward(model, torch.from_numpy(cano), noise, 1.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)


def test_port_base_file_loads_into_jax(tmp_path):
    model = base_params_from_jax(_base_tree(2), device="cpu")
    path = str(tmp_path / "port_base.pth")
    ck.save_torch_base(path, model, 0.3, 0)
    tree, tau, cano_idx = jck.load_torch_base(path)
    assert (tau, cano_idx) == (0.3, 0)
    ref = base_params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("prismatic", [False, True])
def test_jax_kinematic_file_loads_into_the_port(tmp_path, prismatic):
    params, jstate, cano = _kinematic(prismatic, seed=3)
    path = str(tmp_path / "jax_kin.pth")
    jck.save_torch_kinematic(path, jax.tree.map(jnp.asarray, params),
                             jstate, 1.0, 0)
    model, state, _, _ = ck.load_torch_kinematic(path, device="cpu")
    _same_state(jstate, state)
    ref = jk.kinematic_forward(jax.tree.map(jnp.asarray, params), jstate,
                               jnp.asarray(cano))
    got = kinematic_forward(model, state, torch.from_numpy(cano))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prismatic", [False, True])
def test_port_kinematic_file_loads_into_jax(tmp_path, prismatic):
    params, jstate, _ = _kinematic(prismatic, seed=4)
    model, state = kinematic_params_from_jax(params, jstate, device="cpu")
    path = str(tmp_path / "port_kin.pth")
    ck.save_torch_kinematic(path, model, state, 1.0, 0)
    tree, back_state, _, _ = jck.load_torch_kinematic(path)
    ref = kinematic_params_to_numpy(model)
    assert sorted(tree) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ref[k], np.asarray(tree[k]), err_msg=k)
    _same_state(jstate, back_state)


def test_resume_from_a_zip_file(tmp_path):
    """Both stages of the toy robot: `--resume <zip> --evaluate` gives the
    numbers of `--resume <model.ckpt.pkl> --evaluate`; a zip file of
    another canonical frame is refused."""
    from reart_tpu_torch import cli
    from reart_tpu_torch.data.synth import make_toy_robot_sample

    sample = make_toy_robot_sample()
    common = ["robot", "--device", "cpu", "--num_parts", "5", "--silence",
              "--start_tau", "2", "--end_tau", "0.5"]

    def run(extra, name):
        args = cli.build_parser().parse_args(common + extra)
        return cli.run_sample(args, "robot", dict(sample),
                              str(tmp_path / name), device="cpu")

    run(["--n_iter", "200", "--assign_iter", "120", "--use_assign_loss",
         "--use_flow_loss", "--flow_provider", "gt"], "base")
    base_pkl = str(tmp_path / "base" / "model.ckpt.pkl")
    run(["--model", "kinematic", "--base_result_path",
         str(tmp_path / "base" / "result.pkl"), "--n_iter", "20",
         "--assign_iter", "0", "--downsample", "2", "--tree_search", "0"],
        "kin")
    kin_pkl = str(tmp_path / "kin" / "model.ckpt.pkl")

    base = ck.load_checkpoint(base_pkl)
    ck.save_torch_base(str(tmp_path / "base.pth"),
                       ck.base_model_from_checkpoint(base, device="cpu"),
                       base["tau"], base["cano_idx"])
    kin = ck.load_checkpoint(kin_pkl)
    model, state = ck.kinematic_model_from_checkpoint(kin, device="cpu")
    ck.save_torch_kinematic(str(tmp_path / "kin.pth"), model, state,
                            kin["tau"], kin["cano_idx"])
    for model_flag, pkl, zipped in (("base", base_pkl, "base.pth"),
                                    ("kinematic", kin_pkl, "kin.pth")):
        extra = ["--model", model_flag, "--evaluate", "--resume"]
        ref = run(extra + [pkl], f"eval_{model_flag}_pkl")
        got = run(extra + [str(tmp_path / zipped)], f"eval_{model_flag}_zip")
        assert got == ref, model_flag
        assert np.isfinite(list(got.values())).all()
    with pytest.raises(ValueError, match="cano_idx"):
        run(["--evaluate", "--cano_idx", "1", "--resume",
             str(tmp_path / "base.pth")], "wrong_frame")

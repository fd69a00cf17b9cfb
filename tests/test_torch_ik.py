"""Port parity for inverse kinematics on the CPU: the AMSGrad update the
port writes out against `optax.amsgrad` step by step (and the finding that
`torch.optim.Adam(amsgrad=True)` is another update), the kinematic and the
base solve against the JAX package's on the same inputs, and the whole
retargeting error."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import ik as jax_ik
from reart_tpu.models import kinematic as jk
from reart_tpu.models.base_model import init_base_params
from reart_tpu_torch import ik
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.interop import (
    base_params_from_jax,
    kinematic_params_from_jax,
)
from reart_tpu_torch.models.kinematic import kinematic_forward

torch.set_num_threads(1)

GRADS = np.random.RandomState(0).randn(10, 2, 3).astype(np.float32) \
    * np.logspace(0, -2, 10, dtype=np.float32)[:, None, None]


def _optax_steps(lr):
    tx = optax.amsgrad(lr)
    params = jnp.ones((2, 3), jnp.float32)
    state = tx.init(params)
    out = []
    for g in GRADS:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        out.append(np.asarray(params))
    return out


@pytest.mark.parametrize("step", range(10))
def test_amsgrad_update_matches_optax(step):
    """A fixed gradient sequence that shrinks 100-fold over 10 steps, so the
    running maximum of the second moment is what decides the late steps."""
    ref = _optax_steps(0.1)
    params = [torch.ones(2, 3)]
    state = ik.amsgrad_init(params)
    for g in GRADS[: step + 1]:
        ik.amsgrad_update(params, [torch.from_numpy(g)], state, 0.1)
    # the same float32 arithmetic in the same order: rtol 1e-6
    np.testing.assert_allclose(params[0].numpy(), ref[step], rtol=1e-6)


def test_torch_adam_amsgrad_is_another_update():
    """Why the port does not use torch.optim.Adam(amsgrad=True): it keeps
    the maximum of the raw second moment and corrects the bias afterwards,
    optax the maximum of the corrected one. On the shrinking sequence the
    two part ways from the second step on."""
    ref = _optax_steps(0.1)
    p = torch.nn.Parameter(torch.ones(2, 3))
    opt = torch.optim.Adam([p], lr=0.1, amsgrad=True)
    diffs = []
    for g, r in zip(GRADS, ref):
        p.grad = torch.from_numpy(g).clone()
        opt.step()
        diffs.append(np.abs(p.detach().numpy() - r).max())
    assert diffs[0] < 1e-6
    assert max(diffs[1:]) > 1e-3


def _hinge():
    """tests/test_ik.py's one-joint system: a hinge about z through the
    origin, part 1 turned by 0.7 rad."""
    rng = np.random.RandomState(0)
    n = 64
    cano = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    seg = (cano[:, 0] > 0).astype(np.int32)
    jstate = jk.make_kinematic_state(seg, cano, edges=[(1, 0)], root=0)
    jparams = jk.init_kinematic_params(
        pose_len=2, num_edges=1,
        axis_list=np.array([[0.0, 0.0, 1.0]], np.float32),
        moment_list=np.zeros((1, 3), np.float32))
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    idx = np.concatenate([np.nonzero(seg == 0)[0][:2],
                          np.nonzero(seg == 1)[0][:2]])
    s_cano = cano[idx]
    s_novel = s_cano.copy()
    s_novel[2:] = s_novel[2:] @ rot.T
    expected = cano.copy()
    expected[seg == 1] = expected[seg == 1] @ rot.T
    return jparams, jstate, cano, s_cano, s_novel, expected


def test_ik_solve_kinematic_recovers_the_hinge_angle_as_jax_does():
    jparams, jstate, cano, s_cano, s_novel, expected = _hinge()
    theta_ref, losses_ref = jax_ik.ik_solve_kinematic(
        jparams, jstate, jnp.asarray(s_cano), jnp.asarray(s_novel),
        n_iter=200)
    params, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")
    theta, losses = ik.ik_solve_kinematic(
        params, state, torch.from_numpy(s_cano), torch.from_numpy(s_novel),
        n_iter=200)
    assert float(losses[-1]) < 1e-4
    assert abs(float(theta[0, 0]) - 0.7) < 1e-3
    with torch.no_grad():
        pc, _, _ = kinematic_forward(params, state, torch.from_numpy(cano),
                                     theta_list=theta)
    assert np.abs(pc[0].numpy() - expected).max() < 0.05
    # the loss curve while it is above float32 noise of the squared error:
    # rtol 1e-3 (200 steps of the same update on a 1-parameter problem)
    ref = np.asarray(losses_ref)
    live = ref > 1e-6
    assert live.sum() > 20
    np.testing.assert_allclose(losses.numpy()[live], ref[live], rtol=1e-3)
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_ref),
                               atol=1e-4)


def test_ik_solve_base_recovers_a_translation():
    key = jax.random.PRNGKey(0)
    jparams = init_base_params(key, num_parts=2, pose_len=3)
    params = base_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    rng = np.random.RandomState(1)
    cano = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    s_cano = cano[:4]
    s_novel = s_cano + np.array([0.3, -0.2, 0.1], np.float32)
    opt, losses = ik.ik_solve_base(
        params, torch.from_numpy(s_cano), torch.from_numpy(s_novel),
        torch.zeros(4, 2), n_iter=200)
    assert float(losses[-1]) < 1e-3
    assert opt["proposal_6d"].shape == (1, 2, 6)
    assert opt["proposal_t"].shape == (1, 2, 3)


def test_retarget_error_matches_jax():
    """`ik` over the toy robot's two novel poses from its GT tree and
    screws, against the JAX package's `ik` on a dataset object holding the
    same sample: the mean error in cm, rtol 1e-3."""
    sample = make_toy_robot_sample()
    seg, cano = sample["gt_cano_part"], sample["cano_pc"]
    axis = np.array([[0, 0, 1], [0, 0, 1]], np.float32)
    jstate = jk.make_kinematic_state(seg, cano, [(1, 0), (2, 0)], 0)
    jparams = jk.init_kinematic_params(
        3, 2, axis_list=axis, moment_list=np.zeros((2, 3), np.float32),
        theta_list=np.array([[0.25, -0.2], [0.5, -0.4], [0.75, -0.6]],
                            np.float32))
    class Dataset:
        pose_list = sample["pose_list"]
        cano_idx = sample["cano_idx"]
        novel_pose_list = sample["novel_pose_list"]

        def __getitem__(self, item):
            return sample

    ref = jax_ik.ik(Dataset(), "kinematic", jparams, state=jstate)
    params, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")
    got = ik.ik(sample, "kinematic", params, state=state, device="cpu")
    assert len(sample["novel_pose_list"]) == 2
    assert 0.0 <= got < 1.0  # GT screws retarget to well under a cm
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    assert ik.ik(dict(sample, novel_pose_list=[]), "kinematic", params,
                 state=state, device="cpu") == 9999.0

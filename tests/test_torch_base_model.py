"""Port parity: the relaxation model, its geometry, schedule and losses
(reart_tpu_torch.models / geometry / train.schedules / losses / interop)
against the JAX package on the same numpy inputs and the same Gumbel draw."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu.geometry import rotation_6d_to_matrix as jax_r6d
from reart_tpu.geometry import rt_to_transform as jax_rt
from reart_tpu.losses import assignment_loss as jax_assignment_loss
from reart_tpu.losses import flow_loss as jax_flow_loss
from reart_tpu.models.base_model import base_forward as jax_base_forward
from reart_tpu.models.base_model import (
    compute_pc_transform as jax_compute_pc_transform,
)
from reart_tpu.models.base_model import init_base_params
from reart_tpu.train.schedules import tau_cosine as jax_tau_cosine
from reart_tpu_torch.geometry import rotation_6d_to_matrix, rt_to_transform
from reart_tpu_torch.interop import base_params_from_jax, base_params_to_numpy
from reart_tpu_torch.losses import assignment_loss, flow_loss
from reart_tpu_torch.models import (
    MLP,
    BaseModel,
    base_forward,
    compute_pc_transform,
    gumbel_noise,
)
from reart_tpu_torch.train.schedules import tau_cosine

N, P, T1 = 200, 5, 3


def _jax_params(seed=0):
    """JAX init with seeded non-identity proposals."""
    params = init_base_params(jax.random.PRNGKey(seed), num_parts=P,
                              pose_len=T1)
    rng = np.random.RandomState(seed)
    params["proposal_6d"] = params["proposal_6d"] + jnp.asarray(
        0.1 * rng.randn(T1, P, 6).astype(np.float32))
    params["proposal_t"] = jnp.asarray(
        0.1 * rng.randn(T1, P, 3).astype(np.float32))
    return jax.tree.map(np.asarray, params)


def test_interop_round_trip():
    tree = _jax_params()
    back = base_params_to_numpy(base_params_from_jax(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tau", [5.0, 1.0])
def test_base_forward_matches_jax_with_same_gumbel_draw(tau):
    tree = _jax_params(1)
    cano = np.random.RandomState(1).randn(N, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.gumbel(key, (N, P), jnp.float32))
    pc_ref, seg_ref, trans_ref = jax_base_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(cano), key, tau)
    model = base_params_from_jax(tree, device="cpu")
    with torch.no_grad():
        pc, seg, trans = base_forward(model, torch.from_numpy(cano),
                                      torch.from_numpy(noise), tau)
    # rtol 1e-5 / atol 1e-6: same formulas, matmul sums in another order
    np.testing.assert_allclose(pc.numpy(), np.asarray(pc_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_ref))
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_ref),
                               rtol=1e-5, atol=1e-6)


def test_rotation_6d_and_rt_to_transform_match_jax():
    rng = np.random.RandomState(2)
    d6 = rng.randn(4, 7, 6).astype(np.float32)
    t = rng.randn(4, 7, 3).astype(np.float32)
    r_ref = np.asarray(jax_r6d(jnp.asarray(d6)))
    r = rotation_6d_to_matrix(torch.from_numpy(d6))
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-5, atol=1e-6)
    m_ref = np.asarray(jax_rt(jnp.asarray(r_ref), jnp.asarray(t)))
    m = rt_to_transform(torch.from_numpy(r_ref), torch.from_numpy(t))
    np.testing.assert_array_equal(m.numpy(), m_ref)


def test_compute_pc_transform_matches_jax():
    rng = np.random.RandomState(3)
    cano = rng.randn(N, 3).astype(np.float32)
    rot = np.asarray(jax_r6d(jnp.asarray(rng.randn(2, P, 6), jnp.float32)))
    pose = np.asarray(jax_rt(jnp.asarray(rot),
                             jnp.asarray(rng.randn(2, P, 3), jnp.float32)))
    part = rng.randint(0, P, N)
    ref = jax_compute_pc_transform(jnp.asarray(cano), jnp.asarray(pose),
                                   jnp.asarray(part))
    got = compute_pc_transform(torch.from_numpy(cano), torch.from_numpy(pose),
                               torch.from_numpy(part))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("cur", [1, 250, 999, 1000])
def test_tau_cosine_matches_jax(cur):
    ref = float(jax_tau_cosine(cur, 1000, 1.0, 5.0))
    assert math.isclose(float(tau_cosine(cur, 1000, 1.0, 5.0)), ref,
                        rel_tol=1e-6)


@pytest.mark.parametrize("robust", [False, True])
def test_flow_loss_matches_jax(robust):
    rng = np.random.RandomState(4)
    gt = rng.randn(3, 50, 3).astype(np.float32)
    pred = rng.randn(3, 50, 3).astype(np.float32)
    mask = rng.rand(3, 50) < 0.5
    ref = float(jax_flow_loss(jnp.asarray(gt), jnp.asarray(pred),
                              jnp.asarray(mask), robust=robust))
    got = flow_loss(torch.from_numpy(gt), torch.from_numpy(pred),
                    torch.from_numpy(mask), robust=robust)
    assert math.isclose(got.item(), ref, rel_tol=1e-5)


def test_assignment_loss_matches_jax():
    rng = np.random.RandomState(5)
    src = rng.randn(3, 40, 3).astype(np.float32)
    tgt = rng.randn(3, 40, 3).astype(np.float32)
    perm = np.stack([rng.permutation(40) for _ in range(3)])
    ref = float(jax_assignment_loss(jnp.asarray(src), jnp.asarray(tgt),
                                    jnp.asarray(perm)))
    got = assignment_loss(torch.from_numpy(src), torch.from_numpy(tgt),
                          torch.from_numpy(perm))
    assert math.isclose(got.item(), ref, rel_tol=1e-5)


def test_mlp_init_keeps_torch_default_bounds():
    g = torch.Generator().manual_seed(0)
    mlp = MLP((3, 128, 20), generator=g)
    first, last = mlp.layers
    assert last.bias is None
    assert first.weight.abs().max() <= 1 / math.sqrt(3)
    assert first.bias.abs().max() <= 1 / math.sqrt(3)
    assert last.weight.abs().max() <= 1 / math.sqrt(128)
    # an explicit generator makes the init reproducible
    again = MLP((3, 128, 20), generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[0].weight, first.weight)


def test_base_model_init_is_identity_pose():
    model = BaseModel(P, T1, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    cano = torch.from_numpy(
        np.random.RandomState(6).randn(N, 3).astype(np.float32))
    noise = gumbel_noise((N, P), torch.Generator().manual_seed(1))
    assert torch.isfinite(noise).all()
    with torch.no_grad():
        pc, _, _ = model(cano, noise, 5.0)
    np.testing.assert_allclose(pc.numpy(), np.broadcast_to(cano.numpy(),
                                                           pc.shape),
                               rtol=1e-5, atol=1e-5)

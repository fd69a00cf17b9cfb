"""Port parity: reart_tpu_torch.geometry against reart_tpu.geometry on the
same float32 numpy inputs, the singular inputs of tests/test_geometry.py
included, plus that file's round-trip properties on the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reart_tpu import geometry as JG
from reart_tpu.geometry import dq as JG_dq
from reart_tpu_torch import geometry as TG

# float32 elementwise chains; libm and XLA round sin/cos/atan2 differently
TOL = dict(rtol=1e-5, atol=1e-6)


def random_rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q.astype(np.float32)


def random_transforms(rng, n, t_scale=1.0):
    out = np.zeros((n, 4, 4), np.float32)
    out[:, :3, :3] = random_rotations(rng, n)
    out[:, :3, 3] = rng.randn(n, 3) * t_scale
    out[:, 3, 3] = 1.0
    return out


def rotz(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[c, -s], [s, c]]
    return m


def singular_transforms():
    """Identity, pure translations, a half turn and tiny rotations: the
    `where` branches of dq_to_screw and the log maps."""
    t = np.stack([np.eye(4, dtype=np.float32)] * 8)
    t[1, :3, 3] = [0.3, -0.2, 0.1]          # pure translation
    t[2, :3, 3] = [-0.3, -0.2, -0.1]        # pure translation, axis flips
    t[3] = rotz(np.pi)                      # half turn
    t[4] = rotz(1e-4)                       # tiny rotation
    t[5] = rotz(1e-4)
    t[5, :3, 3] = [0.0, 0.0, 0.2]
    t[6] = rotz(-0.7)                       # axis against (1, 1, 1)
    t[7] = rotz(2.5)
    t[7, :3, 3] = [0.1, 0.2, 0.3]
    return t


def _compare(got, ref, **tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, **(tol or TOL))


def _inputs():
    rng = np.random.RandomState(0)
    w = rng.randn(64, 3).astype(np.float32)
    w_small = (1e-3 * rng.randn(16, 3)).astype(np.float32)
    w_small[0] = 0.0
    rots = random_rotations(rng, 64)
    rots_sing = np.concatenate([singular_transforms()[:, :3, :3], rots[:8]])
    trans = random_transforms(rng, 64, 0.5)
    trans_all = np.concatenate([singular_transforms(), trans])
    log6 = (0.7 * rng.randn(64, 6)).astype(np.float32)
    log6[0] = 0.0
    quat = rng.randn(64, 4).astype(np.float32)
    quat[0] = [1, 0, 0, 0]
    quat[1] = [-1, 0, 0, 0]
    dquat = rng.randn(64, 8).astype(np.float32)
    x = np.linspace(-1.2, 1.2, 41).astype(np.float32)
    return dict(w=w, w_small=w_small, rots=rots, rots_sing=rots_sing,
                trans=trans, trans_all=trans_all, log6=log6, quat=quat,
                dquat=dquat, x=x, d6=rng.randn(64, 6).astype(np.float32),
                skew=np.asarray(JG.hat(jnp.asarray(w))))


# (function name, names of its array inputs, tolerance override)
CASES = [
    ("hat", ["w"], {}),
    ("hat_inv", ["skew"], {}),
    ("so3_exp_map", ["w"], {}),
    ("so3_exp_map", ["w_small"], {}),
    ("so3_log_map", ["rots"], {}),
    ("so3_log_map", ["rots_sing"], {}),
    ("so3_rotation_angle", ["rots_sing"], {}),
    ("acos_linear_extrapolation", ["x"], {}),
    ("se3_exp_map", ["log6"], {}),
    ("se3_exp_tw", ["w", "w_small4"], {}),
    ("inverse_transformation", ["trans_all"], {}),
    ("matrix_to_quaternion", ["rots_sing"], {}),
    ("matrix_to_quaternion", ["rots"], {}),
    ("quaternion_to_axis_angle", ["quat"], {}),
    ("standardize_quaternion", ["quat"], {}),
    ("rotation_6d_to_matrix", ["d6"], {}),
    ("matrix_to_rotation_6d", ["rots"], {}),
    ("q_mul", ["quat", "quat_b"], {}),
    ("q_conjugate", ["quat"], {}),
    ("q_normalize", ["quat"], {}),
    ("q_angle", ["quat"], {}),
    ("dq_mul", ["dquat", "dquat_b"], {}),
    ("dq_normalize", ["dquat"], {}),
    ("dq_translation", ["dquat"], {}),
    ("dq_quaternion_conjugate", ["dquat"], {}),
    ("wrap_angle", ["angles"], {}),
    ("transform_to_dq", ["trans_all"], {}),
]


@pytest.mark.parametrize("name,args,tol", CASES,
                         ids=[f"{c[0]}-{'-'.join(c[1])}" for c in CASES])
def test_function_matches_jax(name, args, tol):
    data = _inputs()
    data["w_small4"] = data["w"][::-1].copy() * 0.3
    data["quat_b"] = data["quat"][::-1].copy()
    data["dquat_b"] = data["dquat"][::-1].copy()
    data["angles"] = np.concatenate([
        np.linspace(-9, 9, 37), [np.pi, -np.pi, 3 * np.pi]]).astype(np.float32)
    arrays = [data[a] for a in args]
    jax_fn = getattr(JG, name, None) or getattr(JG_dq, name)
    ref = jax_fn(*[jnp.asarray(a) for a in arrays])
    got = getattr(TG, name)(*[torch.from_numpy(a.copy()) for a in arrays])
    _compare(got, ref, **tol)


def test_se3_log_map_matches_jax():
    rng = np.random.RandomState(1)
    log = (0.7 * rng.randn(64, 6)).astype(np.float32)
    t = np.asarray(JG.se3_exp_map(jnp.asarray(log)))
    ref = JG.se3_log_map(jnp.asarray(t))
    got = TG.se3_log_map(torch.from_numpy(t.copy()))
    _compare(got, ref)
    np.testing.assert_allclose(got.numpy(), log, atol=1e-3)  # round trip


@pytest.mark.parametrize("which", ["random", "singular"])
def test_dq_to_screw_matches_jax(which):
    t = (random_transforms(np.random.RandomState(2), 128, 0.5)
         if which == "random" else singular_transforms())
    dq = np.asarray(JG.transform_to_dq(jnp.asarray(t)))
    ref = JG.dq_to_screw(jnp.asarray(dq))
    got = TG.dq_to_screw(torch.from_numpy(dq.copy()))
    assert all(torch.isfinite(g).all() for g in got)
    _compare(got, ref)
    if which == "singular":
        assert float(got[0][0, 0]) == 1.0            # identity guard
        np.testing.assert_allclose(float(got[2][0]), 1e-6)


@pytest.mark.parametrize("pin", ["revolute", "prismatic", "none"])
def test_screw_transform_matches_jax(pin):
    t = np.concatenate([random_transforms(np.random.RandomState(3), 64, 0.5),
                        singular_transforms()])
    l, m, theta, d = [np.asarray(x) for x in JG.dq_to_screw(
        JG.transform_to_dq(jnp.asarray(t)))]
    if pin == "revolute":
        d = np.full_like(d, 1e-6)
    elif pin == "prismatic":
        theta = np.full_like(theta, 1e-6)
    args = (l, m, theta, d)
    ref_log = JG.screw_param_to_exponential_coordinates(
        *[jnp.asarray(a) for a in args])
    got_log = TG.screw_param_to_exponential_coordinates(
        *[torch.from_numpy(a.copy()) for a in args])
    _compare(got_log, ref_log)
    ref = JG.screw_transform(*[jnp.asarray(a) for a in args])
    got = TG.screw_transform(*[torch.from_numpy(a.copy()) for a in args])
    _compare(got, ref)
    ref2 = JG.transform_from_exponential_coordinates(ref_log)
    got2 = TG.transform_from_exponential_coordinates(
        torch.from_numpy(np.asarray(ref_log).copy()))
    _compare(got2, ref2)


def test_make_transform_matches_jax():
    rng = np.random.RandomState(4)
    r, t = random_rotations(rng, 8), rng.randn(8, 3).astype(np.float32)
    for tr in (t, t[..., None]):
        _compare(TG.make_transform(torch.from_numpy(r), torch.from_numpy(tr)),
                 JG.make_transform(jnp.asarray(r), jnp.asarray(tr)))


# ---------------------------------------------------------------------------
# the round-trip properties of tests/test_geometry.py, on the port
# ---------------------------------------------------------------------------

def test_transform_dq_screw_roundtrip():
    t = torch.from_numpy(random_transforms(np.random.RandomState(5), 128, 0.5))
    t2 = TG.screw_transform(*TG.dq_to_screw(TG.transform_to_dq(t)))
    np.testing.assert_allclose(t2.numpy(), t.numpy(), atol=1e-4)


def test_so3_and_6d_roundtrips():
    rng = np.random.RandomState(6)
    w = rng.randn(64, 3)
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)
         * rng.uniform(0.05, 2.4, (64, 1))).astype(np.float32)
    r = TG.so3_exp_map(torch.from_numpy(w))
    r2 = TG.so3_exp_map(TG.so3_log_map(r))
    np.testing.assert_allclose(r2.numpy(), r.numpy(), atol=2e-4)
    rot = torch.from_numpy(random_rotations(rng, 32))
    np.testing.assert_allclose(
        TG.rotation_6d_to_matrix(TG.matrix_to_rotation_6d(rot)).numpy(),
        rot.numpy(), atol=1e-6)
    inv = TG.inverse_transformation(
        torch.from_numpy(random_transforms(rng, 32)))
    assert inv.shape == (32, 4, 4)


def test_screw_pinning():
    l = torch.tensor([[0.0, 0.0, 1.0]])
    m = torch.zeros((1, 3))
    t = TG.screw_transform(l, m, torch.tensor([1e-6]), torch.tensor([0.37]))
    np.testing.assert_allclose(t[0, :3, 3].numpy(), [0, 0, 0.37], atol=1e-5)
    np.testing.assert_allclose(t[0, :3, :3].numpy(), np.eye(3), atol=1e-4)
    t = TG.screw_transform(l, m, torch.tensor([0.7]), torch.tensor([1e-6]))
    c, s = np.cos(0.7), np.sin(0.7)
    np.testing.assert_allclose(t[0, :3, :3].numpy(),
                               [[c, -s, 0], [s, c, 0], [0, 0, 1]], atol=1e-5)
    np.testing.assert_allclose(t[0, :3, 3].numpy(), [0, 0, 0], atol=1e-5)


def test_grad_through_screw_chain_is_finite_at_identity():
    t0 = random_transforms(np.random.RandomState(7), 4, 0.3)
    t0[1] = np.eye(4)
    x = torch.from_numpy(t0).requires_grad_(True)
    t2 = TG.screw_transform(*TG.dq_to_screw(TG.transform_to_dq(x)))
    torch.sum((t2 - x) ** 2).backward()
    assert torch.isfinite(x.grad).all()

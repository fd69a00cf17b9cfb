"""Port parity: the ball query (reart_tpu_torch.ops.cuda_nn.ball_query, on
the CPU the plain version of csrc/ball_query.cu) and three_interpolate
against the JAX package on the same numpy inputs.

Indices must be equal. Against the Pallas kernel in interpret mode (the same
diff^2 distance in the same order of additions, compared with the same
float32 radius^2) on any input, a point exactly at the radius included;
against `sampling.ball_query` (the cross-term distance) on clouds whose
coordinates are multiples of 1/64, where both formulas are exact and no
squared distance lies within 8e-5 of radius^2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.interpolate import three_interpolate as jax_three
from reart_tpu.ops.pallas_nn import ball_query_pallas
from reart_tpu.ops.sampling import ball_query as jax_ball_query
from reart_tpu_torch.ops import cuda_nn
from reart_tpu_torch.ops.interpolate import three_interpolate
from reart_tpu_torch.ops.sampling import ball_query

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pallas(radius, k, xyz, new_xyz):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(ball_query_pallas(radius, k, jnp.asarray(xyz),
                                            jnp.asarray(new_xyz)))


def _cloud(seed, b, n, s, duplicates=False):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3).astype(np.float32)
    if duplicates:  # every point appears twice, far apart in index
        xyz[:, n // 2: 2 * (n // 2)] = xyz[:, : n // 2]
    new_xyz = xyz[:, rng.permutation(n)[:s]].copy()
    return xyz, new_xyz


# (n, s, radius, k, duplicates): fewer than k hits for most centroids
# (0.05), about k (0.2, 16), far more than k (0.4, 8); n and s that are no
# multiple of 32, and ones that are
@pytest.mark.parametrize("n,s,radius,k,dup", [
    (300, 50, 0.05, 32, False),
    (300, 50, 0.2, 16, False),
    (300, 50, 0.4, 8, False),
    (256, 64, 0.2, 64, False),
    (601, 97, 0.1, 128, False),
    (260, 40, 0.2, 16, True),
])
def test_ball_query_plain_matches_pallas_interpret(n, s, radius, k, dup):
    xyz, new_xyz = _cloud(k, 2, n, s, duplicates=dup)
    ref = _pallas(radius, k, xyz, new_xyz)
    got = ball_query(radius, k, _t(xyz), _t(new_xyz))
    assert got.dtype == torch.int64 and got.shape == (2, s, k)
    np.testing.assert_array_equal(got.numpy(), ref)
    counts = (((new_xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
              < radius * radius).sum(-1)
    # the case covers what its comment says: some centroid on each side of k
    if radius == 0.2 and k == 16 and not dup:
        assert (counts < k).any() and (counts > k).any()


def test_ball_query_edges_match_pallas_interpret():
    """An empty ball (index 0 throughout), exactly k hits, one hit, and a
    point exactly at the radius, which is outside (strict <)."""
    k, radius = 8, 0.25                      # radius^2 = 0.0625 exactly
    xyz = np.full((1, 70, 3), 5.0, np.float32)
    xyz[0, :, 0] += np.arange(70)            # far from every centroid
    xyz[0, 10:10 + k] = [1.0, 1.0, 1.0]      # exactly k hits of centroid 1
    xyz[0, 30] = [-3.0, 0.0, 0.0]            # the one hit of centroid 2
    xyz[0, 40] = [0.25, 0.0, 0.0]            # at the radius of centroid 3
    xyz[0, 41] = [0.0, np.float32(0.2499999), 0.0]      # just inside it
    new_xyz = np.array([[[-9.0, -9.0, -9.0], [1.0, 1.0, 1.0],
                         [-3.0, 0.1, 0.0], [0.0, 0.0, 0.0]]], np.float32)
    ref = _pallas(radius, k, xyz, new_xyz)
    got = ball_query(radius, k, _t(xyz), _t(new_xyz)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 0], np.zeros(k))
    np.testing.assert_array_equal(got[0, 1], np.arange(10, 10 + k))
    np.testing.assert_array_equal(got[0, 2], np.full(k, 30))
    np.testing.assert_array_equal(got[0, 3], np.full(k, 41))


@pytest.mark.parametrize("radius,k", [(0.3, 16), (0.15, 32), (0.45, 8)])
def test_ball_query_matches_jax_sort_formulation(radius, k):
    rng = np.random.RandomState(k)
    xyz = (rng.randint(0, 64, (2, 400, 3)) / 64.0).astype(np.float32)
    new_xyz = xyz[:, rng.permutation(400)[:60]].copy()
    d = ((new_xyz[:, :, None].astype(np.float64) - xyz[:, None]) ** 2).sum(-1)
    assert np.abs(d - radius * radius).min() > 5e-5  # clear of the boundary
    ref = np.asarray(jax_ball_query(radius, k, jnp.asarray(xyz),
                                    jnp.asarray(new_xyz)))
    got = ball_query(radius, k, _t(xyz), _t(new_xyz))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ball_query_wrapper_checks_and_small_clouds():
    xyz, new_xyz = _cloud(3, 2, 20, 5)
    # more slots than points: the hits, then the first hit
    got = ball_query(10.0, 32, _t(xyz), _t(new_xyz)).numpy()
    np.testing.assert_array_equal(got[..., :20],
                                  np.broadcast_to(np.arange(20), (2, 5, 20)))
    assert (got[..., 20:] == 0).all()
    assert cuda_nn.radius_sq(0.05) == float(np.float32(0.05 * 0.05))
    with pytest.raises(ValueError):
        ball_query(0.1, 0, _t(xyz), _t(new_xyz))
    with pytest.raises(ValueError):
        ball_query(0.1, 4, _t(xyz), _t(new_xyz[:1]))
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device
        ball_query(0.1, 4, _t(xyz).to("meta"), _t(new_xyz).to("meta"))
    before = cuda_nn.ball_query.launches
    ball_query(0.1, 4, _t(xyz), _t(new_xyz))
    assert cuda_nn.ball_query.launches == before  # the CPU launches nothing


@pytest.mark.parametrize("s", [1, 2, 40])
def test_three_interpolate_matches_jax(s):
    # the JAX function takes the cross-term distance, the port recomputes
    # diff^2 from the gathered points: on coordinates that are multiples of
    # 1/64 both are exact, and what is left is the rounding of the weights
    rng = np.random.RandomState(s)
    q = (rng.randint(0, 64, (2, 150, 3)) / 64.0).astype(np.float32)
    r = ((rng.randint(0, 64, (2, s, 3)) + 0.5) / 64.0).astype(np.float32)
    f = rng.randn(2, s, 7).astype(np.float32)
    ref = np.asarray(jax_three(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(f)))
    got = three_interpolate(_t(q), _t(r), _t(f))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_three_interpolate_gradients_reach_the_features():
    rng = np.random.RandomState(0)
    q = _t(rng.rand(1, 30, 3).astype(np.float32))
    r = _t(rng.rand(1, 9, 3).astype(np.float32))
    f = _t(rng.randn(1, 9, 4).astype(np.float32)).requires_grad_(True)
    three_interpolate(q, r, f).sum().backward()
    # the weights of every query sum to 1
    np.testing.assert_allclose(float(f.grad.sum()), 30 * 4, rtol=1e-5)

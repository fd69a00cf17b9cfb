"""Port parity: farthest-point sampling (reart_tpu_torch.ops.sampling and
the plain version of csrc/fps.cu) against the JAX package's Pallas kernel in
interpret mode and its fori_loop, on the same numpy inputs. Index sequences
must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.pallas_fps import fps_pallas
from reart_tpu.ops.sampling import _fps_loop
from reart_tpu.ops.sampling import index_points as jax_index_points
from reart_tpu_torch.ops import cuda_fps
from reart_tpu_torch.ops.sampling import (
    farthest_point_sample,
    index_points,
    masked_farthest_point_sample,
)

B, N, NPOINT = 2, 600, 64


def _cloud(seed):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)


def _mask(seed):
    m = np.random.RandomState(seed).rand(B, N) < 0.4
    m[:, :5] = False  # the start must be the first masked index, not 0
    return m


def _jax_loop(xyz, mask):
    start = jnp.argmax(jnp.asarray(mask), axis=-1).astype(jnp.int32)
    return np.asarray(_fps_loop(jnp.asarray(xyz), jnp.asarray(mask), start,
                                NPOINT))


def test_fps_matches_pallas_interpret():
    xyz = _cloud(0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fps_pallas(jnp.asarray(xyz), jnp.ones((B, N), bool),
                                    NPOINT))
    got = farthest_point_sample(torch.from_numpy(xyz), NPOINT)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fps_matches_fori_loop():
    xyz = _cloud(1)
    got = farthest_point_sample(torch.from_numpy(xyz), NPOINT)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_loop(xyz, np.ones((B, N), bool)))


def test_masked_fps_matches_pallas_interpret():
    xyz, mask = _cloud(2), _mask(2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fps_pallas(jnp.asarray(xyz), jnp.asarray(mask),
                                    NPOINT))
    got = masked_farthest_point_sample(torch.from_numpy(xyz),
                                       torch.from_numpy(mask), NPOINT)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert mask[np.arange(B)[:, None], got.numpy()].all()


def test_masked_fps_matches_fori_loop():
    xyz, mask = _cloud(3), _mask(3)
    got = masked_farthest_point_sample(torch.from_numpy(xyz),
                                       torch.from_numpy(mask), NPOINT)
    np.testing.assert_array_equal(got.numpy(), _jax_loop(xyz, mask))


def test_fps_ties_go_to_lowest_index():
    # duplicated points: every step after the first has ties
    xyz = np.repeat(_cloud(4)[:, :8], 4, axis=1)  # (B, 32, 3)
    got = farthest_point_sample(torch.from_numpy(xyz), 12)
    start = jnp.zeros((B,), jnp.int32)
    ref = _fps_loop(jnp.asarray(xyz), jnp.ones(xyz.shape[:2], bool), start,
                    12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_index_points_matches_jax():
    xyz = _cloud(5)
    idx = np.random.RandomState(5).randint(0, N, (B, 7, 3))
    ref = np.asarray(jax_index_points(jnp.asarray(xyz), jnp.asarray(idx)))
    got = index_points(torch.from_numpy(xyz), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fps_wrapper_checks_inputs():
    xyz = torch.from_numpy(_cloud(6))
    with pytest.raises(ValueError):
        cuda_fps.fps(xyz, torch.ones((B, N)), 4)  # mask must be bool
    with pytest.raises(ValueError):
        cuda_fps.fps(xyz.to("meta"), torch.ones((B, N), dtype=torch.bool,
                                                 device="meta"), 4)

"""Port parity: the neighbour kernels' plain versions (reart_tpu_torch.ops.
cuda_nn) and the Chamfer loss against the JAX package on the same numpy
inputs. Pallas kernels run in interpret mode, as tests/test_pallas_nn.py
runs them; on the CPU each port wrapper takes its plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.distance import chamfer_loss as jax_chamfer_loss
from reart_tpu.ops.distance import pairwise_sqdist as jax_pairwise_sqdist
from reart_tpu.ops.interpolate import blend_anchor_motion as jax_blend
from reart_tpu.ops.pallas_nn import blend3_pallas, nn1_bidir_coords_pallas
from reart_tpu_torch.ops import cuda_nn
from reart_tpu_torch.ops.distance import chamfer_loss, nearest_neighbor
from reart_tpu_torch.ops.interpolate import (
    blend_anchor_motion,
    blend_anchor_motion_batched,
)


def _clouds(seed, b, n, m):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


@pytest.mark.parametrize("n,m", [(300, 1500), (256, 1024)])
def test_nn1_bidir_plain_matches_pallas_interpret(n, m):
    src, tgt = _clouds(0, 2, n, m)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(x) for x in nn1_bidir_coords_pallas(
            jnp.asarray(src), jnp.asarray(tgt))]
    got = [x.numpy() for x in cuda_nn.nn1_bidir_coords(
        torch.from_numpy(src), torch.from_numpy(tgt))]
    fd, fi, fc, bd, bi, bc = got
    # indices and gathered coords exact; distances within rtol 1e-5 /
    # atol 1e-6 (same diff^2 formula, summation may differ by an ulp)
    np.testing.assert_array_equal(fi, ref[1])
    np.testing.assert_array_equal(bi, ref[4])
    np.testing.assert_array_equal(fc, ref[2])
    np.testing.assert_array_equal(bc, ref[5])
    np.testing.assert_allclose(fd, ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bd, ref[3], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m", [(300, 1500), (256, 1024)])
def test_nn1_bidir_plain_matches_jnp_cross_term(n, m):
    src, tgt = _clouds(3, 2, n, m)
    sq = np.asarray(jax_pairwise_sqdist(jnp.asarray(src), jnp.asarray(tgt)))
    fd, fi, _, bd, bi, _ = cuda_nn.nn1_bidir_coords(
        torch.from_numpy(src), torch.from_numpy(tgt))
    # indices exact on random data; distances within rtol 1e-4 / atol 1e-5:
    # the cross-term form loses digits to cancellation
    np.testing.assert_array_equal(fi.numpy(), sq.argmin(-1))
    np.testing.assert_array_equal(bi.numpy(), sq.argmin(-2))
    np.testing.assert_allclose(fd.numpy(), sq.min(-1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bd.numpy(), sq.min(-2), rtol=1e-4, atol=1e-5)


def test_nn1_bidir_all_ties_go_to_lowest_index():
    src = torch.zeros((1, 300, 3))
    tgt = torch.zeros((1, 700, 3))
    _, fi, _, _, bi, _ = cuda_nn.nn1_bidir_coords(src, tgt)
    assert int(fi.max()) == 0 and int(bi.max()) == 0


def _anchor_case(far_pad):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 300, 3).astype(np.float32)
    r = rng.randn(2, 700, 3).astype(np.float32)
    f = (0.05 * rng.randn(2, 700, 3)).astype(np.float32)
    if far_pad:  # the FlowContext padding: FAR anchors with zero flow
        r[:, 500:] = 1e6
        f[:, 500:] = 0.0
    return q, r, f


@pytest.mark.parametrize("far_pad", [False, True])
def test_blend3_plain_matches_pallas_interpret(far_pad):
    q, r, f = _anchor_case(far_pad)
    with pltpu.force_tpu_interpret_mode():
        out, md, fd = [np.asarray(x) for x in blend3_pallas(
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(f))]
    got_out, got_md, got_fd = [x.numpy() for x in cuda_nn.blend3(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(f))]
    # blend within rtol 1e-5 / atol 1e-6; the validity mask exact
    np.testing.assert_allclose(got_out, out, rtol=1e-5, atol=1e-6)
    # the squared anchor distance ||q||^2 + ||r||^2 - 2 q.r carries an
    # absolute cancellation error of a few ulps of ||q||^2 + ||r||^2
    np.testing.assert_allclose(got_md ** 2, md ** 2, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        (got_md <= got_fd) | (got_md <= 0.05), (md <= fd) | (md <= 0.05))


@pytest.mark.parametrize("far_pad", [False, True])
def test_blend_batched_matches_jax_blend(far_pad):
    q, r, f = _anchor_case(far_pad)
    ref = [jax_blend(jnp.asarray(q[i]), jnp.asarray(r[i]), jnp.asarray(f[i]),
                     return_mask=True) for i in range(2)]
    blended, mask = blend_anchor_motion_batched(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(f))
    for i in range(2):
        # normalise-then-blend (JAX) vs blend-then-normalise: rtol 1e-5
        np.testing.assert_allclose(blended[i].numpy(), np.asarray(ref[i][0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(ref[i][1]))


def test_blend_anchor_motion_matches_jax():
    q, r, f = _anchor_case(False)
    b_ref, m_ref = jax_blend(jnp.asarray(q[0]), jnp.asarray(r[0]),
                             jnp.asarray(f[0]), k=4, return_mask=True)
    blended, mask = blend_anchor_motion(
        torch.from_numpy(q[0]), torch.from_numpy(r[0]),
        torch.from_numpy(f[0]), k=4, return_mask=True)
    np.testing.assert_allclose(blended.numpy(), np.asarray(b_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(m_ref))


def test_nearest_neighbor_matches_jax():
    from reart_tpu.ops.distance import nearest_neighbor as jax_nn

    src, tgt = _clouds(7, 2, 200, 300)
    d_ref, i_ref = jax_nn(jnp.asarray(src), jnp.asarray(tgt))
    d, i = nearest_neighbor(torch.from_numpy(src), torch.from_numpy(tgt))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5,
                               atol=1e-6)


def test_chamfer_loss_value_and_grads_match_jax():
    src, tgt = _clouds(11, 3, 200, 260)
    val_ref, (g_src_ref, g_tgt_ref) = jax.value_and_grad(
        jax_chamfer_loss, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    s = torch.from_numpy(src).requires_grad_(True)
    t = torch.from_numpy(tgt).requires_grad_(True)
    val = chamfer_loss(s, t)
    val.backward()
    # rtol 1e-5: same gathers and residuals, sums in another order
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(g_src_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_tgt_ref),
                               rtol=1e-5, atol=1e-6)


def test_chamfer_constant_target_skips_its_scatter():
    src, tgt = _clouds(12, 2, 64, 80)
    s = torch.from_numpy(src).requires_grad_(True)
    t = torch.from_numpy(tgt)  # observed cloud: a constant
    chamfer_loss(s, t).backward()
    assert s.grad is not None and t.grad is None


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    src, tgt = _clouds(13, 1, 32, 48)
    before = (cuda_nn.nn1_bidir_coords.launches, cuda_nn.blend3.launches)
    cuda_nn.nn1_bidir_coords(torch.from_numpy(src), torch.from_numpy(tgt))
    cuda_nn.blend3(torch.from_numpy(src), torch.from_numpy(tgt),
                   torch.from_numpy(tgt))
    assert (cuda_nn.nn1_bidir_coords.launches,
            cuda_nn.blend3.launches) == before


def test_wrappers_raise_on_a_device_without_kernel():
    src = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        cuda_nn.nn1_bidir_coords(src, src)
    with pytest.raises(ValueError):
        cuda_nn.blend3(src, src, src)

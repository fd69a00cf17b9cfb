"""Port parity: farthest-point sampling (reart_tpu_torch.ops.sampling and
the plain version of csrc/fps.cu) against the JAX package's Pallas kernel in
interpret mode and its fori_loop, on the same numpy inputs. Index sequences
must be equal. And the fixed-order backward of `index_points` /
`three_interpolate` (ops.sampling.gather_rows) against autograd's own
backward of the gathers it replaced, bit for bit on the CPU."""

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

torch.set_num_threads(1)

B, N, NPOINT = 2, 600, 64


def _cloud(seed):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)


def _mask(seed):
    m = np.random.RandomState(seed).rand(B, N) < 0.4
    m[:, :5] = False  # the start must be the first masked index, not 0
    return m


def _jax_loop(xyz, mask, npoint=NPOINT):
    start = jnp.argmax(jnp.asarray(mask), axis=-1).astype(jnp.int32)
    return np.asarray(_fps_loop(jnp.asarray(xyz), jnp.asarray(mask), start,
                                npoint))


def _pallas(xyz, mask, npoint):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fps_pallas(jnp.asarray(xyz), jnp.asarray(mask),
                                     npoint))


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


@pytest.mark.parametrize("masked", [False, True])
def test_fps_past_the_cloud_size_repeats_the_lowest_index(masked):
    """The backbone's first layer always asks for 512 centroids; a cloud of
    fewer points runs out, every running distance is 0, and the lowest
    (masked) index wins each further pick, in the fori_loop, the Pallas
    kernel and the port alike."""
    xyz = _cloud(7)[:, :40]
    mask = np.ones((B, 40), bool)
    if masked:
        mask[:, :3] = False
        mask[:, 20:] = False
    got = masked_farthest_point_sample(torch.from_numpy(xyz),
                                       torch.from_numpy(mask), 64)
    start = jnp.argmax(jnp.asarray(mask), axis=-1).astype(jnp.int32)
    ref = np.asarray(_fps_loop(jnp.asarray(xyz), jnp.asarray(mask), start, 64))
    np.testing.assert_array_equal(got.numpy(), ref)
    with pltpu.force_tpu_interpret_mode():
        ker = np.asarray(fps_pallas(jnp.asarray(xyz), jnp.asarray(mask), 64))
    np.testing.assert_array_equal(got.numpy(), ker)
    n_in = int(mask[0].sum())
    assert len(set(got[0, :n_in].tolist())) == n_in  # every point once
    assert (got[:, n_in:] == (3 if masked else 0)).all()


@pytest.mark.parametrize("n", [1023, 1024, 1025, 4097])
def test_fps_at_the_kernels_per_thread_boundaries(n):
    """Clouds at and just past a boundary of the kernel's layout (points a
    thread holds in registers: 512 threads x 2, 4, 8, ...): the plain
    version against the fori_loop and the Pallas kernel."""
    xyz = np.random.RandomState(n).randn(B, n, 3).astype(np.float32)
    mask = np.ones((B, n), bool)
    got = farthest_point_sample(torch.from_numpy(xyz), 48).numpy()
    np.testing.assert_array_equal(got, _jax_loop(xyz, mask, 48))
    np.testing.assert_array_equal(got, _pallas(xyz, mask, 48))


@pytest.mark.parametrize("kind", ["all_equal", "single_point_mask",
                                  "npoint_past_masked_count"])
def test_fps_degenerate_clouds_and_masks(kind):
    """Ties everywhere (every point the same), a mask of one point, and more
    picks than masked points: after the masked points run out every pick is
    the lowest masked index."""
    n = 700
    xyz = np.random.RandomState(8).randn(B, n, 3).astype(np.float32)
    mask = np.ones((B, n), bool)
    if kind == "all_equal":
        xyz[:] = 0.25
    elif kind == "single_point_mask":
        mask[:] = False
        mask[0, 555] = mask[1, 0] = True
    else:
        mask[:] = False
        mask[:, 600:640] = True
    got = masked_farthest_point_sample(torch.from_numpy(xyz),
                                       torch.from_numpy(mask), 64).numpy()
    np.testing.assert_array_equal(got, _jax_loop(xyz, mask, 64))
    np.testing.assert_array_equal(got, _pallas(xyz, mask, 64))
    assert mask[np.arange(B)[:, None], got].all()


def _old_index_points(points, idx):
    """index_points as advanced indexing: autograd's backward of it is an
    accumulating index_put_."""
    rows = torch.arange(points.shape[0])[:, None]
    out = points[rows, idx.reshape(points.shape[0], -1)]
    return out.reshape(idx.shape + points.shape[-1:])


def _old_gather(points, idx):
    """The same through torch.gather: autograd's backward is scatter_add_."""
    flat = idx.reshape(points.shape[0], -1)
    out = torch.gather(points, 1,
                       flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(idx.shape + points.shape[-1:])


@pytest.mark.parametrize("old", [_old_index_points, _old_gather],
                         ids=["indexing", "gather"])
@pytest.mark.parametrize("c", [3, 64])
def test_gather_rows_backward_is_autograds_bit_for_bit(old, c):
    """index_points' fixed-order backward (gather_rows -> scatter_rows) on
    the CPU gives the bits of autograd's backward of advanced indexing and
    of torch.gather: both add a row's contributions in ascending order from
    zero. Many duplicates (50 points, 462 picks) and gradients over twelve
    orders of magnitude make the order of the additions show."""
    rng = np.random.RandomState(c)
    points = torch.from_numpy(rng.randn(2, 50, c).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 10, (2, 7, 66)))
    grad = torch.from_numpy((rng.randn(2, 7, 66, c)
                             * 10.0 ** rng.randint(-6, 6, (2, 7, 66, 1))
                             ).astype(np.float32))
    grads = []
    for fn in (index_points, old):
        p = points.clone().requires_grad_(True)
        out = fn(p, idx)
        out.backward(grad)
        grads.append((out.detach(), p.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_three_interpolate_backward_is_the_gathers_bit_for_bit():
    """three_interpolate with gather_rows against the same formula with
    torch.gather: equal values and equal gradients to the features and both
    clouds on the CPU."""
    from reart_tpu_torch.ops.cuda_nn import nn_topk
    from reart_tpu_torch.ops.interpolate import three_interpolate

    rng = np.random.RandomState(3)
    q0 = torch.from_numpy(rng.rand(2, 300, 3).astype(np.float32))
    r0 = torch.from_numpy(rng.rand(2, 40, 3).astype(np.float32))
    f0 = torch.from_numpy(rng.randn(2, 40, 32).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 300, 32).astype(np.float32))

    def old(q, r, f, eps=1e-8):
        _, idx = nn_topk(q, r, 3)

        def gather(ref):
            return _old_gather(ref, idx)

        diff = q[..., None, :] - gather(r)
        w = 1.0 / (torch.sum(diff * diff, dim=-1) + eps)
        w = w / torch.sum(w, dim=-1, keepdim=True)
        return torch.sum(gather(f) * w[..., None], dim=-2)

    runs = []
    for fn in (three_interpolate, old):
        args = [t.clone().requires_grad_(True) for t in (q0, r0, f0)]
        out = fn(*args)
        out.backward(g)
        runs.append([out.detach()] + [a.grad for a in args])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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

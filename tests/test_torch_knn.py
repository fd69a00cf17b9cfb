"""Port parity: the k-NN, 1-NN-with-coords and bidirectional 1-NN plain
versions (reart_tpu_torch.ops.cuda_nn) and their callers in ops/distance.py
and ops/interpolate.py against the JAX package on the same numpy inputs.
Pallas kernels run in interpret mode, as tests/test_pallas_nn.py runs them;
on the CPU each port wrapper takes its plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops import distance as jax_distance
from reart_tpu.ops.interpolate import blend_anchor_motion as jax_blend
from reart_tpu.ops.pallas_nn import (
    nn1_coords_pallas,
    nn_bidir_pallas,
    nn_topk_pallas,
)
from reart_tpu_torch import device_of, resolve_device
from reart_tpu_torch.ops import cuda_nn
from reart_tpu_torch.ops.distance import (
    chamfer,
    knn,
    knn_transfer_features,
    knn_transfer_labels,
    nearest_neighbor,
)
from reart_tpu_torch.ops.interpolate import blend_anchor_motion

torch.set_num_threads(1)

# same diff^2 formula in both packages; a sum may differ by an ulp
TOL = dict(rtol=1e-5, atol=1e-6)


def _clouds(seed, b, n, m, duplicates=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, 3).astype(np.float32)
    r = rng.randn(b, m, 3).astype(np.float32)
    if duplicates:  # every reference point appears twice, far apart in index
        r[:, m // 2: 2 * (m // 2)] = r[:, : m // 2]
        q[:, : n // 2] = r[:, : n // 2]
    return q, r


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n,m,dup", [(300, 500, False), (256, 512, False),
                                     (130, 260, True)])
def test_nn_topk_plain_matches_pallas_interpret(k, n, m, dup):
    q, r = _clouds(k, 2, n, m, duplicates=dup)
    with pltpu.force_tpu_interpret_mode():
        d_ref, i_ref = nn_topk_pallas(jnp.asarray(q), jnp.asarray(r), k)
    d, i = cuda_nn.nn_topk(_t(q), _t(r), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **TOL)


@pytest.mark.parametrize("n,m,dup", [(300, 500, False), (20, 20, False),
                                     (130, 260, True)])
def test_nn1_coords_plain_matches_pallas_interpret(n, m, dup):
    q, r = _clouds(7, 3, n, m, duplicates=dup)
    with pltpu.force_tpu_interpret_mode():
        d_ref, i_ref, c_ref = nn1_coords_pallas(jnp.asarray(q),
                                                jnp.asarray(r))
    d, i, c = cuda_nn.nn1_coords(_t(q), _t(r))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **TOL)


@pytest.mark.parametrize("n,m,dup", [(300, 500, False), (256, 512, False),
                                     (130, 260, True)])
def test_nn_bidir_plain_matches_pallas_interpret(n, m, dup):
    src, tgt = _clouds(9, 2, n, m, duplicates=dup)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(x) for x in nn_bidir_pallas(jnp.asarray(src),
                                                      jnp.asarray(tgt))]
    fd, fi, bd, bi = cuda_nn.nn_bidir(_t(src), _t(tgt))
    np.testing.assert_array_equal(fi.numpy(), ref[1])
    np.testing.assert_array_equal(bi.numpy(), ref[3])
    np.testing.assert_allclose(fd.numpy(), ref[0], **TOL)
    np.testing.assert_allclose(bd.numpy(), ref[2], **TOL)


# ---------------------------------------------------------------------------
# against the jnp fallback (cross-term form) on well-separated points
# ---------------------------------------------------------------------------

def test_plain_versions_match_jnp_fallback():
    q, r = _clouds(11, 2, 200, 350)
    sq = np.asarray(jax_distance.pairwise_sqdist(jnp.asarray(q),
                                                 jnp.asarray(r)))
    order = np.argsort(sq, axis=-1, kind="stable")[..., :8]
    d, i = cuda_nn.nn_topk(_t(q), _t(r), 8)
    np.testing.assert_array_equal(i.numpy(), order)
    # the cross-term form loses digits to cancellation: rtol 1e-4
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(sq, order, -1),
                               rtol=1e-4, atol=1e-5)
    d1, i1, c1 = cuda_nn.nn1_coords(_t(q), _t(r))
    np.testing.assert_array_equal(i1.numpy(), sq.argmin(-1))
    np.testing.assert_array_equal(
        c1.numpy(), np.take_along_axis(r, sq.argmin(-1)[..., None], 1))
    fd, fi, bd, bi = cuda_nn.nn_bidir(_t(q), _t(r))
    np.testing.assert_array_equal(fi.numpy(), sq.argmin(-1))
    np.testing.assert_array_equal(bi.numpy(), sq.argmin(-2))
    np.testing.assert_allclose(bd.numpy(), sq.min(-2), rtol=1e-4, atol=1e-5)


def test_ties_go_to_the_lowest_index_and_m_below_k():
    zero = torch.zeros((1, 40, 3))
    d, i = cuda_nn.nn_topk(zero, torch.zeros((1, 90, 3)), 3)
    assert torch.equal(i, torch.arange(3).expand(1, 40, 3))
    assert int(cuda_nn.nn1_coords(zero, zero)[1].max()) == 0
    _, fi, _, bi = cuda_nn.nn_bidir(zero, zero)
    assert int(fi.max()) == 0 and int(bi.max()) == 0
    d, i = cuda_nn.nn_topk(zero, torch.ones((1, 2, 3)), 3)  # M = 2 < k
    assert torch.isinf(d[..., 2]).all() and int(i[..., 2].max()) == 0
    with pytest.raises(ValueError):
        cuda_nn.nn_topk(zero, zero, cuda_nn.MAX_K + 1)


def test_nn_topk_broadcast_ref_matches_materialised():
    rng = np.random.RandomState(13)
    q = _t(rng.randn(3, 4, 50, 3).astype(np.float32))
    r = _t(rng.randn(3, 1, 70, 3).astype(np.float32))
    d, i = cuda_nn.nn_topk(q, r, 3)
    d_ref, i_ref = cuda_nn.nn_topk(q, r.expand(3, 4, 70, 3).contiguous(), 3)
    assert d.shape == (3, 4, 50, 3)
    assert torch.equal(i, i_ref) and torch.equal(d, d_ref)
    d1, i1 = cuda_nn.nn_topk(q, r[0, 0], 1)  # one cloud for every batch
    d1_ref, i1_ref = cuda_nn.nn_topk(
        q, r[0, 0].expand(3, 4, 70, 3).contiguous(), 1)
    assert torch.equal(i1, i1_ref) and torch.equal(d1, d1_ref)


# ---------------------------------------------------------------------------
# ops/distance.py and ops/interpolate.py against the JAX functions
# ---------------------------------------------------------------------------

def test_knn_and_nearest_neighbor_match_jax():
    q, r = _clouds(15, 2, 120, 300)
    d_ref, i_ref = jax_distance.knn(jnp.asarray(q), jnp.asarray(r), 5)
    d, i = knn(_t(q), _t(r), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4,
                               atol=1e-5)
    s_ref, j_ref = jax_distance.nearest_neighbor(jnp.asarray(q[0]),
                                                 jnp.asarray(r[0]))
    s, j = nearest_neighbor(_t(q[0]), _t(r[0]))
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4,
                               atol=1e-5)


def test_knn_transfer_matches_jax():
    q, r = _clouds(17, 1, 150, 260)
    labels = np.random.RandomState(1).randint(0, 9, 260)
    feat = np.random.RandomState(2).randn(260, 5).astype(np.float32)
    ref = jax_distance.knn_transfer_labels(
        jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(labels))
    got = knn_transfer_labels(_t(q[0]), _t(r[0]), _t(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jax_distance.knn_transfer_features(
        jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(feat))
    got = knn_transfer_features(_t(q[0]), _t(r[0]), _t(feat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["forward", "reverse", "bidirectional"])
def test_chamfer_value_index_and_grads_match_jax(mode):
    n, m = (90, 90) if mode == "bidirectional" else (90, 140)
    src, tgt = _clouds(19, 2, n, m)
    kw = dict(bidirectional=mode == "bidirectional", reverse=mode == "reverse")
    w = np.random.RandomState(3).rand(
        2, m if mode == "reverse" else n).astype(np.float32)

    def jax_loss(s, t):
        return jnp.sum(jnp.asarray(w) * jax_distance.chamfer(s, t, **kw))

    d_ref, *idx_ref = jax_distance.chamfer(jnp.asarray(src), jnp.asarray(tgt),
                                           return_index=True, **kw)
    gs_ref, gt_ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(src),
                                                        jnp.asarray(tgt))
    s = _t(src).requires_grad_(True)
    t = _t(tgt).requires_grad_(True)
    d, *idx = chamfer(s, t, return_index=True, **kw)
    (d * _t(w)).sum().backward()
    for a, b in zip(idx, idx_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(d_ref), **TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs_ref), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt_ref), **TOL)


def test_chamfer_skips_the_ref_gradient_when_not_needed():
    src, tgt = _clouds(21, 1, 30, 40)
    s = _t(src).requires_grad_(True)
    chamfer(s, _t(tgt)).sum().backward()
    assert s.grad is not None and torch.isfinite(s.grad).all()


@pytest.mark.parametrize("k", [3, 5])
def test_blend_anchor_motion_matches_jax(k):
    rng = np.random.RandomState(23)
    q = rng.randn(200, 3).astype(np.float32)
    r = rng.randn(320, 3).astype(np.float32)
    f = (0.05 * rng.randn(320, 3)).astype(np.float32)
    out_ref, mask_ref = jax_blend(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(f), k=k, return_mask=True)
    out, mask = blend_anchor_motion(_t(q), _t(r), _t(f), k=k,
                                    return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    # weights are 1 / euclidean distance: rtol 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the device default
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_of(np.zeros(3)) == torch.device("cuda")
    assert device_of(np.zeros(3), torch.zeros(3)) == torch.device("cpu")


def test_no_fallback_to_the_cpu_without_a_card(monkeypatch):
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.train import FitConfig, fit_base

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        BaseModel(3, 2)
    model = BaseModel(3, 2, device="cpu")
    with pytest.raises(RuntimeError):  # fit_base resolves None to the card
        fit_base(model, FitConfig(n_iter=1), np.zeros((8, 3), np.float32),
                 np.zeros((2, 8, 3), np.float32))

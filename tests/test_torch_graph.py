"""Port parity: the segmentation E-step (models.base_model.
refine_seg_motion) and the graph stage (reart_tpu_torch.graph) against the
JAX package on the same seeded numpy inputs. Labels, edges and their order
are compared exactly; cost matrices within rtol 1e-4 (float32 chains through
sin/cos/atan2 that XLA and libm round differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reart_tpu import graph as JGR
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu.models.base_model import refine_seg_motion as jax_refine
from reart_tpu_torch import graph as TGR
from reart_tpu_torch.data.synth import make_robot_sample
from reart_tpu_torch.models.base_model import _median, refine_seg_motion

COST_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# refine_seg_motion: the cases of tests/test_seg_refine.py
# ---------------------------------------------------------------------------

def _two_part_scene(seed=0, n_per=150, t=4):
    rng = np.random.RandomState(seed)
    body = rng.uniform([-1, -0.3, -0.3], [0, 0.3, 0.3], (n_per, 3))
    arm = rng.uniform([0, -0.3, -0.3], [1, 0.3, 0.3], (n_per + 1, 3))
    cano = np.concatenate([body, arm]).astype(np.float32)
    gt = np.repeat([0, 1], [n_per, n_per + 1])
    pcs, trans = [], []
    for i in range(1, t + 1):
        c, s = np.cos(0.3 * i), np.sin(0.3 * i)
        m = np.eye(4, dtype=np.float32)
        m[:2, :2] = [[c, -s], [s, c]]
        pc = cano.copy()
        pc[gt == 1] = pc[gt == 1] @ m[:3, :3].T
        pcs.append(pc)
        trans.append(np.stack([np.eye(4, dtype=np.float32), m]))
    return cano, np.stack(pcs), np.stack(trans), gt


def _refine_cases():
    cano, pcs, trans, gt = _two_part_scene()
    rng = np.random.RandomState(1)
    seg = gt.copy()
    flip = rng.choice(len(seg), 40, replace=False)
    seg[flip] = 1 - seg[flip]
    yield "corrupted-odd-n", (cano, pcs, trans, seg), 2
    # even N: numpy's median averages the two middle order statistics
    yield "corrupted-even-n", (cano[:-1], pcs[:, :-1], trans, seg[:-1]), 2
    wide = np.zeros((trans.shape[0], 8, 4, 4), np.float32)
    wide[:, 3], wide[:, 7] = trans[:, 0], trans[:, 1]
    seg = np.where(gt == 0, 3, 7)
    flip = np.random.RandomState(2).choice(len(seg), 30, replace=False)
    seg[flip] = np.where(seg[flip] == 3, 7, 3)
    yield "gapped-labels", (cano, pcs, wide, seg), 1
    rng = np.random.RandomState(3)
    still = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    noisy = np.stack([still + 0.001 * rng.randn(200, 3).astype(np.float32)
                      for _ in range(3)])
    eye = np.tile(np.eye(4, dtype=np.float32), (3, 2, 1, 1))
    yield "floor-guard", (still, noisy, eye, (still[:, 0] > 0).astype(int)), 2
    yield "single-part", (cano, pcs, trans, np.zeros(len(gt), np.int64)), 1
    # three candidate parts: the reference pads the part axis to 4 with a
    # duplicate of the first label, the port does not pad
    three = np.concatenate([trans, trans[:, 1:] @ trans[:, 1:]], axis=1)
    seg = gt.copy()
    seg[flip] = 2
    yield "three-parts-no-pad", (cano, pcs, three, seg), 2


_REFINE = list(_refine_cases())


@pytest.mark.parametrize("case", _REFINE, ids=[c[0] for c in _REFINE])
def test_refine_seg_motion_labels_match_jax(case):
    _, (cano, pcs, trans, seg), n_it = case
    ref = np.asarray(jax_refine(cano, pcs, trans, seg, n_it=n_it))
    got = refine_seg_motion(cano, pcs, trans, seg, n_it=n_it, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_median_is_numpys():
    for n in (1, 2, 7, 8, 300):
        x = np.random.RandomState(n).rand(n).astype(np.float32)
        assert float(_median(_t(x))) == pytest.approx(float(np.median(x)),
                                                      rel=1e-7)


# ---------------------------------------------------------------------------
# graph/costs.py
# ---------------------------------------------------------------------------

def make_part_motion(seed, t, p, scale=0.4):
    """Random smooth per-part trajectories (frame 0 at identity)."""
    rng = np.random.RandomState(seed)
    w, v = rng.randn(p, 3) * scale, rng.randn(p, 3) * scale
    mags = np.linspace(0, 1, t)[:, None, None]
    wt = (mags * w[None]).reshape(-1, 3).astype(np.float32)
    vt = (mags * v[None]).reshape(-1, 3).astype(np.float32)
    return np.asarray(jax_se3_exp_tw(jnp.asarray(wt), jnp.asarray(vt))
                      ).reshape(t, p, 4, 4).copy()


def _same(got, ref, **tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        if r.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, **(tol or COST_TOL))


@pytest.mark.parametrize("seed,with_identity", [(0, False), (1, True),
                                                (2, True)])
def test_transform_costs_match_jax(seed, with_identity):
    trans = make_part_motion(seed, 5, 4)
    if with_identity:  # identity frames: the masked screw mean
        trans[:, 2] = np.eye(4)
        trans[:2, 1] = np.eye(4)
    j, t = jnp.asarray(trans), _t(trans)
    _same(TGR.compute_root_cost(t), JGR.compute_root_cost(j))
    _same(TGR.frobenius_cost(t[1:], t[:-1]),
          JGR.frobenius_cost(j[1:], j[:-1]))
    ref = JGR.compute_relative_trans(j, return_trans=True)
    got = TGR.compute_relative_trans(t, return_trans=True)
    # a pair with no relative motion has no axis (only its x component is
    # forced, the rest is rounding noise over its norm): compare the axis
    # and the moment of the other pairs. The moment divides by
    # tan(theta / 2): atol 1e-4 where theta is small
    moving = np.abs(np.asarray(ref[4]) - np.eye(4)).max((-2, -1)) > 1e-6
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy()[moving], np.asarray(r)[moving],
                                   rtol=1e-4, atol=1e-4)
        assert torch.isfinite(g).all()
    _same(got[2:], ref[2:], rtol=1e-4, atol=1e-6)
    # downstream costs from the SAME screws, so that only their own
    # arithmetic is compared
    screws = [np.asarray(x) for x in ref]
    args_j = [jnp.asarray(screws[4])] + [jnp.asarray(x) for x in screws[:4]]
    args_t = [_t(screws[4])] + [_t(x) for x in screws[:4]]
    _same(TGR.compute_geo_cost(*args_t), JGR.compute_geo_cost(*args_j))
    _same(TGR.compute_mean_screw_param(*[_t(x.reshape(5, 16, *x.shape[3:]))
                                         for x in screws[:4]]),
          JGR.compute_mean_screw_param(
              *[jnp.asarray(x.reshape(5, 16, *x.shape[3:]))
                for x in screws[:4]]))
    conn = np.array([[0, 1], [1, 2], [1, 3]])
    _same(TGR.compute_screw_cost(t, _t(conn)),
          JGR.compute_screw_cost(j, jnp.asarray(conn)), rtol=1e-4, atol=1e-6)
    _same(TGR.compute_screw_trans(t[:, :3], return_cost=True),
          JGR.compute_screw_trans(j[:, :3], return_cost=True),
          rtol=1e-4, atol=1e-5)
    _same(TGR.compute_screw_trans(t[:, :1]),
          JGR.compute_screw_trans(j[:, :1]), rtol=1e-4, atol=1e-5)  # E = 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anchor_costs_match_jax(seed):
    rng = np.random.RandomState(seed)
    n, p = 300, 4
    cano = rng.rand(n, 3).astype(np.float32)
    part = rng.randint(0, p, n) * 2 + 1  # labels 1, 3, 5, 7
    uni = np.unique(part)
    moved = np.stack([cano + 0.05 * i * rng.randn(1, 3).astype(np.float32)
                      for i in range(3)])
    fps_ref, idx_ref = JGR.fps_sample_cano(jnp.asarray(cano),
                                           jnp.asarray(part), uni, num_fps=20)
    fps, idx = TGR.fps_sample_cano(_t(cano), _t(part), _t(uni), num_fps=20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(fps.numpy(), np.asarray(fps_ref))
    _same(TGR.fps_index_list(_t(moved), idx),
          JGR.fps_index_list(jnp.asarray(moved), idx_ref))
    d_ref, pair_ref = JGR.compute_spatial_cost(fps_ref, return_index=True)
    d, pair = TGR.compute_spatial_cost(fps, return_index=True)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(pair_ref))
    _same(d, d_ref)
    _same(TGR.compute_spatial_cost(fps), JGR.compute_spatial_cost(fps_ref))
    track = TGR.fps_index_list(_t(moved), idx)
    grid = np.stack(np.meshgrid(np.arange(p), np.arange(p), indexing="ij"),
                    -1).reshape(-1, 2)
    _same(TGR.compute_joint_cost(track, _t(grid), pair.reshape(-1, 2)),
          JGR.compute_joint_cost(jnp.asarray(track.numpy()),
                                 jnp.asarray(grid),
                                 jnp.asarray(pair_ref).reshape(-1, 2)))


# ---------------------------------------------------------------------------
# graph/mst.py: the combinatorial parts, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_mst_matches_jax_with_ties(seed):
    rng = np.random.RandomState(seed)
    p = int(rng.randint(2, 9))
    cost = rng.randint(0, 4, (p, p)).astype(np.float32)  # many equal costs
    cost += 1e4 * np.eye(p, dtype=np.float32)
    uni = np.sort(rng.choice(20, p, replace=False))
    np.testing.assert_array_equal(TGR.mst(cost, uni_label=uni),
                                  JGR.mst(cost, uni_label=uni))
    np.testing.assert_array_equal(TGR.mst(cost), JGR.mst(cost))
    np.testing.assert_array_equal(TGR.mst(cost, max_cost=1.5),
                                  JGR.mst(cost, max_cost=1.5))
    np.testing.assert_array_equal(
        TGR.mst(cost, uni_label=uni, keep_index=True),
        JGR.mst(cost, uni_label=uni, keep_index=True))


def _random_tree_edges(rng, labels):
    """A random directed tree over `labels`, edges in random order and
    orientation."""
    order = rng.permutation(labels)
    edges = []
    for i in range(1, len(order)):
        a, b = order[i], order[rng.randint(0, i)]
        edges.append((a, b) if rng.rand() < 0.5 else (b, a))
    return np.asarray([edges[i] for i in rng.permutation(len(edges))])


@pytest.mark.parametrize("seed", range(8))
def test_merge_graph_matches_the_networkx_version(seed):
    rng = np.random.RandomState(100 + seed)
    p = int(rng.randint(3, 10))
    labels = np.sort(rng.choice(14, p, replace=False))
    conn = _random_tree_edges(rng, labels)
    trans = make_part_motion(seed, 4, 14, scale=0.3)
    # rigid groups: some parts follow another exactly or almost
    for a, b in conn[rng.rand(len(conn)) < 0.6]:
        trans[:, b] = trans[:, a]
        if rng.rand() < 0.5:
            trans[:, b, :3, 3] += 0.02 * rng.randn(3).astype(np.float32)
    seg = rng.choice(labels, 200)
    seg_ref, conn_ref = JGR.merge_graph(seg, conn, jnp.asarray(trans), 3e-2)
    seg_got, conn_got = TGR.merge_graph(seg, conn, _t(trans), 3e-2)
    np.testing.assert_array_equal(seg_got, seg_ref)
    np.testing.assert_array_equal(conn_got.reshape(-1, 2),
                                  np.asarray(conn_ref).reshape(-1, 2))


def test_filter_and_extract_match_jax():
    rng = np.random.RandomState(5)
    seg = rng.choice([2, 5, 9, 11], 100, p=[0.5, 0.3, 0.15, 0.05])
    np.testing.assert_array_equal(TGR.filter_seg_label(seg, 10),
                                  JGR.filter_seg_label(seg, 10))
    trans = rng.randn(3, 12, 4, 4).astype(np.float32)
    conn = np.array([[5, 2], [9, 5], [11, 2]])
    ref = JGR.extract_kinematic(seg, trans, conn)
    for kind in (np.asarray, _t):
        got = TGR.extract_kinematic(seg, kind(trans), conn)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(np.asarray(got[1]), ref[1])
        np.testing.assert_array_equal(got[2], ref[2])


# ---------------------------------------------------------------------------
# the graph stage on seeded multi-part scenes
# ---------------------------------------------------------------------------

def _scene(seed, n_parts):
    """The articulated table with a raw label space as a fit leaves it:
    labels are columns of a (T-1, 12, 4, 4) pose array, the body is split in
    two raw labels with the same motion, a handful of points carry a label
    of their own, and every pose is a little off the GT."""
    sample = make_robot_sample(n_frames=5, n_points=480, n_parts=n_parts,
                               seed=seed, resample=False)
    rng = np.random.RandomState(50 + seed)
    cols = rng.choice(12, n_parts + 2, replace=False)
    gt = sample["gt_cano_part"]
    seg = cols[gt]
    seg[(gt == 0) & (sample["cano_pc"][:, 0] < 0)] = cols[n_parts]
    seg[rng.choice(len(seg), 6, replace=False)] = cols[n_parts + 1]
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(4 * 12, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(4 * 12, 3).astype(np.float32)))
    ).reshape(4, 12, 4, 4)
    trans = np.tile(np.eye(4, dtype=np.float32), (4, 12, 1, 1))
    trans[:, cols[:n_parts]] = sample["gt_pose_list"][1:]
    trans[:, cols[n_parts]] = sample["gt_pose_list"][1:, 0]
    return sample["cano_pc"], seg, (noise @ trans).astype(np.float32)


@pytest.mark.parametrize("seed,n_parts", [(0, 6), (1, 5), (2, 4), (3, 6)])
def test_graph_stage_matches_jax(seed, n_parts):
    cano, seg, trans = _scene(seed, n_parts)
    cano_j, trans_j = jnp.asarray(cano), jnp.asarray(trans)
    cano_t, trans_t = _t(cano), _t(trans)

    ref = JGR.denoise_seg_label(seg, cano_j, min_num=20)
    got = TGR.denoise_seg_label(seg, cano_t, min_num=20)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert len(np.unique(got)) == n_parts + 1  # the stray label is gone

    ref = np.asarray(JGR.merging_wrapper(got, trans_j, cano_j, 3e-2, n_it=2))
    got = TGR.merging_wrapper(got, trans_t, cano_t, 3e-2, n_it=2)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) <= n_parts  # the split body was merged

    e_ref, c_ref, u_ref = JGR.mst_wrapper(got, trans_j, cano_j,
                                          return_cost=True)
    e_got, c_got, u_got = TGR.mst_wrapper(got, trans_t, cano_t,
                                          return_cost=True)
    np.testing.assert_array_equal(u_got, u_ref)
    np.testing.assert_allclose(c_got, c_ref, **COST_TOL)
    np.testing.assert_array_equal(e_got, e_ref)   # edges and their order

    ref = JGR.extract_kinematic(got, trans, e_ref)
    out = TGR.extract_kinematic(got, trans_t, e_got)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1].numpy(), ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    # arrays without a device go to the card: there is none here
    with pytest.raises(RuntimeError):
        TGR.mst_wrapper(got, trans, cano)

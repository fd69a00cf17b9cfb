"""Port parity: metrics, the selection energy, the tree edit distance, the
rest of the losses and the host LAP solver against the JAX package on the
same seeded numpy inputs. Float64 numpy metrics and the tree edit distance
are compared exactly; float32 tensor code within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import graph as JGR
from reart_tpu import losses as JL
from reart_tpu import metrics as JM
from reart_tpu.graph.ted import compute_ted as jax_compute_ted
from reart_tpu_torch import graph as TGR
from reart_tpu_torch import losses as TL
from reart_tpu_torch import metrics as TM
from reart_tpu_torch.data.synth import make_robot_sample
from reart_tpu_torch.native import lap_solve_batch, lap_solve_points

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed=0, n_points=240, n_parts=4, n_frames=5):
    """A small articulated table: predicted clouds are the GT clouds plus
    noise, the observed clouds their own draw."""
    s = make_robot_sample(n_frames, n_points, n_parts, seed=seed)
    rng = np.random.RandomState(seed)
    pred = s["gt_pc_list"] + 0.01 * rng.randn(
        *s["gt_pc_list"].shape).astype(np.float32)
    return s, pred.astype(np.float32)


# ---------------------------------------------------------------------------
# float64 numpy metrics: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_eval_flow_is_exact(seed):
    rng = np.random.RandomState(seed)
    gt = rng.randn(4, 50, 3).astype(np.float32) * 0.02
    pred = gt + rng.randn(4, 50, 3).astype(np.float32) * 0.004
    gt[0, :5] = 0.0      # zero GT flow: the NaN dot product branch
    pred[1, :5] = 0.0
    assert TM.eval_flow(pred, gt, 0.005, 0.01) == \
        JM.eval_flow(pred, gt, 0.005, 0.01)
    assert TM.eval_flow(pred, gt) == JM.eval_flow(pred, gt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_seg_is_exact(seed):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 5, 400)
    pd = np.where(rng.rand(400) < 0.8, gt, rng.randint(0, 7, 400))
    assert TM.eval_seg(gt, pd) == JM.eval_seg(jnp.asarray(gt),
                                              jnp.asarray(pd))
    assert TM.eval_seg(gt, gt) == 1.0


def _random_tree(rng, n):
    """(child, parent) edges of a random tree over a permutation of 0..n-1."""
    order = rng.permutation(n)
    return [(int(order[i]), int(order[rng.randint(0, i)]))
            for i in range(1, n)]


@pytest.mark.parametrize("seed", range(6))
def test_compute_ted_is_exact(seed):
    rng = np.random.RandomState(seed)
    pred = _random_tree(rng, int(rng.randint(2, 8)))
    gt = _random_tree(rng, int(rng.randint(2, 8)))
    pred_root = TGR.find_root_node(pred)
    gt_root = TGR.find_root_node(gt)
    assert gt_root == JGR.ted.find_root_node(gt)
    # the predicted tree comes as undirected MST edges with a chosen root
    mst_edges = [list(e) if rng.rand() < 0.5 else list(e[::-1]) for e in pred]
    assert TGR.compute_ted(mst_edges, pred_root, gt, gt_root) == \
        jax_compute_ted(mst_edges, pred_root, gt, gt_root)
    assert TGR.compute_ted(gt, gt_root, gt, gt_root) == 0


# ---------------------------------------------------------------------------
# Chamfer, assignment error, energy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_compute_chamfer_list_matches_jax(reduction):
    s, pred = _scene()
    ref = JM.compute_chamfer_list(pred, s["pc_list"], reduction=reduction)
    got = TM.compute_chamfer_list(_t(pred), _t(s["pc_list"]),
                                  reduction=reduction)
    np.testing.assert_allclose(got, ref, **TOL)
    # arrays go to the named device
    got = TM.compute_chamfer_list(pred, s["pc_list"], reduction=reduction,
                                  device="cpu")
    np.testing.assert_allclose(got, ref, **TOL)


def test_compute_chamfer_ragged_matches_jax():
    s, pred = _scene(1)
    a = [pred[0], pred[1][:200], pred[2][:150]]
    b = [s["pc_list"][0][:220], s["pc_list"][1], s["pc_list"][2][:90]]
    ref = JM.compute_chamfer_list(a, b, reduction="sum")
    got = TM.compute_chamfer_list(a, b, reduction="sum", device="cpu")
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(
        TM.compute_chamfer(_t(a[1]), _t(b[1]), "mean"),
        JM.compute_chamfer(a[1], b[1], "mean"), **TOL)
    with pytest.raises(RuntimeError):  # arrays alone go to the card
        TM.compute_chamfer(a[1], b[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_ass_err_matches_jax(seed):
    s, pred = _scene(seed)
    ref = JM.compute_ass_err(pred, s["pc_list"])
    np.testing.assert_allclose(TM.compute_ass_err(pred, s["pc_list"]), ref,
                               **TOL)
    np.testing.assert_allclose(
        TM.compute_ass_err(_t(pred), _t(s["pc_list"])), ref, **TOL)


def test_lap_solver_is_exact_against_scipy():
    from scipy.optimize import linear_sum_assignment

    rng = np.random.RandomState(3)
    cost = rng.rand(3, 40, 40).astype(np.float32)
    perm = lap_solve_batch(cost)
    for k in range(3):
        rows, cols = linear_sum_assignment(cost[k])
        np.testing.assert_allclose(cost[k][np.arange(40), perm[k]].sum(),
                                   cost[k][rows, cols].sum(), rtol=1e-6)
    src = rng.randn(2, 60, 3).astype(np.float32)
    tgt = src[:, rng.permutation(60)] + 0.01 * rng.randn(2, 60, 3).astype(
        np.float32)
    perm = lap_solve_points(src, tgt)
    dist = np.sqrt(((src[:, :, None] - tgt[:, None]) ** 2).sum(-1))
    np.testing.assert_array_equal(perm, lap_solve_batch(dist))
    # warm duals do not change the optimum of a square problem
    warm = lap_solve_points(src, tgt, v_init=rng.rand(2, 60).astype(
        np.float32))
    for k in range(2):
        np.testing.assert_allclose(dist[k][np.arange(60), warm[k]].sum(),
                                   dist[k][np.arange(60), perm[k]].sum(),
                                   rtol=1e-5)


@pytest.mark.parametrize("include_group", [True, False])
def test_energy_terms_match_jax(include_group):
    s, pred = _scene(2)
    trans = s["gt_pose_list"][1:]
    conn = np.array([[1, 0], [2, 0], [3, 0]])
    seg = s["gt_cano_part"]
    complete = np.concatenate([s["cano_pc"][None], pred])
    ref = JM.energy(jnp.asarray(pred), jnp.asarray(s["pc_list"]),
                    jnp.asarray(trans), jnp.asarray(conn), seg,
                    complete_pred_pc_list=jnp.asarray(complete),
                    include_group=include_group)
    got = TM.energy(_t(pred), _t(s["pc_list"]), _t(trans), conn, seg,
                    complete_pred_pc_list=_t(complete),
                    include_group=include_group)
    assert got.keys() == ref.keys()
    for k in ref:
        # screw_err is a cost near 0 of exact GT screws: atol 1e-5
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    empty = TM.energy(_t(pred), _t(s["pc_list"]), _t(trans[:, :1]),
                      np.zeros((0, 2), np.int64), np.zeros_like(seg),
                      complete_pred_pc_list=_t(complete),
                      include_group=include_group)
    assert empty["screw_err"] == 0.0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_group_temporal_err_matches_jax():
    s, pred = _scene(3)
    seg = s["gt_cano_part"].copy()
    for num_parts in (4, 6):  # 6: parts absent from the labels
        ref = JL.group_temporal_err(jnp.asarray(pred), jnp.asarray(seg),
                                    num_parts)
        got = TL.group_temporal_err(_t(pred), _t(seg), num_parts)
        np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_compute_connection_loss_value_and_grad_match_jax():
    s, pred = _scene(4)
    seg = s["gt_cano_part"]
    conn = np.array([[1, 0], [2, 0], [3, 0]])
    cano = s["cano_pc"]

    def jax_loss(p):
        return JL.compute_connection_loss(jnp.asarray(cano), seg, conn, p,
                                          k=10)

    ref, g_ref = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    got = TL.compute_connection_loss(_t(cano), seg, conn, p, k=10)
    got.backward()
    # the k closest pairs may be picked in another order; the loss sums them
    np.testing.assert_allclose(float(got.detach()), float(ref), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_structure_loss_matches_jax(seed):
    s, _ = _scene(seed)
    rng = np.random.RandomState(seed)
    trans = s["gt_pose_list"][1:].copy()
    trans[..., :3, 3] += 0.01 * rng.randn(*trans[..., :3, 3].shape).astype(
        np.float32)
    edges = np.array([[1, 0], [2, 0], [0, 3]])
    ref_screws = JGR.compute_relative_trans(jnp.asarray(trans),
                                            return_trans=True)
    axis, moment, theta, dist, rel = [np.asarray(x) for x in ref_screws]

    def jax_loss(r):
        return JL.structure_loss(r, jnp.asarray(axis), jnp.asarray(moment),
                                 jnp.asarray(theta), jnp.asarray(dist), edges)

    ref, g_ref = jax.value_and_grad(jax_loss)(jnp.asarray(rel))
    r = _t(rel).requires_grad_(True)
    got = TL.structure_loss(r, _t(axis), _t(moment), _t(theta), _t(dist),
                            edges)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_auction_duals_warm_start_keeps_the_exact_matching(seed):
    """The presolve's duals (here on the CPU, at a toy size) start the exact
    solver without changing what it returns."""
    from reart_tpu_torch.native import lap_solve_points

    rng = np.random.RandomState(seed)
    tgt = rng.randn(2, 96, 3).astype(np.float32)
    src = (tgt[:, rng.permutation(96)]
           + 0.05 * rng.randn(2, 96, 3).astype(np.float32))
    duals = TM._auction_duals(torch.from_numpy(src), torch.from_numpy(tgt))
    assert duals.shape == (2, 96) and np.isfinite(duals).all()
    cold = lap_solve_points(src, tgt)
    warm = lap_solve_points(src, tgt, v_init=duals)

    def matched_cost(perm):
        m = np.take_along_axis(tgt, perm[..., None].astype(np.int64), axis=1)
        return np.sqrt(((src - m) ** 2).sum(-1)).sum(-1)

    for perm in (cold, warm):
        assert all(len(set(row)) == 96 for row in perm.tolist())
    # equal optimal cost; the matching itself can differ only on exact ties
    np.testing.assert_allclose(matched_cost(warm), matched_cost(cold),
                               rtol=1e-6)

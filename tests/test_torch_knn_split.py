"""The rules of the nn_topk and ball_query kernels (csrc/nn_topk.cu,
csrc/ball_query.cu), written in PyTorch, on the CPU.

nn_topk cuts each query's reference axis into S slices, walks each slice in
ascending index with a strict '<' and merges the slices' lists in
(distance, index) order; for k = 1 it keeps only each 32-point subtile's
minimum and finds the index in the first subtile that holds the best value.
ball_query lets each lane of a warp test V points a step and ranks the hits
by the lower lanes' ballot bits, one ballot per v, stopping at the step that
reaches the K-th hit. Emulated here, those rules must give the plain
versions' outputs bit for bit, whatever S and V, and agree with the JAX
package's Pallas kernels (interpret mode) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.pallas_nn import ball_query_pallas, nn_topk_pallas
from reart_tpu_torch.ops import cuda_nn

torch.set_num_threads(1)

SUB = 32          # nn_topk: points of a k = 1 subtile
LANES = 32
# the same diff^2 formula in both packages; a sum may differ by an ulp
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# nn_topk: slices, subtiles, the (distance, index) merge
# ---------------------------------------------------------------------------

def _keys(d, j):
    """(float bits of d) << 32 | j, as int64; d >= 0."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | j


def _slice_len(m, slices):
    """Points of a slice: ceil(M / S) rounded up to whole subtiles."""
    return -(-(-(-m // slices)) // SUB) * SUB


def _slice_k1(d, lo, hi, length):
    """One slice's k = 1 walk: (best value, first point of the first
    subtile holding it) per query. d (Q, M); slice points [lo, hi); past hi
    the subtiles hold +inf points."""
    q = d.shape[0]
    best = torch.full((q,), float("inf"))
    start = torch.full((q,), lo, dtype=torch.int64)
    for c0 in range(0, length, SUB):
        a, e = lo + c0, min(lo + c0 + SUB, hi)
        if a >= e:
            break
        tm = d[:, a:e].min(-1).values      # one fminf a pair
        better = tm < best                 # strict: the first subtile stays
        best = torch.where(better, tm, best)
        start = torch.where(better, torch.full_like(start, a), start)
    return best, start


def _slice_topk(d, lo, hi, k):
    """One slice's running top-k: strict '<' insertion in ascending index.
    Returns (values (Q, k) ascending, indices); empty slots (+inf, 0)."""
    q = d.shape[0]
    bd = torch.full((q, k), float("inf"))
    bj = torch.zeros((q, k), dtype=torch.int64)
    for j in range(lo, hi):
        x = d[:, j]
        # the kernel's bubble: the new pair goes last, then moves up past
        # every strictly larger slot
        pos = (bd <= x[:, None]).sum(-1)           # slots it stays behind
        ins = x < bd[:, -1]
        shifted_d = torch.cat([bd[:, :1], bd[:, :-1]], -1)
        shifted_j = torch.cat([bj[:, :1], bj[:, :-1]], -1)
        slot = torch.arange(k)[None]
        nd = torch.where(slot < pos[:, None], bd,
                         torch.where(slot == pos[:, None], x[:, None],
                                     shifted_d))
        nj = torch.where(slot < pos[:, None], bj,
                         torch.where(slot == pos[:, None],
                                     torch.full_like(bj, j), shifted_j))
        bd = torch.where(ins[:, None], nd, bd)
        bj = torch.where(ins[:, None], nj, bj)
    return bd, bj


def nn_topk_split_merge(query, ref, k, ref_div=1, slices=1):
    """nn_topk as its kernel computes it, on one (query, reference) pair of
    clouds at a time: the ref_div query clouds that read one reference are
    folded into one cloud of ref_div * N queries; the M points are cut into
    S slices of _slice_len points; k = 1 keeps (value, subtile) per slice,
    merges by the smallest key and takes the first point of that subtile at
    the best value; k > 1 keeps a top-k per slice and takes the k smallest
    keys over the S lists."""
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    kk = 1 if k == 1 else (3 if k <= 3 else 8)   # the kernel's instance
    length = _slice_len(m, slices)
    out_d, out_i = [], []
    for g in range(b // ref_div):
        q = query[g * ref_div:(g + 1) * ref_div].reshape(-1, 3)
        d = cuda_nn._sqdist_diff2(q[None], ref[g][None])[0]   # (Q, M)
        lists = []
        for s in range(slices):
            lo, hi = s * length, min(m, (s + 1) * length)
            if kk == 1:
                lists.append(_slice_k1(d, lo, hi, length))
            else:
                lists.append(_slice_topk(d, lo, hi, kk))
        if kk == 1:
            keys = torch.stack([_keys(v, j) for v, j in lists], -1)
            key = keys.min(-1).values
            best = (key >> 32).to(torch.int32).view(torch.float32)
            j0 = key & 0xFFFFFFFF
            # the ballot over subtile j0: the first point at the best value
            cols = j0[:, None] + torch.arange(SUB)[None]
            dc = torch.gather(d, 1, cols.clamp(max=m - 1))
            eq = (dc == best[:, None]) & (cols < m)
            idx = j0 + eq.to(torch.int64).argmax(-1)
            out_d.append(best[:, None])
            out_i.append(idx[:, None])
        else:
            keys = torch.cat([_keys(v, j) for v, j in lists], -1)  # (Q, S*k)
            key = torch.sort(keys, -1).values[:, :kk]
            out_d.append((key >> 32).to(torch.int32).view(torch.float32))
            out_i.append(key & 0xFFFFFFFF)
    d = torch.cat(out_d)[:, :k].reshape(b, n, k)
    i = torch.cat(out_i)[:, :k].reshape(b, n, k)
    return d, i


def _knn_case(kind):
    """(query (B, N, 3), ref (B // ref_div, M, 3), ref_div) as numpy."""
    rng = np.random.RandomState(len(kind))
    q = rng.randn(2, 70, 3).astype(np.float32)
    r = rng.randn(2, 301, 3).astype(np.float32)
    div = 1
    if kind == "duplicates":
        # 43 points repeated 7 times: equal distances 43 apart straddle the
        # slice and subtile boundaries
        r = np.tile(r[:, :43], (1, 7, 1))
        q[:, :20] = r[:, 5:25]
    elif kind == "all_equal":
        q, r = np.zeros_like(q), np.zeros_like(r)
    elif kind == "m_below_k":
        r = r[:, :2]
    elif kind == "ragged":  # M no multiple of a slice count or a subtile
        r = r[:, :97]
    elif kind == "shared_ref":  # 4 query clouds read each reference
        q = rng.randn(8, 20, 3).astype(np.float32)
        div = 4
    return q, r, div


KNN_KINDS = ["random", "duplicates", "all_equal", "m_below_k", "ragged",
             "shared_ref"]


@pytest.mark.parametrize("slices", [1, 2, 4, 16])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kind", KNN_KINDS)
def test_nn_topk_split_merge_equals_plain(kind, k, slices):
    q, r, div = _knn_case(kind)
    got = nn_topk_split_merge(_t(q), _t(r), k, div, slices)
    ref = cuda_nn.nn_topk_plain(_t(q), _t(r), k, div)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])   # distances bit for bit, inf too


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kind", KNN_KINDS)
def test_nn_topk_split_merge_matches_pallas_interpret(kind, k):
    q, r, div = _knn_case(kind)
    m = r.shape[1]
    if m < k:  # the TPU kernel pads with FAR points; compare the real slots
        k_cmp = m
    else:
        k_cmp = k
    slices = cuda_nn.nn_topk_plan(q.shape[0] // div, q.shape[1] * div, m,
                                  k, 132)[1]
    d, i = nn_topk_split_merge(_t(q), _t(r), k, div, slices)
    rr = np.repeat(r, div, axis=0)   # the TPU wrapper materialises it
    with pltpu.force_tpu_interpret_mode():
        d_ref, i_ref = nn_topk_pallas(jnp.asarray(q), jnp.asarray(rr), k)
    np.testing.assert_array_equal(i.numpy()[..., :k_cmp],
                                  np.asarray(i_ref)[..., :k_cmp])
    np.testing.assert_allclose(d.numpy()[..., :k_cmp],
                               np.asarray(d_ref)[..., :k_cmp], **TOL)
    if k_cmp < k:  # the port's missing slots: (+inf, 0)
        assert np.isinf(d.numpy()[..., k_cmp:]).all()
        assert (i.numpy()[..., k_cmp:] == 0).all()


def test_nn_topk_plan_fills_the_card():
    sms, qpt = 132, cuda_nn.NN_QPT
    # the seg-refinement table, 20 candidate clouds a frame folded into
    # one: enough blocks at qpt queries a thread, no slices
    assert cuda_nn.nn_topk_plan(9, 20 * 4096, 4096, 1, sms) == (qpt, 1)
    # (9, 4096, 4096): k=1 slices to 8 blocks an SM; k=3 to 3, one query a
    # thread (each slice keeps a list: shorter slices insert more)
    assert cuda_nn.nn_topk_plan(9, 4096, 4096, 1, sms) == (qpt, 16)
    assert cuda_nn.nn_topk_blocks(9, 4096, qpt, 16) == 1152
    assert cuda_nn.nn_topk_plan(9, 4096, 4096, 3, sms) == (1, 2)
    # IK's label transfer, ~6 queries: one a thread, as many slices as
    # there may be
    assert cuda_nn.nn_topk_plan(1, 6, 4096, 1, sms) == (
        1, cuda_nn.NN_MAX_SLICES)
    # the backbone's 3-NN: slices of at least NN_MIN_SLICE points
    assert cuda_nn.nn_topk_plan(9, 512, 128, 3, sms) == (1, 4)
    assert cuda_nn.nn_topk_plan(9, 4096, 512, 3, sms) == (1, 2)
    assert cuda_nn.nn_topk_plan(8, 1024, 512, 3, sms) == (1, 8)
    for b, n, m, k in [(8, 512, 128, 3), (1, 4096, 4096, 8), (3, 5, 40, 2),
                       (70000, 5, 7, 3), (1, 37, 4059, 1)]:
        q, s = cuda_nn.nn_topk_plan(b, n, m, k, sms)
        assert q in (1, qpt) and (k == 1 or q == 1) and s & (s - 1) == 0
        assert s == 1 or m >= s * cuda_nn.NN_MIN_SLICE
        assert s <= cuda_nn.NN_MAX_SLICES


# ---------------------------------------------------------------------------
# ball_query: V points a lane, ballots in point order, the stop at the K-th
# ---------------------------------------------------------------------------

def ball_query_steps(radius, nsample, xyz, new_xyz, v, tile=None):
    """ball_query as its kernel computes it: a warp per centroid walks the
    cloud (in tiles of `tile` points, or whole) in steps of 32 * v points,
    lane l testing points base + 32 u + l for u < v; for each u in order a
    hit's slot is the hits so far plus the lower lanes' hits of that
    ballot; the warp stops after the step that reaches nsample hits; then
    the slots past the hits take the first hit (0 without one)."""
    b, n, s = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    r2 = cuda_nn.radius_sq(radius)
    hit_all = cuda_nn._sqdist_diff2(new_xyz, xyz) < r2         # (B, S, N)
    out = torch.zeros((b, s, nsample), dtype=torch.int64)
    count = torch.zeros((b, s), dtype=torch.int64)
    first = torch.zeros((b, s), dtype=torch.int64)
    done = torch.zeros((b, s), dtype=torch.bool)
    tile = tile or n
    lanes = torch.arange(LANES)
    for t0 in range(0, n, tile):
        cnt = min(tile, n - t0)
        for k0 in range(0, cnt, LANES * v):
            live = ~done
            for u in range(v):
                pos = k0 + LANES * u + lanes                   # (32,)
                inside = pos < cnt                             # +inf padding
                hit = hit_all[..., (t0 + pos).clamp(max=n - 1)] & inside
                hit &= live[..., None]
                before = torch.cumsum(hit, -1) - hit.to(torch.int64)
                slot = count[..., None] + before
                write = hit & (slot < nsample)
                bb, ss, ll = torch.nonzero(write, as_tuple=True)
                out[bb, ss, slot[bb, ss, ll]] = t0 + pos[ll]
                anyhit = hit.any(-1)
                lowest = t0 + k0 + LANES * u + hit.to(torch.int8).argmax(-1)
                first = torch.where(anyhit & (count == 0), lowest, first)
                count = count + hit.sum(-1)
            done |= count >= nsample
    filled = torch.arange(nsample)[None, None] >= torch.clamp(
        count, max=nsample)[..., None]
    return torch.where(filled, first[..., None], out)


def _edge_clouds():
    """The edge cases of chip_smoke.py's ball_query phase: an empty ball,
    exactly k hits, one hit, a point on the radius (outside) and one just
    inside."""
    k, radius = 8, 0.25                      # radius^2 = 0.0625 exactly
    xyz = np.full((1, 70, 3), 5.0, np.float32)
    xyz[0, :, 0] += np.arange(70)
    xyz[0, 10:10 + k] = 1.0
    xyz[0, 30] = [-3.0, 0.0, 0.0]
    xyz[0, 40] = [0.25, 0.0, 0.0]
    xyz[0, 41] = [0.0, np.float32(0.2499999), 0.0]
    new_xyz = np.array([[[-9.0, -9.0, -9.0], [1.0, 1.0, 1.0],
                         [-3.0, 0.1, 0.0], [0.0, 0.0, 0.0]]], np.float32)
    return radius, k, xyz, new_xyz


def _bq_case(kind):
    """(radius, nsample, xyz (B, N, 3), new_xyz (B, S, 3)) as numpy."""
    rng = np.random.RandomState(3)
    if kind == "edges":
        return _edge_clouds()
    if kind == "more_slots_than_points":
        return 10.0, 32, rng.randn(2, 20, 3).astype(np.float32), \
            rng.randn(2, 5, 3).astype(np.float32)
    xyz = rng.rand(2, 601, 3).astype(np.float32)
    if kind == "duplicates":  # every point twice, 300 apart in index
        xyz[:, 300:600] = xyz[:, :300]
    new_xyz = xyz[:, rng.permutation(601)[:37]].copy()
    radius, k = {"few_hits": (0.1, 32), "many_hits": (0.4, 16),
                 "duplicates": (0.2, 64), "k_128": (0.3, 128)}[kind]
    return radius, k, xyz, new_xyz


BQ_KINDS = ["edges", "more_slots_than_points", "few_hits", "many_hits",
            "duplicates", "k_128"]


@pytest.mark.parametrize("v,tile", [(1, None), (2, None), (4, None),
                                    (8, None), (4, 96), (3, 50)])
@pytest.mark.parametrize("kind", BQ_KINDS)
def test_ball_query_steps_equal_plain(kind, v, tile):
    radius, k, xyz, new_xyz = _bq_case(kind)
    got = ball_query_steps(radius, k, _t(xyz), _t(new_xyz), v, tile)
    assert torch.equal(got, cuda_nn.ball_query_plain(radius, k, _t(xyz),
                                                     _t(new_xyz)))


@pytest.mark.parametrize("kind", BQ_KINDS)
def test_ball_query_steps_match_pallas_interpret(kind):
    radius, k, xyz, new_xyz = _bq_case(kind)
    got = ball_query_steps(radius, k, _t(xyz), _t(new_xyz), 4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ball_query_pallas(radius, k, jnp.asarray(xyz),
                                           jnp.asarray(new_xyz)))
    if kind == "more_slots_than_points":
        # the TPU kernel pads the cloud to its tile with FAR points, which
        # are never hits: the first N slots agree, the rest is padding
        np.testing.assert_array_equal(got.numpy()[..., :20], ref[..., :20])
        return
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "edges":
        want = np.stack([np.zeros(k), np.arange(10, 10 + k), np.full(k, 30),
                         np.full(k, 41)])[None]
        np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_warps_fill_the_card():
    sms = 132
    # SA1 of the flow clouds: 387 blocks of 12, 3 an SM (16 would put 48
    # warps on some SMs and 32 on others)
    assert cuda_nn.ball_query_warps(9, 512, sms) == 12
    assert cuda_nn.ball_query_warps(8, 512, sms) == 16    # SA1, training
    assert cuda_nn.ball_query_warps(9, 128, sms) == 10    # SA2, flow
    assert cuda_nn.ball_query_warps(8, 128, sms) == 8     # SA2, training
    for b, s in [(1, 3), (2100, 512), (3, 97), (1, 1)]:
        w = cuda_nn.ball_query_warps(b, s, sms)
        assert cuda_nn.BQ_MIN_WARPS <= w <= cuda_nn.BQ_MAX_WARPS
        busiest = -(-b * -(-s // w) // sms) * w
        assert all(busiest <= -(-b * -(-s // v) // sms) * v
                   for v in range(cuda_nn.BQ_MIN_WARPS,
                                  cuda_nn.BQ_MAX_WARPS + 1))

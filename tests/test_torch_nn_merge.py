"""The split-and-merge rule of the blend3 and nn1_bidir_coords kernels
(csrc/nn_split.cuh), and the fixed-order scatter of the Chamfer backward,
on the CPU.

The kernels cut each query's reference axis into pieces, walk each piece
with a strict '<' in ascending index, and merge the partial winners in
(distance, index) order: blend3 by inserting the slices' top-3 lists in
slice order, nn1_bidir_coords by the smallest 64-bit key (float bits of the
distance << 32 | index). Written here in PyTorch, that rule must give the
plain versions' outputs bit for bit: it is what makes the kernels' ties go
to the lowest index whatever the order in which the pieces finish."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu.ops.distance import chamfer_loss as jax_chamfer_loss
from reart_tpu_torch.ops import cuda_nn
from reart_tpu_torch.ops.distance import chamfer_loss, scatter_rows

torch.set_num_threads(1)

FAR = 1e6


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


# ---------------------------------------------------------------------------
# blend3: S slices, a top-3 each, merged in slice order
# ---------------------------------------------------------------------------

def _insert(best_d, best_j, x, k):
    """nn_split::Top3::insert on tensors: best (..., 3) ascending, x and k
    (...); strict '<'."""
    d0, d1, d2 = best_d.unbind(-1)
    j0, j1, j2 = best_j.unbind(-1)
    lt0, lt1, lt2 = x < d0, x < d1, x < d2
    nd = (torch.where(lt0, x, d0),
          torch.where(lt0, d0, torch.where(lt1, x, d1)),
          torch.where(lt1, d1, torch.where(lt2, x, d2)))
    nj = (torch.where(lt0, k, j0),
          torch.where(lt0, j0, torch.where(lt1, k, j1)),
          torch.where(lt1, j1, torch.where(lt2, k, j2)))
    return torch.stack(nd, -1), torch.stack(nj, -1)


def blend3_split_merge(query, ref, flow, slices,
                       sample=cuda_nn.BLEND3_SAMPLE):
    """blend3 as its kernel computes it: slice s of the M anchors is
    [s * len, (s + 1) * len) with len = ceil(M / S). T is the third
    smallest distance over every `sample`-th anchor of every slice; each
    slice is walked in ascending index with a running top-3 that takes only
    distances <= T; the S lists are then inserted in slice order into one
    top-3, and the epilogue runs on it."""
    d = cuda_nn.blend3_sqdist(query, ref)                     # (B, N, M)
    b, n, m = d.shape
    length = -(-m // slices)
    # positions past M are never visited: +inf is never inserted
    pad = torch.full((b, n, slices * length - m), float("inf"))
    d = torch.cat([d, pad], -1).reshape(b, n, slices, length)
    # fewer than 3 sampled anchors: T = +inf, no filter
    sub = torch.cat([d[..., ::sample].reshape(b, n, -1),
                     torch.full((b, n, 3), float("inf"))], -1)
    t = torch.sort(sub, dim=-1)[0][..., 2]
    best_d = torch.full((b, n, slices, 3), float("inf"))
    best_j = torch.zeros((b, n, slices, 3), dtype=torch.int64)
    first = torch.arange(slices) * length
    for p in range(length):
        x = d[..., p]
        x = torch.where(x <= t[..., None], x, float("inf"))  # the filter
        best_d, best_j = _insert(best_d, best_j, x,
                                 (first + p).expand(b, n, slices))
    top_d = torch.full((b, n, 3), float("inf"))
    top_j = torch.zeros((b, n, 3), dtype=torch.int64)
    for s in range(slices):
        for v in range(3):
            top_d, top_j = _insert(top_d, top_j, best_d[:, :, s, v],
                                   best_j[:, :, s, v])
    return cuda_nn.blend3_epilogue(top_d, top_j, flow)


def _blend3_case(kind):
    q, r = _randn(1, 2, 70, 3), _randn(2, 2, 301, 3)
    f = 0.05 * _randn(3, 2, 301, 3)
    if kind == "duplicates":
        # 43 points repeated 7 times: every query's 3 nearest are copies of
        # one point, 43 apart, and they straddle the slice boundaries
        r = r[:, :43].repeat(1, 7, 1)
    elif kind == "far":  # FlowContext's padding: FAR anchors, zero flow
        r[:, 200:] = FAR
        f[:, 200:] = 0.0
    elif kind == "three":
        r, f = r[:, :3], f[:, :3]
    elif kind == "all_equal":  # every distance ties
        r = torch.zeros_like(r)
    return q, r, f


@pytest.mark.parametrize("slices,sample", [(1, 4), (2, 4), (8, 4), (16, 4),
                                           (8, 1), (8, 64)])
@pytest.mark.parametrize("kind", ["random", "duplicates", "far", "three",
                                  "all_equal"])
def test_blend3_split_merge_equals_plain(kind, slices, sample):
    q, r, f = _blend3_case(kind)
    got = blend3_split_merge(q, r, f, slices, sample)
    ref = cuda_nn.blend3_plain(q, r, f)
    for g, p in zip(got, ref):
        assert torch.equal(g, p)


def test_blend3_slices_fill_the_card_and_keep_long_slices():
    # the fit's (9, 4096, 4096) on an H100's 132 SMs: 8 slices, 1152 blocks
    assert cuda_nn.blend3_slices(9, 4096, 4096, 132) == 8
    # few anchors: slices of 64 or more, down to one slice under 128
    assert cuda_nn.blend3_slices(9, 4096, 300, 132) == 4
    assert cuda_nn.blend3_slices(9, 4096, 127, 132) == 1
    assert cuda_nn.blend3_slices(2, 300, 3, 132) == 1
    # a grid already full at S = 1 keeps one slice
    assert cuda_nn.blend3_slices(200, 8192, 4096, 132) == 1


# ---------------------------------------------------------------------------
# nn1_bidir_coords: tiles of blocks and threads, merged by 64-bit keys
# ---------------------------------------------------------------------------

def _keys(d, idx):
    """(float bits of d) << 32 | idx, as int64; d >= 0."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | idx


def _pieces(size, tile, threads, per_step):
    """The index sets that the kernel's threads walk along one axis, in
    ascending order: tile t, thread u holds t * tile + c + u + threads * k
    for steps c = 0, threads * per_step, ... and k < per_step."""
    out = []
    for t0 in range(0, size, tile):
        for u in range(threads):
            idx = [t0 + c + u + threads * k
                   for c in range(0, tile, threads * per_step)
                   for k in range(per_step)]
            idx = [i for i in idx if i < min(size, t0 + tile)]
            if idx:
                out.append(torch.tensor(idx))
    return out


def nn1_bidir_split_merge(src, tgt, tile=cuda_nn.NN1_BIDIR_TILE,
                          threads=(8, 32), per=(16, 4)):
    """nn1_bidir_coords as its kernel computes it: each thread's strict '<'
    walk over its rows (for a column) or its columns (for a row) gives a
    partial winner; the partials' keys are merged by their minimum."""
    d = cuda_nn._sqdist_diff2(src, tgt)                       # (B, N, M)
    b, n, m = d.shape
    # the kernel's rows: one step of a tile's height (r0 + ty + 8 r)
    rows = _pieces(n, tile[0], threads[0], per[0])
    cols = _pieces(m, tile[1], threads[1], per[1])
    fkey = torch.full((b, n), torch.iinfo(torch.int64).max)
    bkey = torch.full((b, m), torch.iinfo(torch.int64).max)
    for c in cols:   # a row's partial over one thread's columns
        sub = d[:, :, c]
        i = torch.argmin(sub, dim=2)   # first of the minima: the lowest
        fkey = torch.minimum(fkey, _keys(torch.gather(sub, 2, i[..., None])
                                         [..., 0], c[i]))
    for r in rows:   # a column's partial over one thread's rows
        sub = d[:, r, :]
        i = torch.argmin(sub, dim=1)
        bkey = torch.minimum(bkey, _keys(torch.gather(sub, 1, i[:, None])
                                         [:, 0], r[i]))

    def decode(key, points):
        dist = (key >> 32).to(torch.int32).view(torch.float32)
        idx = key & 0xFFFFFFFF
        return dist, idx, cuda_nn._gather_rows(points, idx)

    return (*decode(fkey, tgt), *decode(bkey, src))


def _bidir_case(kind):
    src, tgt = _randn(4, 2, 150, 3), _randn(5, 2, 300, 3)
    if kind == "duplicates":
        # 11 points repeated: exact ties straddle the row and column tiles
        base = _randn(6, 2, 11, 3)
        src, tgt = base.repeat(1, 14, 1)[:, :150], base.repeat(1, 28, 1)[:, 5:305]
    elif kind == "far":  # FAR-padded targets never win a forward query
        tgt[:, 250:] = FAR
    elif kind == "all_equal":
        src, tgt = torch.zeros_like(src), torch.zeros_like(tgt)
    return src, tgt


@pytest.mark.parametrize("tile,threads,per", [
    (cuda_nn.NN1_BIDIR_TILE, (8, 32), (16, 4)),
    ((16, 24), (4, 3), (4, 2)),   # small tiles: many boundaries at toy size
    ((7, 5), (7, 5), (1, 1)),     # one point a thread
])
@pytest.mark.parametrize("kind", ["random", "duplicates", "far",
                                  "all_equal"])
def test_nn1_bidir_split_merge_equals_plain(kind, tile, threads, per):
    src, tgt = _bidir_case(kind)
    got = nn1_bidir_split_merge(src, tgt, tile, threads, per)
    ref = cuda_nn.nn1_bidir_coords_plain(src, tgt)
    for g, p in zip(got, ref):
        assert torch.equal(g, p)


# ---------------------------------------------------------------------------
# the Chamfer backward's scatter
# ---------------------------------------------------------------------------

def _index_add(idx, vals, n):
    b, c = idx.shape[0], vals.shape[-1]
    flat = (idx + torch.arange(b)[:, None] * n).reshape(-1)
    return torch.zeros((b * n, c)).index_add_(
        0, flat, vals.reshape(-1, c)).reshape(b, n, c)


@pytest.mark.parametrize("kind", ["random", "one_row", "sparse_target",
                                  "empty_rows"])
def test_scatter_rows_equals_index_add(kind):
    rng = np.random.RandomState(7)
    b, k, n = 3, 2000, 50
    idx = rng.randint(0, n, (b, k))
    if kind == "one_row":
        idx[:] = 17
    elif kind == "sparse_target":  # a dense cloud's winners in a sparse one
        idx[:, :1500] = rng.randint(0, 3, (b, 1500))
    elif kind == "empty_rows":
        idx = rng.randint(0, 5, (b, k)) * 10
    # magnitudes over 12 decades: any other order of additions rounds
    # differently
    vals = (rng.randn(b, k, 3) * 10.0 ** rng.uniform(-6, 6, (b, k, 1)))
    idx, vals = torch.from_numpy(idx), torch.from_numpy(vals.astype(
        np.float32))
    got = scatter_rows(idx, vals, n)
    assert torch.equal(got, _index_add(idx, vals, n))
    # not the same order as a pairwise tree: the check can see an order
    if kind == "one_row":
        assert not torch.equal(got[:, 17], vals.sum(1))


def test_chamfer_grads_with_many_duplicate_winners_match_jax():
    # a sparse source against a dense target: each source point is the
    # reverse winner of many target points, so its gradient is a long sum
    src, tgt = _randn(8, 2, 40, 3), 0.5 * _randn(9, 2, 600, 3)
    val_ref, (g_src_ref, g_tgt_ref) = jax.value_and_grad(
        jax_chamfer_loss, argnums=(0, 1))(jnp.asarray(src.numpy()),
                                          jnp.asarray(tgt.numpy()))
    s, t = src.clone().requires_grad_(True), tgt.clone().requires_grad_(True)
    val = chamfer_loss(s, t)
    val.backward()
    # rtol 1e-5: the same residuals, summed in another order than XLA's
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(g_src_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_tgt_ref),
                               rtol=1e-5, atol=1e-6)

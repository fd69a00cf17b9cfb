"""The rules of the nn_bidir and nn1_coords kernels (csrc/nn_bidir.cu,
csrc/nn1_coords.cu), written in PyTorch, on the CPU.

nn_bidir walks the (N, M) plane once in units of a row block of W warps x
RT src rows (every lane of a warp the warp's RT) against a chunk of 32 L
tgt columns, a lane walking its own L consecutive columns; block i of G
takes units [i U / G, (i + 1) U / G). Each distance feeds a row's minimum over the
lane's L columns (a column group) and a column's minimum over the warp's RT
rows (a row group), by fminf; a row's running best is replaced only by a
strictly smaller group minimum; a column's warp minima are taken in
ascending warp order with a strict '<'. The (value, group) keys merge over
the lanes by a halving shuffle and over the blocks by a 64-bit atomicMin,
and the index is found after the scan in the winning group. nn1_coords
walks a pair of small clouds in a group of 8, 16 or 32 lanes, each lane
holding one query and one reference point, the reference points broadcast
in ascending index; larger clouds go through nn_topk's k = 1 kernel and a
gather of the winners' coordinates. Emulated here, those rules must give
the plain versions' outputs bit for bit, whatever the tile sizes, the
block order and the plan, and agree with the JAX package's Pallas kernels
(interpret mode) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.pallas_nn import nn1_coords_pallas, nn_bidir_pallas
from reart_tpu_torch.ops import cuda_nn
from test_torch_knn_split import nn_topk_split_merge

torch.set_num_threads(1)

LANES = 32
SMS = 132
# the same diff^2 formula in both packages; a sum may differ by an ulp
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _keys(d, g):
    """(float bits of d) << 32 | g, as int64; d >= 0."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | g


def _key_dist(key):
    return (key >> 32).to(torch.int32).view(torch.float32)


def _first_equal(d, lo, width, limit, value):
    """The first index in [lo, min(lo + width, limit)) of each row of d
    (R, K) at which d equals value (R,): the decode's walk over a group."""
    idx = lo[:, None] + torch.arange(width)[None]
    dc = torch.gather(d, 1, idx.clamp(max=limit - 1))
    eq = (dc == value[:, None]) & (idx < limit)
    assert bool(eq.any(-1).all()), "the winning group must hold the value"
    return lo + eq.to(torch.int64).argmax(-1)


# ---------------------------------------------------------------------------
# nn_bidir: one pass, fminf along both axes, (value, group) keys
# ---------------------------------------------------------------------------

def rows_min_lanes(keys):
    """The kernel's rows_min over the lanes: keys (..., 32, R), lane l's key
    of each of R rows (R a power of two up to 32). Each step halves the rows
    a lane keeps, the lanes whose bit `off` is set keeping the upper half,
    and merges them with lane l ^ off's; the last steps merge whole keys.
    Returns (..., 32): lane l's result, the minimum of row l // (32 // R)."""
    k = keys
    r = k.shape[-1]
    lanes = torch.arange(LANES)
    half, off = r // 2, 16
    while half >= 1:
        up = ((lanes & off) != 0)[:, None]
        lo, hi = k[..., :half], k[..., half:2 * half]
        send = torch.where(up, lo, hi)
        keep = torch.where(up, hi, lo)
        k = torch.minimum(keep, send[..., lanes ^ off, :])
        half, off = half // 2, off // 2
    out = k[..., 0]
    off = 16 // r
    while off >= 1:
        out = torch.minimum(out, out[..., lanes ^ off])
        off //= 2
    return out


def _atomic_min(a, c):
    """atomicMin on 64-bit unsigned keys, held as int64: the all-ones start
    (-1) is the largest; every key is non-negative (a sign bit of 0)."""
    return torch.where((a < 0) | (c < a), c, a)


def _block_units(units, blocks):
    """The units of each block: block i of G takes [i U / G, (i+1) U / G)."""
    g = min(blocks, units)
    return [range(units * i // g, units * (i + 1) // g) for i in range(g)]


def nn_bidir_tiles(src, tgt, warps, run, blocks, seed=0):
    """nn_bidir as its kernel computes it, with the blocks' atomicMin
    merges applied in a random order (`seed`)."""
    b, n, m = src.shape[0], src.shape[1], tgt.shape[1]
    rt = cuda_nn.NN_BIDIR_RT
    units = cuda_nn.nn_bidir_units(b, n, m, warps, run)
    rows, chunk = warps * rt, LANES * run
    rblk, chunks = -(-n // rows), -(-m // chunk)
    assert units == b * rblk * chunks
    n_pad, m_pad = rblk * rows, chunks * chunk
    d = cuda_nn._sqdist_diff2(src, tgt)                       # (B, N, M)
    # rows past N and columns past M are NaN points: fminf passes over them
    dp = torch.full((b, n_pad, m_pad), float("nan"))
    dp[:, :n, :m] = d
    # fminf(inf, NaN) = inf
    fmin = torch.where(torch.isnan(dp), float("inf"), dp)
    # each lane's column-group minima: group g = chunk * 32 + lane
    gmin = fmin.reshape(b, n_pad, chunks, LANES, run).amin(-1)
    # each warp's minimum over its rt rows, then the first warp at the
    # block's minimum: row group h = row block * warps + warp
    wmin = fmin.reshape(b, rblk, warps, rt, m_pad).amin(3)
    v = wmin[:, :, 0]
    w = torch.zeros_like(v, dtype=torch.int64)
    for x in range(1, warps):
        better = wmin[:, :, x] < v
        v = torch.where(better, wmin[:, :, x], v)
        w = torch.where(better, torch.full_like(w, x), w)
    col_keys = _keys(v, torch.arange(rblk)[None, :, None] * warps + w)

    posts = []   # (key buffer, cloud, first index, keys) of every atomicMin
    writer = torch.arange(LANES) % (LANES // rt) == 0
    assert torch.equal((torch.arange(LANES) // (LANES // rt))[writer],
                       torch.arange(rt))
    for us in _block_units(units, blocks):
        held = None
        for u in list(us) + [None]:
            seg = None if u is None else u // chunks
            if held is not None and seg != held[0]:
                # the block's row block changes: each row's (best, group)
                # over the chunks it held, merged over the lanes
                cb, rb = held[0] // rblk, held[0] % rblk
                r = slice(rb * rows, (rb + 1) * rows)
                best = torch.full((rows, LANES), float("inf"))
                grp = torch.full((rows, LANES), held[1] * LANES)
                grp += torch.arange(LANES)
                for c in held[2]:
                    better = gmin[cb, r, c] < best
                    best = torch.where(better, gmin[cb, r, c], best)
                    grp = torch.where(better, c * LANES + torch.arange(LANES),
                                      grp)
                keys = _keys(best, grp).reshape(warps, rt, LANES)
                merged = rows_min_lanes(keys.transpose(1, 2))[:, writer]
                posts.append(("f", cb, rb * rows, merged.reshape(-1)))
            if u is None:
                break
            c = u % chunks
            if held is None or seg != held[0]:
                held = (seg, c, [])
            held[2].append(c)
            cb, rb = seg // rblk, seg % rblk
            posts.append(("b", cb, c * chunk,
                          col_keys[cb, rb, c * chunk:(c + 1) * chunk]))

    # the atomicMin of every post, in a random order: keys start all ones
    gen = torch.Generator().manual_seed(seed)
    key = {"f": torch.full((b, n_pad), -1, dtype=torch.int64),
           "b": torch.full((b, m_pad), -1, dtype=torch.int64)}
    for i in torch.randperm(len(posts), generator=gen).tolist():
        buf, cb, lo, k = posts[i]
        key[buf][cb, lo:lo + len(k)] = _atomic_min(
            key[buf][cb, lo:lo + len(k)], k)
    fkey, bkey = key["f"][:, :n], key["b"][:, :m]

    # decode: the first index of the winning group at the key's distance
    fd, bd = _key_dist(fkey), _key_dist(bkey)
    fi = torch.stack([_first_equal(d[i], (fkey[i] & 0xFFFFFFFF) * run, run,
                                   m, fd[i]) for i in range(b)])
    dt = d.transpose(1, 2)
    bi = torch.stack([_first_equal(dt[i], (bkey[i] & 0xFFFFFFFF) * rt, rt,
                                   n, bd[i]) for i in range(b)])
    return fd, fi, bd, bi


def _bidir_case(kind):
    """(src (B, N, 3), tgt (B, M, 3)) as numpy."""
    rng = np.random.RandomState(len(kind))
    src = rng.randn(2, 150, 3).astype(np.float32)
    tgt = rng.randn(2, 150, 3).astype(np.float32)
    if kind == "duplicates":
        # 13 points repeated: equal distances 13 apart straddle every group,
        # warp and chunk boundary, both ways
        pts = rng.randn(2, 13, 3).astype(np.float32)
        src = np.tile(pts, (1, 12, 1))[:, :150]
        tgt = np.tile(pts, (1, 12, 1))[:, 5:150]
    elif kind == "all_equal":
        src, tgt = np.zeros_like(src), np.zeros_like(tgt)
    elif kind == "n_below_m":
        src, tgt = src[:, :37], rng.randn(2, 301, 3).astype(np.float32)
    elif kind == "n_above_m":
        src, tgt = rng.randn(2, 301, 3).astype(np.float32), tgt[:, :37]
    elif kind == "ragged":   # no size a multiple of a group, warp or chunk
        src, tgt = src[:, :97], rng.randn(2, 211, 3).astype(np.float32)
    elif kind == "single":
        src, tgt = src[:1, :1], tgt[:1, :1]
    elif kind == "overflow":   # every distance +inf: index 0 both ways
        src, tgt = src * np.float32(1e20), tgt[:, :77] * np.float32(-1e20)
    return src, tgt


BIDIR_KINDS = ["random", "duplicates", "all_equal", "n_below_m",
               "n_above_m", "ragged", "single", "overflow"]
# (warps, run, blocks): warps of one to eight, short and full runs, one
# block, a few, and a block a unit
BIDIR_TILES = [(1, 1, 1), (2, 4, 7), (4, 16, 3), (1, 3, 5), (8, 2, 10 ** 6),
               (2, 5, 4), (1, 16, 2)]


@pytest.mark.parametrize("warps,run,blocks", BIDIR_TILES)
@pytest.mark.parametrize("kind", BIDIR_KINDS)
def test_nn_bidir_tiles_equal_plain(kind, warps, run, blocks):
    src, tgt = _bidir_case(kind)
    got = nn_bidir_tiles(_t(src), _t(tgt), warps, run, blocks,
                         seed=warps + run)
    ref = cuda_nn.nn_bidir_plain(_t(src), _t(tgt))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)   # bit for bit


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_nn_bidir_merge_in_any_block_order(seed):
    src, tgt = _bidir_case("duplicates")
    ref = nn_bidir_tiles(_t(src), _t(tgt), 1, 2, 6, seed=0)
    got = nn_bidir_tiles(_t(src), _t(tgt), 1, 2, 6, seed=seed)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_rows_min_lanes_owns_each_row_once():
    # lane keys with distinct values: every row's minimum lands in the
    # lanes l with l // (32 // RT) == row
    gen = torch.Generator().manual_seed(0)
    r = cuda_nn.NN_BIDIR_RT
    keys = torch.randint(0, 2 ** 40, (LANES, r), generator=gen)
    got = rows_min_lanes(keys)
    want = keys.min(0).values
    assert torch.equal(got, want[torch.arange(LANES) // (LANES // r)])


@pytest.mark.parametrize("kind", BIDIR_KINDS)
def test_nn_bidir_tiles_match_pallas_interpret(kind):
    src, tgt = _bidir_case(kind)
    plan = cuda_nn.nn_bidir_plan(src.shape[0], src.shape[1], tgt.shape[1],
                                 SMS)
    fd, fi, bd, bi = nn_bidir_tiles(_t(src), _t(tgt), *plan)
    with pltpu.force_tpu_interpret_mode():
        ref = nn_bidir_pallas(jnp.asarray(src), jnp.asarray(tgt))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(fd.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(bd.numpy(), np.asarray(ref[2]), **TOL)


def _bidir_coverage(b, n, m, warps, run, blocks):
    """How many times the launch visits each (cloud, row, column): block ->
    its units, unit -> (cloud, row block, chunk), warp -> RT rows, lane ->
    run columns of the chunk."""
    rt = cuda_nn.NN_BIDIR_RT
    units = cuda_nn.nn_bidir_units(b, n, m, warps, run)
    rows, chunk = warps * rt, LANES * run
    rblk, chunks = -(-n // rows), -(-m // chunk)
    hits = np.zeros((b, n, m), np.int64)
    sizes = []
    for us in _block_units(units, blocks):
        sizes.append(len(us))
        for u in us:
            cb, rb, c = u // chunks // rblk, u // chunks % rblk, u % chunks
            for w in range(warps):
                r0 = (rb * warps + w) * rt
                for lane in range(LANES):
                    a = c * chunk + lane * run
                    hits[cb, r0:min(n, r0 + rt), a:min(m, a + run)] += 1
    return hits, sizes


@pytest.mark.parametrize("b,n,m", [(2, 300, 1500), (2, 1500, 300),
                                   (3, 97, 211), (1, 1, 1), (5, 20, 20)])
def test_nn_bidir_plan_covers_every_pair_once(b, n, m):
    for plan in {cuda_nn.nn_bidir_plan(b, n, m, SMS), (1, 1, 1),
                 (2, 3, 5), (8, 16, 2), (4, 7, 10 ** 6)}:
        hits, sizes = _bidir_coverage(b, n, m, *plan)
        assert (hits == 1).all(), plan
        # every block the same work to within one unit
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1, plan


def test_nn_bidir_plan_fills_the_card():
    rt = cuda_nn.NN_BIDIR_RT
    # the Chamfer metric's frame stacks (robot 9, sapien 7, real 5 frames
    # of 4096 points): 8 warps, a full 16-column run, two blocks on every
    # SM, 4.8-8.7 units of 128 x 512 pairs a block
    for t in (9, 7, 5):
        assert cuda_nn.nn_bidir_plan(t, 4096, 4096, SMS) == (8, 16, 2 * SMS)
        assert cuda_nn.nn_bidir_units(t, 4096, 4096, 8, 16) == t * 32 * 8
    # N != M both ways, and fewer clouds: still two blocks an SM
    for b, n, m in ((9, 4096, 1024), (9, 1024, 4096), (1, 4096, 4096)):
        warps, run, blocks = cuda_nn.nn_bidir_plan(b, n, m, SMS)
        units = cuda_nn.nn_bidir_units(b, n, m, warps, run)
        assert blocks == min(units, 2 * SMS) and blocks >= 2 * SMS - 8
    for b, n, m in [(1, 1, 1), (70000, 5, 7), (3, 97, 211)]:
        warps, run, blocks = cuda_nn.nn_bidir_plan(b, n, m, SMS)
        assert warps & (warps - 1) == 0 and warps <= 8
        assert 1 <= run <= cuda_nn.NN_BIDIR_MAX_RUN
        assert (warps == 1 or warps // 2 * rt < n)
        per_sm = min(cuda_nn.NN_BIDIR_BLOCKS_PER_SM,
                     cuda_nn.NN_BIDIR_WARPS_PER_SM // warps)
        assert blocks == min(cuda_nn.nn_bidir_units(b, n, m, warps, run),
                             per_sm * SMS)


# ---------------------------------------------------------------------------
# nn1_coords: groups of lanes for small pairs, nn_topk's k = 1 for large
# ---------------------------------------------------------------------------

def nn1_coords_lanes(query, ref, lanes):
    """The packed route: lane s of a pair's group holds query point s and
    reference point s; reference point j reaches every lane by a shuffle
    from lane j, in ascending j, and a strict '<' keeps the first of equal
    distances; the winner's coordinates come from its lane."""
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    assert n <= lanes and m <= lanes
    q = torch.full((b, lanes, 3), float("nan"))
    q[:, :n] = query
    r = torch.zeros((b, lanes, 3))
    r[:, :m] = ref
    best = torch.full((b, lanes), float("inf"))
    bj = torch.zeros((b, lanes), dtype=torch.int64)
    for j in range(m):
        p = r[:, j:j + 1].expand(b, lanes, 3)                # the shuffle
        d = cuda_nn._sqdist_diff2(q.reshape(-1, 1, 3),
                                  p.reshape(-1, 1, 3)).reshape(b, lanes)
        better = d < best
        best = torch.where(better, d, best)
        bj = torch.where(better, torch.full_like(bj, j), bj)
    coords = torch.gather(r, 1, bj[..., None].expand(-1, -1, 3))
    return best[:, :n], bj[:, :n], coords[:, :n]


def nn1_coords_routes(query, ref, plan):
    route, a, c = plan
    if route == "packed":
        return nn1_coords_lanes(query, ref, a)
    d, i = nn_topk_split_merge(query, ref, 1, 1, c)
    i = i[..., 0]
    return d[..., 0], i, cuda_nn._gather_rows(ref, i)


def _pairs(p, f=20, seed=0):
    """(P^2, f, 3) query and reference anchor clouds of the graph stage's
    spatial cost: every ordered pair of P parts' f anchors."""
    a = np.random.RandomState(seed).randn(p, f, 3).astype(np.float32)
    q = np.broadcast_to(a[:, None], (p, p, f, 3)).reshape(p * p, f, 3)
    r = np.broadcast_to(a[None], (p, p, f, 3)).reshape(p * p, f, 3)
    return q, r


def _coords_case(kind):
    rng = np.random.RandomState(len(kind) + 7)
    if kind.startswith("pairs"):
        return _pairs(int(kind[5:]))
    if kind == "duplicates":       # 4 points repeated: ties everywhere
        base = rng.randn(3, 4, 3).astype(np.float32)
        return np.tile(base, (1, 5, 1)), np.tile(base, (1, 7, 1))[:, 1:]
    if kind == "all_equal":
        return np.zeros((2, 9, 3), np.float32), np.zeros((2, 13, 3),
                                                         np.float32)
    if kind == "n_below_m":
        return (rng.randn(4, 3, 3).astype(np.float32),
                rng.randn(4, 30, 3).astype(np.float32))
    if kind == "n_above_m":
        return (rng.randn(4, 31, 3).astype(np.float32),
                rng.randn(4, 2, 3).astype(np.float32))
    if kind == "single":
        return (rng.randn(1, 1, 3).astype(np.float32),
                rng.randn(1, 1, 3).astype(np.float32))
    if kind == "ragged":           # past the packed route: nn_topk's
        return (rng.randn(2, 60, 3).astype(np.float32),
                rng.randn(2, 150, 3).astype(np.float32))
    return (rng.randn(5, 12, 3).astype(np.float32),
            rng.randn(5, 17, 3).astype(np.float32))


COORDS_KINDS = ["pairs20", "pairs7", "pairs2", "random", "duplicates",
                "all_equal", "n_below_m", "n_above_m", "single", "ragged"]


@pytest.mark.parametrize("kind", COORDS_KINDS)
def test_nn1_coords_routes_equal_plain(kind):
    q, r = _coords_case(kind)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    ref = cuda_nn.nn1_coords_plain(_t(q), _t(r))
    plans = [cuda_nn.nn1_coords_plan(b, n, m, SMS)]
    if max(n, m) <= cuda_nn.NN1C_MAX_PACKED:   # every width that holds both
        plans += [("packed", w, 1) for w in cuda_nn.NN1C_LANES
                  if w >= max(n, m)]
    plans += [("topk", 1, s) for s in (1, 4)]
    for plan in plans:
        got = nn1_coords_routes(_t(q), _t(r), plan)
        for g, e in zip(got, ref):
            assert g.dtype == e.dtype and torch.equal(g, e), plan


@pytest.mark.parametrize("kind", ["pairs7", "duplicates", "all_equal",
                                  "n_above_m", "ragged"])
def test_nn1_coords_routes_match_pallas_interpret(kind):
    q, r = _coords_case(kind)
    plan = cuda_nn.nn1_coords_plan(q.shape[0], q.shape[1], r.shape[1], SMS)
    d, i, c = nn1_coords_routes(_t(q), _t(r), plan)
    with pltpu.force_tpu_interpret_mode():
        d_ref, i_ref, c_ref = nn1_coords_pallas(jnp.asarray(q),
                                                jnp.asarray(r))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("b,n,m", [(400, 20, 20), (49, 20, 20), (4, 20, 20),
                                   (1, 1, 1), (70000, 5, 7), (3, 9, 16)])
def test_nn1_coords_plan_covers_every_query_once(b, n, m):
    route, lanes, warps = cuda_nn.nn1_coords_plan(b, n, m, SMS)
    assert route == "packed" and lanes >= max(n, m)
    assert lanes == min(w for w in cuda_nn.NN1C_LANES if w >= max(n, m))
    blocks = cuda_nn.nn1_coords_blocks(b, n, (route, lanes, warps))
    # thread t of block k: pair (k * 32 warps + t) // lanes, query t % lanes
    t = np.arange(blocks * 32 * warps)
    pair, s = t // lanes, t % lanes
    live = (pair < b) & (s < n)
    hits = np.bincount(pair[live] * n + s[live], minlength=b * n)
    assert (hits == 1).all()
    assert blocks * warps * 32 // lanes >= b > (blocks - 1) * warps * 32 // lanes


def test_nn1_coords_plan_packs_the_graph_stage():
    # (P^2, 20, 20): a warp a pair, three pairs a block, and at P = 20 a
    # block on every SM
    assert cuda_nn.nn1_coords_plan(400, 20, 20, SMS) == ("packed", 32, 3)
    assert cuda_nn.nn1_coords_blocks(400, 20, ("packed", 32, 3)) == 134
    for p in (20, 7, 6, 5, 4, 2, 1):
        route, lanes, warps = cuda_nn.nn1_coords_plan(p * p, 20, 20, SMS)
        assert (route, lanes, warps) == ("packed", 32, cuda_nn.NN1C_WARPS)
    # smaller clouds share a warp: 2 or 4 pairs a warp
    assert cuda_nn.nn1_coords_plan(9, 16, 9, SMS)[1] == 16
    assert cuda_nn.nn1_coords_plan(9, 5, 8, SMS)[1] == 8
    # past 32 points a cloud: nn_topk's k = 1 plan
    assert cuda_nn.nn1_coords_plan(9, 4096, 4096, SMS) == (
        ("topk",) + cuda_nn.nn_topk_plan(9, 4096, 4096, 1, SMS))
    assert cuda_nn.nn1_coords_plan(2, 20, 33, SMS)[0] == "topk"

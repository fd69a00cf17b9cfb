"""The tail rules of the streamed and banded auction kernels
(csrc/auction_cluster.cuh with csrc/auction_hbm.cu and
csrc/auction_banded.cu), written in PyTorch and held to the plain versions
on the CPU.

A row of the streamed kernel bids from its candidate cache where the cache
answers, and reads its whole domain (its M benefit entries) otherwise; a
row of the banded kernel always reads its window of w band values. A read keeps, per lane of the reading warp, the lane's best
column (the lowest of its best value) and its second value as a bound; the
lanes' lists merge by repeatedly taking the largest head (larger value,
then lower column): the heads taken while they are columns (up to K) are
cached with their benefit, and the first head that is a bound, or the
(K + 1)-th, is beta. A read split over several warps (contiguous shares of
the domain, in both kernels) merges the warps' lists by the same rule, the
order-free rule of the split row pass. A later bid
recomputes the cached values against the current prices and trusts them
where v1 > beta and v2 >= beta: prices only rise, so no value outside the
cache can pass beta. Whole toy auctions run by these rules must give the
plain versions' row_to_col, prices and stats bit for bit (dense and banded,
cold and warm, carry off and on, integer-cost ties, a sweep bound that
leaves rows), and row_to_col equal to the JAX package's (the sweep loop of
`auction_lap(..., use_resident=False)`, the interpret-mode
`auction_solve_banded`) with prices within rtol 1e-6, atol 1e-6, as
tests/test_torch_auction.py and tests/test_torch_banded.py hold them. The
gates that route a problem to the kernels are tested at their edges."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops import pallas_auction as JP
from reart_tpu.ops.assignment import auction_lap as jax_auction_lap
from reart_tpu_torch.ops import assignment as A
from reart_tpu_torch.ops import cuda_auction as C

torch.set_num_threads(1)

K = C.CACHE_K
BOUND = 2 ** 32 - 1      # a list entry that is a bound, not a column
NO_COL = 2 ** 31 - 1     # a lane that saw no column
LANES = 32
CLUSTER = 8


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _walkers(length, unit, shares):
    """(share, lane) of each position of a domain of `length` columns read
    by `shares` warps: units of `unit` columns, contiguous shares of
    ceil(units / shares) units, lane = the unit's index in its share % 32."""
    units = length // unit
    per = -(-units // shares)
    q = torch.arange(length) // unit
    share = q // per
    return share, share * LANES + (q - share * per) % LANES


def _pop(v, x, j, k, m):
    """The kernels' merge (Cands::pop) of lists (R, 32, L), value
    descending: up to k + 1 times the largest head leaves its lane. Returns
    b1, j1, b2, beta (R,) and the candidates' benefit and column (R, k)
    and their values (column NO_COL where fewer were taken)."""
    v, x, j = v.clone(), x.clone(), j.clone()
    rows = v.shape[0]
    idx = torch.arange(rows)
    open_ = torch.ones(rows, dtype=torch.bool)
    beta = torch.full((rows,), float("nan"))
    cx = torch.zeros((rows, k))
    cv = torch.full((rows, k), float("-inf"))
    cj = torch.full((rows, k), NO_COL, dtype=torch.int64)
    for step in range(k + 1):
        head = v[:, :, 0] + 0.0
        top = head.max(dim=1).values
        is_top = head == top[:, None]
        col = torch.where(is_top, j[:, :, 0], 2 ** 33).min(dim=1).values
        owner = is_top & (j[:, :, 0] == col[:, None])
        if step == 0:
            b1, j1 = top, torch.where(col < m, col, NO_COL)
        if step == 1:
            b2 = top
        lane = owner.int().argmax(dim=1)
        take = open_ & (col < m) & (step < k)
        if step < k:
            cx[:, step] = torch.where(take, x[idx, lane, 0], 0.0)
            cv[:, step] = torch.where(take, top, float("-inf"))
            cj[:, step] = torch.where(take, col, NO_COL)
        close = open_ & ~take
        beta = torch.where(close, top, beta)
        open_ = open_ & take
        # the owners' lists move up by one
        sh = owner[:, :, None]
        v = torch.where(sh, torch.cat([v[:, :, 1:], torch.full_like(
            v[:, :, :1], float("-inf"))], 2), v)
        x = torch.where(sh, torch.cat([x[:, :, 1:], torch.zeros_like(
            x[:, :, :1])], 2), x)
        j = torch.where(sh, torch.cat([j[:, :, 1:], torch.full_like(
            j[:, :, :1], BOUND)], 2), j)
    return b1, j1, b2, beta, cx, cj, cv


def _empty_lists(rows, length):
    """Cands::clear: (-inf, NO_COL) first, then bounds at -inf."""
    v = torch.full((rows, LANES, length), float("-inf"))
    j = torch.full((rows, LANES, length), BOUND, dtype=torch.int64)
    j[:, :, 0] = NO_COL
    return v, torch.zeros((rows, LANES, length)), j


def read_rows(v, bx, cols, k, m, unit=1, shares=1):
    """A read of rows' domains: v, bx (R, L) values and benefits, cols
    (R, L) ascending. Returns b1, j1, b2 (the rows' top-2, as
    top2_warp_redux gives them) and the refreshed cache (cx, cj, beta)."""
    rows, length = v.shape
    share, walker = _walkers(length, unit, shares)
    g = shares * LANES
    w = walker.expand(rows, length)
    best = torch.full((rows, g), float("-inf")).scatter_reduce(
        1, w, v, "amax")
    pos = torch.arange(length).expand(rows, length)
    first = torch.full((rows, g), length).scatter_reduce(
        1, w, torch.where(v == best.gather(1, w), pos, length), "amin")
    found = (first < length) & (best > float("-inf"))
    firstc = first.clamp(max=length - 1)
    second = torch.full((rows, g), float("-inf")).scatter_reduce(
        1, w, torch.where(pos == firstc.gather(1, w), float("-inf"), v),
        "amax")
    # each lane's list: its best column, then its second value as a bound
    lv = torch.stack([torch.where(found, best, float("-inf")), second], 2)
    lx = torch.stack([torch.where(found, bx.gather(1, firstc), 0.0),
                      torch.zeros_like(best)], 2)
    lj = torch.stack([torch.where(found, cols.gather(1, firstc), NO_COL),
                      torch.full_like(first, BOUND)], 2)
    lv = lv.reshape(rows, shares, LANES, 2)
    lx = lx.reshape(rows, shares, LANES, 2)
    lj = lj.reshape(rows, shares, LANES, 2)
    if shares == 1:
        b1, j1, b2, beta, cx, cj, _ = _pop(lv[:, 0], lx[:, 0], lj[:, 0], k,
                                           m)
        return b1, j1, b2, cx, cj, beta
    # each share's candidates, then its bound: the merging warp's lists
    mv, mx, mj = _empty_lists(rows, k + 1)
    for s in range(shares):
        _, _, _, beta_s, cx, cj, cv = _pop(lv[:, s], lx[:, s], lj[:, s], k,
                                           m)
        taken = (cj < m).sum(1)
        at = torch.arange(k + 1)[None]
        mv[:, s] = torch.where(at < taken[:, None], torch.cat(
            [cv, torch.zeros((rows, 1))], 1), float("-inf"))
        mv[:, s] = torch.where(at == taken[:, None], beta_s[:, None],
                               mv[:, s])
        mx[:, s, :k] = cx
        mj[:, s] = torch.where(at < taken[:, None], torch.cat(
            [cj, torch.zeros((rows, 1), dtype=torch.int64)], 1), BOUND)
    b1, j1, b2, beta, cx, cj, _ = _pop(mv, mx, mj, k, m)
    return b1, j1, b2, cx, cj, beta


def cache_top2(cx, cj, beta, price_rows, m):
    """cache_top2: the cached values against the current prices; returns
    (hit, b1, j1, b2)."""
    valid = cj < m
    p = price_rows.gather(1, cj.clamp(max=m - 1))
    v = torch.where(valid, cx - p, float("-inf"))
    b1 = v.max(1).values
    j1 = torch.where((v == b1[:, None]) & valid, cj, NO_COL).min(1).values
    j1 = torch.where(valid.any(1), j1, NO_COL)
    other = torch.where(cj == j1[:, None], float("-inf"), v)
    b2 = other.max(1).values
    return (b1 > beta) & (b2 >= beta), b1, j1, b2


class CachedRows:
    """A batch of rows' domains with their caches: bx (B, N, L) benefits,
    cols (N, L) their columns (ascending), read in units of `unit`."""

    def __init__(self, bx, cols, m, k=K, unit=1):
        """k = 0: no cache, every bid reads its row."""
        self.bx, self.cols, self.m, self.k, self.unit = bx, cols, m, k, unit
        b, n, _ = bx.shape
        self.cx = torch.zeros((b, n, max(k, 1)))
        self.cj = torch.full((b, n, max(k, 1)), NO_COL, dtype=torch.int64)
        self.beta = torch.full((b, n), float("inf"))
        self.hits = self.reads = 0

    def top2(self, which, price, shares_of=lambda e: (lambda r: 1)):
        """(b1, j1, b2) (B, N) of the rows in `which` (B, N) under `price`
        (B, M): from the cache where it answers, else read (shares_of(e)(r)
        warps row r of element e) and refreshed. Other rows' values are
        not used."""
        b, n, length = self.bx.shape
        b1 = torch.zeros((b, n))
        b2 = torch.zeros((b, n))
        j1 = torch.zeros((b, n), dtype=torch.int64)
        for e in range(b):
            rows = torch.nonzero(which[e])[:, 0]
            if len(rows) == 0:
                continue
            p = price[e][None].expand(len(rows), self.m)
            hit, h1, hj, h2 = cache_top2(self.cx[e, rows], self.cj[e, rows],
                                         self.beta[e, rows], p, self.m)
            self.hits += int(hit.sum())
            miss = rows[~hit]
            b1[e, rows], j1[e, rows], b2[e, rows] = h1, hj, h2
            of = shares_of(e)
            for shares in sorted({of(int(r)) for r in miss}):
                sel = miss[torch.tensor([of(int(r)) == shares
                                         for r in miss])]
                cols = self.cols[sel]
                v = self.bx[e, sel] - price[e].gather(0, cols.reshape(-1)
                                                     ).reshape(cols.shape)
                # without a cache, the same merge of one candidate gives the
                # top-2, and the cache it would keep refuses every bid
                r1, rj, r2, cx, cj, beta = read_rows(
                    v, self.bx[e, sel], cols, max(self.k, 1), self.m,
                    self.unit, shares)
                if self.k == 0:
                    beta = torch.full_like(beta, float("inf"))
                b1[e, sel], j1[e, sel], b2[e, sel] = r1, rj, r2
                self.cx[e, sel], self.cj[e, sel] = cx, cj
                self.beta[e, sel] = beta
                self.reads += len(sel)
        return b1, j1, b2


def _bid_round(rows, r2c, c2r, price, eps, which, shares_of):
    """One Jacobi sweep by the rules: the rows in `which` bid from their
    caches or reads; columns take their highest bid (lowest row)."""
    b, n = r2c.shape
    m = price.shape[1]
    b1, j1, b2 = rows.top2(which, price, shares_of)
    bid = (b1 - b2) + eps
    none = torch.iinfo(torch.int64).min
    key = torch.where(which, C._bid_keys(bid), none)
    col_key = torch.full((b, m), none, dtype=torch.int64)
    col_key.scatter_reduce_(1, torch.where(which, j1, 0), key, "amax")
    got = col_key != none
    winner = torch.where(got, (1 << 32) - 1 - (col_key & 0xFFFFFFFF), 0)
    price = torch.where(got, price + torch.gather(bid, 1, winner), price)
    old = torch.where(got & (c2r >= 0), c2r, n)
    r2c = torch.cat([r2c, r2c[:, :1]], 1).scatter(1, old, -1)[:, :n]
    seat = torch.where(got, winner, n)
    cids = torch.arange(m).expand(b, m)
    r2c = torch.cat([r2c, r2c[:, :1]], 1).scatter(1, seat, cids)[:, :n]
    c2r = torch.where(got, winner, c2r)
    return r2c, c2r, price


def _shares_rule(which, split_max, tail_rows):
    """The kernels' choice of warps a row for a read: one (the warp pass)
    while more than split_max rows bid; else the split pass's power of two
    from the count of rows its block reads (block r % 8, or one block when
    at most tail_rows rows bid). Misses are not known ahead, so the count
    here is the block's bidding rows: any cut gives the same bids."""
    counts = which.sum(1)

    def rule(e):
        bidders = int(counts[e])
        if bidders > split_max:
            return lambda r: 1
        rows = torch.nonzero(which[e])[:, 0]
        block = (lambda r: 0) if bidders <= tail_rows else (
            lambda r: r % CLUSTER)
        per_block = {}
        for r in rows.tolist():
            per_block[block(r)] = per_block.get(block(r), 0) + 1

        def shares(r):
            per = LANES
            while per > 1 and per * per_block[block(r)] > LANES:
                per //= 2
            return per
        return shares
    return rule


def dense_solve(benefit, price, eps_list, max_sweeps, k=K, unit=1,
                split_max=8, tail_rows=2):
    """The streamed kernel's auction by the rules -> (row_to_col, prices,
    stats, hits, reads)."""
    b, n, m = benefit.shape
    rows = CachedRows(benefit, torch.arange(m).expand(n, m), m, k, unit)
    price = price.clone()
    stats = torch.zeros((b, len(eps_list), 2), dtype=torch.int32)
    for e, eps in enumerate(eps_list):
        r2c = torch.full((b, n), -1, dtype=torch.int64)
        c2r = torch.full((b, m), -1, dtype=torch.int64)
        for _ in range(max_sweeps):
            un = r2c < 0
            if not bool(un.any()):
                break
            stats[:, e, 0] += un.any(1).int()
            stats[:, e, 1] += un.sum(1, dtype=torch.int32)
            r2c, c2r, price = _bid_round(
                rows, r2c, c2r, price, eps, un,
                _shares_rule(un, split_max, tail_rows))
    return r2c, price, stats, rows.hits, rows.reads


def _band(src, tgt, w, tile):
    """The plain version's band values and their columns."""
    b, n, _ = src.shape
    m = tgt.shape[1]
    nt = n // tile
    offs = torch.tensor(C._band_offsets(n, m, w, tile))
    cols = offs[:, None] + torch.arange(w)
    s = src.reshape(b, nt, tile, 1, 3)
    t = tgt[:, cols][:, :, None]
    acc = None
    for c in range(3):
        d = s[..., c] - t[..., c]
        acc = d * d if acc is None else acc + d * d
    band = -torch.sqrt(acc.double()).float()
    return band.reshape(b, n, w), cols.repeat_interleave(tile, 0)


def banded_solve(src, tgt, price, eps_list, max_sweeps, w, tile, carry,
                 k=0, split_max=8, tail_rows=0):
    """The banded kernel's auction by the rules -> (row_to_col, prices,
    stats, hits, reads): no cache (k = 0), its late sweeps on the cluster
    (no tail on one block)."""
    b, n, _ = src.shape
    m = tgt.shape[1]
    band, cols = _band(src, tgt, w, tile)
    rows = CachedRows(band, cols, m, k)
    price = price.clone()
    stats = torch.zeros((b, len(eps_list), 3), dtype=torch.int32)
    r2c = torch.full((b, n), -1, dtype=torch.int64)
    c2r = torch.full((b, m), -1, dtype=torch.int64)
    for e, eps in enumerate(eps_list):
        if not carry or e == 0:
            r2c.fill_(-1)
            c2r.fill_(-1)
        else:
            # the carry pass: every seated row's window best, by the rules
            seated = r2c >= 0
            b1 = rows.top2(seated, price)[0]
            held = r2c.clamp(min=0)
            pos = held - cols[None, :, 0]
            cur = band.gather(2, pos.clamp(0, w - 1)[..., None])[..., 0]
            cur = cur - price.gather(1, held)
            viol = seated & (cur < b1 - eps)
            freed = torch.zeros((b, m + 1), dtype=torch.bool)
            freed.scatter_(1, torch.where(viol, r2c, m), True)
            c2r = torch.where(freed[:, :m], -1, c2r)
            r2c = torch.where(viol, -1, r2c)
        for _ in range(max_sweeps):
            un = r2c < 0
            if not bool(un.any()):
                break
            stats[:, e, 0] += un.any(1).int()
            stats[:, e, 1] += un.sum(1, dtype=torch.int32)
            stats[:, e, 2] += un.reshape(b, n // tile, tile).any(-1).sum(
                1, dtype=torch.int32)
            r2c, c2r, price = _bid_round(
                rows, r2c, c2r, price, eps, un,
                _shares_rule(un, split_max, tail_rows))
    # rows left at the bound take their best in-band column
    left = r2c < 0
    j1 = rows.top2(left, price)[1]
    return (torch.where(left, j1, r2c), price, stats, rows.hits, rows.reads)


# ---------------------------------------------------------------------------
# the rules against the plain versions and the JAX package
# ---------------------------------------------------------------------------

def _eps_list(eps_min, num_scales, scale_factor):
    """auction_lap's schedule, high to low."""
    return tuple(float(eps_min * scale_factor ** k)
                 for k in range(num_scales - 1, -1, -1))


DENSE_CASES = {
    # seed, shape, integer costs, (eps_min, num_scales, scale_factor),
    # max_sweeps, warm
    "cold": (3, (2, 48, 64), False, (1e-3, 2, 10.0), 200, False),
    "warm": (4, (2, 48, 64), False, (1e-3, 2, 10.0), 200, True),
    "m_not_a_multiple_of_4": (5, (2, 40, 71), False, (1e-3, 2, 10.0), 200,
                              False),
    "integer_ties": (6, (2, 48, 52), True, (1e-2, 3, 10.0), 200, False),
    "sweep_bound": (7, (2, 48, 64), False, (1e-4, 2, 50.0), 3, False),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_rules_equal_the_plain_version_and_jax(case):
    """The streamed kernel's rules (cache, split reads, the tail on one
    block) give auction_solve_resident_hbm_plain's row_to_col, prices and
    stats bit for bit; completed greedily, the JAX sweep loop's matching."""
    seed, shape, ties, sched, sweeps, warm = DENSE_CASES[case]
    rng = np.random.RandomState(seed)
    cost = (rng.randint(0, 4, shape) if ties
            else rng.rand(*shape)).astype(np.float32)
    benefit = -torch.from_numpy(cost)
    eps = _eps_list(*sched)
    price = torch.zeros((shape[0], shape[2]))
    if warm:
        price = C.auction_solve_resident_hbm_plain(
            -torch.from_numpy(rng.rand(*shape).astype(np.float32)), price,
            eps, 200)[1]
    unit = 4 if shape[2] % 4 == 0 else 1
    r, p, st, hits, reads = dense_solve(benefit, price, eps, sweeps,
                                        unit=unit)
    ref = C.auction_solve_resident_hbm_plain(benefit, price, eps, sweeps,
                                             return_stats=True)
    assert torch.equal(r, ref[0]) and torch.equal(p, ref[1])
    assert torch.equal(st, ref[2])
    assert hits > 0 and reads >= shape[0] * shape[1]
    assert bool((r < 0).any()) == (case == "sweep_bound")
    # the JAX package's sweep loop, with its greedy completion
    done = torch.where(r < 0, torch.argmax(benefit - p[:, None, :], -1), r)
    r_j, p_j = jax_auction_lap(
        jnp.asarray(cost), eps_min=sched[0], num_scales=sched[1],
        scale_factor=sched[2], max_sweeps=sweeps, return_price=True,
        use_resident=False, price=jnp.asarray(price.numpy()))
    np.testing.assert_array_equal(done.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=1e-6,
                               atol=1e-6)


def _clouds(seed, b, n, noise):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, 3).astype(np.float32)
    return src, (src + noise * rng.randn(b, n, 3)).astype(np.float32)


def _jax_banded(src, tgt, price, **kw):
    with pltpu.force_tpu_interpret_mode():
        r2c, p = JP.auction_solve_banded(
            jnp.asarray(src), jnp.transpose(jnp.asarray(tgt), (0, 2, 1)),
            jnp.asarray(price), **kw)
    return np.asarray(r2c), np.asarray(p)


# tests/test_torch_banded.py's problems: a full band; a narrow band whose
# sweep bound leaves rows to the in-band completion
BANDED_CASES = {
    "full_band": (3, 2, 64, 64, 8, (5e-3, 1e-4), 2000),
    "narrow_band_bound": (7, 2, 128, 32, 16, (5e-3, 1e-4), 20),
}


@pytest.mark.parametrize("case", list(BANDED_CASES))
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_banded_rules_equal_the_plain_version_and_jax(case, carry, warm):
    """The banded kernel's rules (split reads, the carry pass) give
    auction_solve_banded_plain's row_to_col, prices and stats bit for bit,
    and the interpret-mode Pallas kernel's row_to_col; so do the same rules
    with the streamed kernel's cache."""
    seed, b, n, w, tile, eps, sweeps = BANDED_CASES[case]
    src, tgt = _clouds(seed, b, n, 0.03)
    price = (np.random.RandomState(seed + 1).rand(b, n).astype(np.float32)
             * 0.05 if warm else np.zeros((b, n), np.float32))
    args = (torch.from_numpy(src), torch.from_numpy(tgt),
            torch.from_numpy(price))
    ref = C.auction_solve_banded_plain(*args, eps, sweeps, w, tile, carry,
                                       return_stats=True)
    for k in (0, K):
        r, p, st, hits, reads = banded_solve(*args, eps, sweeps, w, tile,
                                             carry, k=k)
        assert torch.equal(r, ref[0]) and torch.equal(p, ref[1])
        assert torch.equal(st, ref[2])
        assert (hits > 0) == (k > 0) and reads >= b * n
    jr, jp = _jax_banded(src, tgt, price, eps_list=eps, max_sweeps=sweeps,
                         w=w, tile=tile, carry=carry)
    np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shares", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("unit,length", [(1, 96), (1, 1000), (4, 512)])
@pytest.mark.parametrize("ties", [False, True])
def test_split_reads_merge_to_the_whole_row(shares, unit, length, ties):
    """A read cut into `shares` contiguous shares of whole units gives the
    top-2 of the whole row (row_top2_plain: the first best column; values
    bit for bit after +0.0, as the kernels' reductions give them), at most
    K candidates each at or above beta, and no other column above beta."""
    rng = np.random.RandomState(shares * length + ties)
    rows = 16
    raw = (rng.randint(0, 3, (1, rows, length)) if ties
           else rng.randn(1, rows, length)).astype(np.float32)
    price = (rng.rand(1, length) * (0.0 if ties else 0.5)).astype(np.float32)
    bx, pr = torch.from_numpy(raw), torch.from_numpy(price)
    v = bx[0] - pr
    cols = torch.arange(length).expand(rows, length)
    b1, j1, b2, cx, cj, beta = read_rows(v, bx[0], cols, K, length, unit,
                                         shares)
    r1, r2, rj = C.row_top2_plain(bx, pr)
    assert torch.equal(j1, rj[0])
    assert torch.equal((b1 + 0.0).view(torch.int32),
                       (r1[0] + 0.0).view(torch.int32))
    assert torch.equal((b2 + 0.0).view(torch.int32),
                       (r2[0] + 0.0).view(torch.int32))
    cached = torch.zeros((rows, length + 1), dtype=torch.bool)
    cached.scatter_(1, torch.where(cj < length, cj, length), True)
    outside = torch.where(cached[:, :length], float("-inf"), v)
    assert (outside.max(1).values <= beta).all()
    cval = torch.where(cj < length, cx - pr[0][cj.clamp(max=length - 1)],
                       float("inf"))
    assert (cval >= beta[:, None]).all()
    # at the prices it was read at, the cache answers only where the row's
    # top-2 passes beta (not always there: the second may be a bound), and
    # then with the row's top-2
    hit, h1, hj, h2 = cache_top2(cx, cj, beta, pr.expand(rows, length),
                                 length)
    assert not (hit & ~((b1 > beta) & (b2 >= beta))).any()
    assert hit.any() or ties
    assert torch.equal(hj[hit], j1[hit]) and torch.equal(h1[hit], b1[hit])
    assert torch.equal(h2[hit], b2[hit])


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), length=st.integers(2, 160),
       shares=st.sampled_from([1, 2, 4, 32]), ties=st.booleans(),
       steps=st.integers(1, 8))
def test_cache_is_refused_or_exact_under_rising_prices(seed, length, shares,
                                                       ties, steps):
    """For a random benefit row and any sequence of non-decreasing prices,
    the cached top-2 is refused or equals the whole row's top-2 (the first
    best column, the values bit for bit after +0.0), and a refused row's
    re-read refreshes the cache."""
    rng = np.random.RandomState(seed % (2 ** 32))
    raw = (rng.randint(0, 3, (1, 1, length)) if ties
           else rng.randn(1, 1, length)).astype(np.float32)
    bx = torch.from_numpy(raw)
    price = torch.from_numpy(
        (rng.rand(1, length) * (0 if ties else 0.3)).astype(np.float32))
    cols = torch.arange(length)[None]
    _, _, _, cx, cj, beta = read_rows(bx[0] - price, bx[0], cols, K, length,
                                      1, min(shares, length))
    for _ in range(steps):
        rise = rng.rand(1, length) < rng.rand()
        step = (rng.choice([0.0, 1.0, 1e-7, 0.01], (1, length)) if ties
                else rng.exponential(0.05, (1, length)))
        price = price + torch.from_numpy(
            np.where(rise, step, 0.0).astype(np.float32))
        hit, b1, j1, b2 = cache_top2(cx, cj, beta, price, length)
        r1, r2, rj = C.row_top2_plain(bx, price)
        if bool(hit[0]):
            assert int(j1[0]) == int(rj[0, 0])
            assert (b1 + 0.0).view(torch.int32) == (r1[0] + 0.0).view(
                torch.int32)
            assert (b2 + 0.0).view(torch.int32) == (r2[0] + 0.0).view(
                torch.int32)
        else:
            _, _, _, cx, cj, beta = read_rows(
                bx[0] - price, bx[0], cols, K, length, 1,
                min(shares, length))


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def test_streamed_gate_admits_the_states_that_fit():
    """The streamed window (1024^2 < N*M <= 2048^2, N <= M) narrowed to the
    shapes whose cluster state (with the split row pass's lists and the
    cache) fits a block's shared memory: at N = 80, M up to 14248."""
    for n, m in ((1025, 1025), (2048, 2048), (1024, 2048), (700, 1501),
                 (80, 13108), (80, 14248), (75, 14250)):
        assert C.resident_hbm_available(n, m), (n, m)
    for n, m in ((1024, 1024), (2048, 2049), (80, 14249), (75, 14251),
                 (2048, 1024), (1, 2 ** 21)):
        assert not C.resident_hbm_available(n, m), (n, m)
    assert (C._cluster_smem(80, 14248, 1, C.CACHE_K)
            <= C._CLUSTER_MAX_SMEM
            < C._cluster_smem(80, 14249, 1, C.CACHE_K))


def test_auction_lap_cpu_results_unchanged_past_the_narrowed_gate():
    """On the CPU a shape the narrowed gate turns away (N = 80, M = 14249)
    sweeps through the plain phase loop, which the streamed kernel's plain
    version is: the same matching and prices as before."""
    rng = np.random.RandomState(11)
    cost = torch.from_numpy(rng.rand(1, 80, 14249).astype(np.float32))
    kw = dict(eps_min=1e-3, num_scales=2, scale_factor=10.0, max_sweeps=50)
    r, p = A.auction_lap(cost, return_price=True, **kw)
    eps = _eps_list(1e-3, 2, 10.0)
    r_ref, p_ref = C.auction_solve_resident_hbm_plain(
        (-cost).contiguous(), torch.zeros((1, 14249)), eps, 50)
    done = torch.where(r_ref < 0,
                       torch.argmax(-cost - p_ref[:, None, :], -1), r_ref)
    assert torch.equal(r, done) and torch.equal(p, p_ref)


@pytest.mark.parametrize("device", ["cpu", torch.device("cuda")])
def test_banded_route_by_size(device):
    """The banded solve's design by size: the cluster design while N <= M
    and its state fits a block's shared memory (N = M up to 9216 at the
    fit's tiles), the global-state design past that up to M = 57856, none
    beyond. banded_available still decides by device."""
    tile = C.band_tile
    for n in (1152, 2048, 4096, 9216):
        assert C.banded_route(n, n, tile(n)) == "shared", n
        assert C.banded_available(n, n, 256, device=device) == (
            torch.device(device).type == "cuda")
    for n in (9472, 12288, 32768):
        assert C.banded_route(n, n, tile(n)) == "global", n
    assert C.banded_route(2048, 4096, 256) == "shared"
    assert C.banded_route(4096, 2048, 256) == "global"  # N > M
    assert C.banded_route(57856, 57856, 256) == "global"
    assert C.banded_route(58112, 58112, 256) is None
    # the edge of the cluster design's state
    edge = max(n for n in range(4096, 9473, 8)
               if n % tile(n) == 0 and C.banded_route(n, n, tile(n))
               == "shared")
    assert edge == 9216


def test_banded_wrapper_on_cpu_takes_the_plain_version():
    src, tgt = _clouds(2, 1, 64, 0.03)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.zeros(1, 64))
    before = C.auction_solve_banded.launches
    got = C.auction_solve_banded(*args, (5e-3, 1e-4), 100, 32, 8,
                                 return_stats=True)
    ref = C.auction_solve_banded_plain(*args, (5e-3, 1e-4), 100, 32, 8,
                                       return_stats=True)
    assert C.auction_solve_banded.launches == before
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_build_options_reach_every_source_and_name_their_library():
    """The option sizes of ops/_build (the -D flags) are the ones the
    sources read and the gates use; each variant of bench_auction overrides
    only those and builds a library of its own."""
    from reart_tpu_torch import bench_auction
    from reart_tpu_torch.ops import _build

    text = "".join(open(f).read() for f in _build.sources())
    for name in _build.DEFINES:
        assert name in text, name
        assert f"-D{name}={_build.DEFINES[name]}" in _build._flags(None)
    assert C.CACHE_K == _build.DEFINES["REART_CACHE_K"]
    assert C.BAND_CACHE_K == _build.DEFINES["REART_BAND_CACHE_K"]
    paths = set()
    for variant, defines in bench_auction.VARIANTS.items():
        assert set(defines) <= set(_build.DEFINES), variant
        paths.add(_build.library_path(defines))
    assert len(paths) == len(bench_auction.VARIANTS)
    assert _build.library_path(bench_auction.VARIANTS["as built"]) == \
        _build.library_path()


# (kernel, N, M, tile) -> (slot buffers, option, shared-memory bytes) as the
# kernel library itself reports them (cuda_auction.cluster_config, from
# csrc/'s `fit` over auction_cluster.cuh cluster_layout), at each change of
# configuration across the size gates' edges and at the scans' ends:
# chip_smoke.py phase 3 prints this table (NVIDIA H100 80GB HBM3).
LIBRARY_CONFIGS = {
    ('resident_hbm', 80, 80, 0): (2, 4, 6328),
    ('resident_hbm', 80, 14208, 0): (2, 4, 232376),
    ('resident_hbm', 80, 14209, 0): (1, 4, 231752),
    ('resident_hbm', 80, 14248, 0): (1, 4, 232376),
    ('resident_hbm', 80, 14249, 0): (0, 0, 0),
    ('resident_hbm', 80, 16000, 0): (0, 0, 0),
    ('resident_hbm', 1100, 1100, 0): (2, 4, 44600),
    ('resident_hbm', 1100, 3813, 0): (2, 4, 88008),
    ('resident_hbm', 2048, 2048, 0): (2, 4, 80128),
    ('large', 2100, 2100, 0): (2, 4, 82108),
    ('large', 2100, 11492, 0): (2, 4, 232380),
    ('large', 2100, 11493, 0): (1, 4, 215596),
    ('large', 2100, 12542, 0): (1, 4, 232380),
    ('large', 2100, 12543, 0): (1, 0, 221008),
    ('large', 2100, 13254, 0): (1, 0, 232384),
    ('large', 2100, 13255, 0): (0, 0, 0),
    ('large', 2100, 16000, 0): (0, 0, 0),
    ('large', 3000, 3000, 0): (2, 4, 115836),
    ('large', 3000, 10284, 0): (2, 4, 232380),
    ('large', 3000, 10285, 0): (1, 4, 208396),
    ('large', 3000, 11784, 0): (1, 4, 232380),
    ('large', 3000, 11785, 0): (1, 0, 216976),
    ('large', 3000, 12748, 0): (1, 0, 232384),
    ('large', 3000, 12749, 0): (0, 0, 0),
    ('large', 3000, 16000, 0): (0, 0, 0),
    ('large', 4096, 4096, 0): (2, 4, 156928),
    ('large', 4096, 8812, 0): (2, 4, 232384),
    ('large', 4096, 8813, 0): (1, 4, 199632),
    ('large', 4096, 10860, 0): (1, 4, 232384),
    ('large', 4096, 10861, 0): (1, 0, 212048),
    ('large', 4096, 12132, 0): (1, 0, 232384),
    ('large', 4096, 12133, 0): (0, 0, 0),
    ('large', 4096, 16000, 0): (0, 0, 0),
    ('banded', 1024, 1024, 128): (2, 1, 47496),
    ('banded', 2048, 2048, 256): (2, 1, 93576),
    ('banded', 5120, 5120, 256): (2, 1, 231828),
    ('banded', 5376, 5376, 256): (1, 1, 200341),
    ('banded', 6144, 6144, 256): (1, 1, 228760),
    ('banded', 6400, 6400, 256): (2, 0, 212633),
    ('banded', 6912, 6912, 256): (2, 0, 229531),
    ('banded', 7168, 7168, 256): (1, 0, 180636),
    ('banded', 9216, 9216, 256): (1, 0, 231844),
    ('banded', 9472, 9472, 256): (0, 0, 0),
    ('banded', 12288, 12288, 256): (0, 0, 0),
}


@pytest.mark.parametrize("key", list(LIBRARY_CONFIGS))
def test_cluster_plan_equals_the_library_table(key):
    """The size gates' copy of the shared-memory layout (cluster_plan) takes
    what the library takes at the gates' edges; the card holds it to the
    library at every size of the scan (chip_smoke.py phase 3)."""
    assert C.cluster_plan(*key) == LIBRARY_CONFIGS[key]

"""Linear assignment: batched epsilon-scaling auction, dense part
(reart_tpu/ops/assignment.py).

Sweep counts are bounded (`max_sweeps`); rows still unassigned at the bound
are completed greedily outside the kernel (they may duplicate a column).
With tracing on (profiling.py) every solve counts its route
(`lap.solves.resident`, `.hbm`, `.large`, `.sweeps`, `.banded`), the
sweeps its kernel reports (`lap.sweeps`, summed over elements and epsilon
phases on the device; the resident kernel reports none) and, on the dense
routes, the rows left unassigned at the bound before the completion
(`lap.rows_at_bound`; the banded kernel completes its rows itself).
Prices can be warm-started across solves (`price` in and out). `auction_lap`
picks its solver by size as the JAX package does: one launch up to 1024^2
(resident) and up to 2048^2 (streamed), sweep by sweep past that; on the
card a problem past 2048^2 whose state fits a block's shared memory is one
launch too (the large kernel), where the JAX package sweeps.

The banded part (`auction_lap_points`) solves a giant euclidean problem
straight from the point clouds: both clouds sorted along a space-filling
curve (Morton or Hilbert keys of a shared bounding box), each row tile
bidding inside a diagonal window of sorted columns (the banded kernel of
ops/cuda_auction), the matching mapped back to the original indices.
"""

from __future__ import annotations

import torch

from reart_tpu_torch import profiling
from reart_tpu_torch.ops.cuda_auction import (
    BAND_MAX_BYTES,
    _band_offsets,
    auction_solve_banded,
    auction_solve_large,
    auction_solve_resident,
    auction_solve_resident_hbm,
    band_tile,
    banded_available,
    col_winner_max,
    col_winner_max_plain,
    large_available,
    resident_available,
    resident_hbm_available,
    row_top2,
    row_top2_plain,
)


def _auction_phase(benefit: torch.Tensor, price: torch.Tensor, eps: float,
                   max_sweeps: int, plain: bool = False,
                   stats: torch.Tensor | None = None):
    """One epsilon phase of the Jacobi (all-rows-bid) auction with
    unseating. benefit (B, N, M), price (B, M) -> (row_to_col (B, N) int64,
    price (B, M)).

    The sweep's two matrix-shaped passes go through `row_top2` and
    `col_winner_max` (kernels on a CUDA tensor, which read the benefit matrix
    once per sweep); `plain` takes their plain versions on any device, which
    makes this loop the plain version of the one-launch kernels. The loop
    ends when every row is seated, read back once per sweep. `stats` (B, 2)
    int32, when given, gains per element the sweeps in which it still had an
    unseated row and the rows that bid."""
    top2, winner = ((row_top2_plain, col_winner_max_plain) if plain
                    else (row_top2, col_winner_max))
    b, n, m = benefit.shape
    dev = benefit.device
    row_ids = torch.arange(n, device=dev)[None, :]
    neg_inf = torch.tensor(float("-inf"), dtype=benefit.dtype, device=dev)
    row_to_col = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    sweep = 0
    while sweep < max_sweeps and bool((row_to_col < 0).any()):
        unassigned = row_to_col < 0
        if stats is not None:
            stats[:, 0] += unassigned.any(dim=1)
            stats[:, 1] += unassigned.sum(dim=1)
        best_v, second_v, best_j = top2(benefit, price)
        bid = best_v - second_v + eps
        bid = torch.where(unassigned, bid, neg_inf)  # only unassigned bid
        col_bid, col_winner = winner(bid, best_j, m)
        got_bid = col_bid > neg_inf

        price = torch.where(got_bid, price + col_bid, price)

        # unseat rows whose held column was re-bid by a different winner
        prev_col = row_to_col.clamp_min(0)
        held = row_to_col >= 0
        col_rebid = torch.gather(got_bid, 1, prev_col) & held
        winner_of_prev = torch.gather(col_winner, 1, prev_col)
        row_to_col = torch.where(col_rebid & (winner_of_prev != row_ids),
                                 -1, row_to_col)
        # seat the winning bidders
        won = torch.gather(col_winner, 1, best_j) == row_ids
        seat = unassigned & won & torch.gather(got_bid, 1, best_j)
        row_to_col = torch.where(seat, best_j, row_to_col)
        sweep += 1
    return row_to_col, price


def auction_lap(cost: torch.Tensor, eps_min: float = 1e-4,
                num_scales: int = 5, scale_factor: float = 8.0,
                max_sweeps: int = 500, price: torch.Tensor | None = None,
                return_price: bool = False, use_resident: bool | None = None):
    """Minimise the summed cost over a matching. cost (B, N, M), N <= M.

    Returns row_to_col (B, N) int64 (and the final prices if
    `return_price`). Epsilon phases run from eps_min * scale_factor **
    (num_scales - 1) down to eps_min; pass `price` to warm-start. A problem
    that fits the resident kernel (N*M <= 1024^2) or the streamed one (up to
    2048^2) is solved in one launch, and so is a larger one on the card
    whose state fits the large kernel (`large_available`); any other sweep
    by sweep through the two sweep kernels (`use_resident=False` sends any
    size that way, with no one-launch kernel at all; True asks for the
    resident kernel). Every route computes the same auction: the same
    row_to_col and prices."""
    if cost.dim() == 2:
        out = auction_lap(cost[None], eps_min, num_scales, scale_factor,
                          max_sweeps, None if price is None else price[None],
                          return_price, use_resident)
        return (out[0][0], out[1][0]) if return_price else out[0]
    benefit = (-cost.to(torch.float32)).contiguous()
    b, n, m = benefit.shape
    if price is None:
        price = torch.zeros((b, m), dtype=torch.float32, device=cost.device)
    price = price.to(torch.float32).contiguous()
    eps_list = tuple(float(eps_min * scale_factor ** k)
                     for k in range(num_scales - 1, -1, -1))
    route, solve = "sweeps", None
    if use_resident or (use_resident is None and resident_available(n, m)):
        route, solve = "resident", auction_solve_resident
    elif use_resident is None and resident_hbm_available(n, m):
        route, solve = "hbm", auction_solve_resident_hbm
    elif use_resident is None and large_available(n, m, benefit.device):
        route, solve = "large", auction_solve_large
    # the sweeps each kernel reports, asked for only when traced
    traced, stats = profiling.enabled(), None
    if solve is None:
        if traced:
            stats = torch.zeros((b, len(eps_list), 2), dtype=torch.int32,
                                device=benefit.device)
        for e, eps in enumerate(eps_list):
            kw = {} if stats is None else {"stats": stats[:, e]}
            row_to_col, price = _auction_phase(benefit, price, eps,
                                               max_sweeps, **kw)
    elif traced and route != "resident":
        row_to_col, price, stats = solve(benefit, price, eps_list,
                                         max_sweeps, return_stats=True)
    else:
        row_to_col, price = solve(benefit, price, eps_list, max_sweeps)
    if traced:
        profiling.count(f"lap.solves.{route}")
        if stats is not None:
            profiling.count("lap.sweeps", stats[..., 0])
        profiling.count("lap.rows_at_bound", row_to_col < 0)
    # greedy completion of any rows left by the sweep bound
    fallback = torch.argmax(benefit - price[:, None, :], dim=-1)
    row_to_col = torch.where(row_to_col < 0, fallback, row_to_col)
    return (row_to_col, price) if return_price else row_to_col


def assignment_cost(cost: torch.Tensor, row_to_col: torch.Tensor):
    """Total matched cost per batch element."""
    picked = torch.gather(cost, -1, row_to_col[..., None].long())
    return picked[..., 0].sum(dim=-1)


# ---------------------------------------------------------------------------
# banded points-level solver (giant problems: 2048^2, 4096^2)
# ---------------------------------------------------------------------------
# Curve keys are uint32 arithmetic in the JAX package; here int64 tensors
# whose values never leave 32 bits (the coordinates have 10 bits).

_U32 = 0xFFFFFFFF


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Interleave each 10-bit coordinate into every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _quantize(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              bits: int = 10) -> torch.Tensor:
    """Cell coordinates in [0, 2^bits) of float32 points in the box."""
    top = float(2 ** bits - 1)
    q = (pts - lo) / torch.clamp(hi - lo, min=1e-9) * top
    return q.clamp(0.0, top).to(torch.int64)


def _morton_keys(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """30-bit Morton codes of (B, N, 3) points, bbox (B, 1, 3) lo/hi."""
    q = _quantize(pts, lo, hi)
    return (_spread_bits(q[..., 0]) | (_spread_bits(q[..., 1]) << 1)
            | (_spread_bits(q[..., 2]) << 2))


def _hilbert_keys(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  bits: int = 10):
    """30-bit Hilbert indices of (B, N, 3) points: consecutive curve
    positions are face-adjacent cells, so the sorted order keeps locality
    better than Morton's."""
    return _hilbert_index(_quantize(pts, lo, hi, bits), bits)


def _hilbert_index(q: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Hilbert index of cell coordinates q (..., 3) in [0, 2^bits)
    (Skilling's axes-to-transpose, its branches as selects)."""
    x = [q[..., 0], q[..., 1], q[..., 2]]
    big = 1 << (bits - 1)
    qb = big
    while qb > 1:  # inverse undo, bit planes high to low
        p = qb - 1
        for i in range(3):
            hit = (x[i] & qb) != 0
            swap = (x[0] ^ x[i]) & p
            x0_new = torch.where(hit, x[0] ^ p, x[0] ^ swap)
            if i > 0:
                x[i] = torch.where(hit, x[i], x[i] ^ swap)
            x[0] = x0_new
        qb >>= 1
    x[1] = x[1] ^ x[0]  # Gray encode
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[2])
    qb = big
    while qb > 1:
        t = torch.where((x[2] & qb) != 0, t ^ (qb - 1), t)
        qb >>= 1
    x = [(xi ^ t) & _U32 for xi in x]
    # transpose: bit q of x[0] is the top bit of the q-th 3-bit group
    return (_spread_bits(x[2]) | (_spread_bits(x[1]) << 1)
            | (_spread_bits(x[0]) << 2))


def resolve_band(band: int, n: int) -> int:
    """-1 = auto: the window scales with the problem, n // 4 clamped to
    [512, 1024] (multiples of 128), stepped down while the (n, w) band of one
    element would pass 16 MB (the banded solve's gate)."""
    if band != -1:
        return band
    w = min(1024, max(512, n // 4))
    while w > 512 and n * w * 4 > BAND_MAX_BYTES:
        w //= 2
    return w


def banded_points_available(n: int, m: int, band: int, device=None) -> bool:
    """Whether an (N, M) LAP on `device` takes the banded solve: a window
    other than 0 and the kernel's gates, which need a CUDA device (on the
    CPU every size goes dense, as in the JAX package off the TPU)."""
    return band > 0 and banded_available(n, m, band, device=device)


def _curve_sort(pc_src: torch.Tensor, pc_tgt: torch.Tensor, band: int,
                curve: str | None):
    """Space-filling-curve sort shared by the banded solve and its guard:
    (src_sorted, tgt_sorted, rperm, cperm), one bbox per element. `curve`
    None takes Hilbert for windows of 1024 and wider, Morton below."""
    both = torch.cat([pc_src, pc_tgt], dim=1)
    lo = both.amin(dim=1, keepdim=True)
    hi = both.amax(dim=1, keepdim=True)
    if curve is None:
        curve = "hilbert" if band >= 1024 else "morton"
    keys = {"hilbert": _hilbert_keys, "morton": _morton_keys}[curve]
    rperm = torch.sort(keys(pc_src, lo, hi), dim=1, stable=True)[1]
    cperm = torch.sort(keys(pc_tgt, lo, hi), dim=1, stable=True)[1]
    src_s = torch.gather(pc_src, 1, rperm[..., None].expand(-1, -1, 3))
    tgt_s = torch.gather(pc_tgt, 1, cperm[..., None].expand(-1, -1, 3))
    return src_s, tgt_s, rperm, cperm


def _nn_col(src_s: torch.Tensor, tgt_s: torch.Tensor) -> torch.Tensor:
    """Sorted column of each sorted row's nearest target point."""
    from reart_tpu_torch.ops.cuda_nn import nn_topk

    return nn_topk(src_s, tgt_s, 1)[1][..., 0]


def band_overflow_fraction(pc_src: torch.Tensor, pc_tgt: torch.Tensor,
                           band: int = 512, curve: str | None = None):
    """Fraction of rows whose nearest target point falls outside their
    banded column window: whether the banded solve can represent the
    geometric matching at all (near 0 on aligned clouds, large on clouds
    whose curve orders disagree). One 1-NN pass, no cost matrix. Returns a
    0-d float32 tensor."""
    n, m = pc_src.shape[1], pc_tgt.shape[1]
    src_s, tgt_s, _, _ = _curve_sort(pc_src, pc_tgt, band, curve)
    nn_col = _nn_col(src_s, tgt_s)
    tile = band_tile(n)
    offs = torch.tensor(_band_offsets(n, m, band, tile), device=pc_src.device)
    off = offs[torch.arange(n, device=pc_src.device) // tile][None]
    inside = (nn_col >= off) & (nn_col < off + band)
    return 1.0 - inside.to(torch.float32).mean()


def auction_lap_points(pc_src: torch.Tensor, pc_tgt: torch.Tensor,
                       band: int = 512, eps_min: float = 1e-4,
                       num_scales: int = 2, scale_factor: float = 50.0,
                       max_sweeps: int = 100,
                       price: torch.Tensor | None = None,
                       return_price: bool = False, nn_recenter: bool = False,
                       curve: str | None = None):
    """Approximate euclidean-cost LAP straight from point clouds: pc_src
    (B, N, 3), pc_tgt (B, M, 3), N == M. Both clouds are sorted along a
    space-filling curve, the banded solve runs on diagonal windows of `band`
    sorted columns, and the matching comes back in the original indices
    (int64 (B, N); every row assigned, columns may repeat at the sweep
    bound). `price` warm-starts in the original column order, and with
    `return_price` the final prices come back in that order too.

    `nn_recenter` sorts the rows by the sorted column of their nearest
    target point instead (stable, curve order among equals), which puts a
    row's likely match on the diagonal where the two curve orders disagree
    on near-aligned clouds."""
    b, n, _ = pc_src.shape
    m = pc_tgt.shape[1]
    pc_src = pc_src.to(torch.float32)
    pc_tgt = pc_tgt.to(torch.float32)
    src_s, tgt_s, rperm, cperm = _curve_sort(pc_src, pc_tgt, band, curve)
    if nn_recenter:
        reorder = torch.sort(_nn_col(src_s, tgt_s), dim=1, stable=True)[1]
        rperm = torch.gather(rperm, 1, reorder)
        src_s = torch.gather(src_s, 1, reorder[..., None].expand(-1, -1, 3))
    if price is None:
        price_s = torch.zeros((b, m), dtype=torch.float32, device=pc_src.device)
    else:
        price_s = torch.gather(price.to(torch.float32), 1, cperm)
    eps_list = tuple(float(eps_min * scale_factor ** k)
                     for k in range(num_scales - 1, -1, -1))
    if profiling.enabled():
        r2c_s, price_s, stats = auction_solve_banded(
            src_s, tgt_s, price_s, eps_list, max_sweeps, band,
            return_stats=True)
        profiling.count("lap.solves.banded")
        profiling.count("lap.sweeps", stats[..., 0])
    else:
        r2c_s, price_s = auction_solve_banded(src_s, tgt_s, price_s,
                                              eps_list, max_sweeps, band)
    # sorted row i is original row rperm[i]; its column r2c_s[i] is
    # original column cperm[r2c_s[i]]
    col_orig = torch.gather(cperm, 1, r2c_s)
    row_to_col = torch.empty_like(col_orig).scatter_(1, rperm, col_orig)
    if return_price:
        return row_to_col, torch.empty_like(price_s).scatter_(1, cperm,
                                                              price_s)
    return row_to_col

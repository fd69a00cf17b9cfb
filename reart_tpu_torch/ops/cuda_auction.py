"""Auction kernels (csrc/auction.cu, csrc/auction_hbm.cu,
csrc/auction_sweep.cu, csrc/auction_banded.cu) with their plain PyTorch
versions; counterpart of reart_tpu/ops/pallas_auction.py.

  * `auction_solve_resident`: the whole epsilon-scaled solve in one launch,
    for N*M <= 1024^2 (Pallas `auction_solve_resident`);
  * `auction_solve_resident_hbm`: the same solve in one launch for
    1024^2 < N*M <= 2048^2, the benefit streamed from device memory by a
    cluster of blocks per element (Pallas `auction_solve_resident_hbm`);
  * `row_top2`, `col_winner_max`: the two matrix-shaped passes of one sweep
    of a still larger problem (Pallas `row_top2_pallas`,
    `col_winner_max_pallas`), driven by ops/assignment._auction_phase;
  * `auction_solve_banded`: the banded solve of a giant problem from
    curve-sorted points, each row tile bidding inside a window of w sorted
    columns (Pallas `auction_solve_banded`), driven by
    ops/assignment.auction_lap_points. The TPU kernel's `group` (batch
    elements packed into one VMEM instance) does not change results and is
    not carried over; the target cloud is taken row-major (B, M, 3).

Each wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor (or raises); `<wrapper>.launches` counts kernel launches.
The one-launch kernels keep the TPU kernels' column-owner state, their plain
versions the row-map sweep of ops/assignment._auction_phase; the two are the
same auction and return the same row_to_col and prices.
"""

from __future__ import annotations

import ctypes

import torch

from reart_tpu_torch.ops import _build

# the windows of the JAX package's dispatch: the resident kernel up to
# 1024^2 (there the benefit tile that fits VMEM; here what the L2 holds for
# a batch of 9), the streamed kernel up to 2048^2, the sweeps or the banded
# solve past that
RESIDENT_MAX_ELEMS = 1024 * 1024
RESIDENT_HBM_MAX_ELEMS = 2048 * 2048
MAX_EPS = 8
# shared memory a block can use (227 KB) less the kernels' static part
_MAX_SMEM = 232448 - 1024


def auction_solve_resident_plain(benefit: torch.Tensor, price: torch.Tensor,
                                 eps_list, max_sweeps: int,
                                 return_stats: bool = False):
    """benefit (B, N, M), price (B, M) -> (row_to_col (B, N) int64, -1 for
    rows unassigned at the sweep bound; final prices (B, M)); with
    `return_stats` also stats (B, len(eps_list), 2) int32: per element and
    phase the sweeps run and the rows that bid."""
    from reart_tpu_torch.ops.assignment import _auction_phase

    stats = torch.zeros((benefit.shape[0], len(eps_list), 2),
                        dtype=torch.int32, device=benefit.device)
    for e, eps in enumerate(eps_list):
        row_to_col, price = _auction_phase(
            benefit, price, eps, max_sweeps, plain=True,
            stats=stats[:, e] if return_stats else None)
    return (row_to_col, price, stats) if return_stats else (row_to_col, price)


# one plain version serves both one-launch kernels: they differ in where the
# benefit sits, not in what they compute
auction_solve_resident_hbm_plain = auction_solve_resident_plain


def _check_solve_args(name: str, benefit, price, eps_list):
    if (benefit.dim() != 3
            or price.shape != (benefit.shape[0], benefit.shape[2])):
        raise ValueError(f"{name}: expected benefit (B, N, M) and price "
                         f"(B, M), got {tuple(benefit.shape)} and "
                         f"{tuple(price.shape)}")
    b, n, m = benefit.shape
    if not 0 < n <= m or b < 1:
        raise ValueError(f"{name}: needs B >= 1 and 0 < N <= M, got B={b}, "
                         f"N={n}, M={m}")
    eps_list = tuple(float(e) for e in eps_list)
    if not 0 < len(eps_list) <= MAX_EPS:
        raise ValueError(f"{name}: 1 to {MAX_EPS} epsilon phases, got "
                         f"{len(eps_list)}")
    return eps_list


def auction_solve_resident(benefit: torch.Tensor, price: torch.Tensor,
                           eps_list, max_sweeps: int):
    """Full epsilon-scaled auction; see auction_solve_resident_plain.
    eps_list runs from the largest epsilon to the smallest."""
    name = "auction_solve_resident"
    eps_list = _check_solve_args(name, benefit, price, eps_list)
    b, n, m = benefit.shape
    if _build.is_cpu(name, benefit):
        return auction_solve_resident_plain(benefit, price, eps_list,
                                            max_sweeps)
    _build.require_cuda(name, benefit, price, dtype=torch.float32)
    if not resident_available(n, m):
        raise ValueError(
            f"{name}: a {n}x{m} LAP is past the resident window (N*M <= "
            f"1024^2); ops.assignment.auction_lap picks the kernel by size")
    r2c = torch.empty((b, n), dtype=torch.int64, device=benefit.device)
    price_out = torch.empty((b, m), dtype=torch.float32,
                            device=benefit.device)
    eps_arr = (ctypes.c_float * len(eps_list))(*eps_list)
    lib = _build.load_library()
    with torch.cuda.device(benefit.device):
        err = lib.reart_auction_resident(
            benefit.data_ptr(), price.data_ptr(), b, n, m,
            ctypes.cast(eps_arr, ctypes.c_void_p),
            len(eps_list), int(max_sweeps), r2c.data_ptr(),
            price_out.data_ptr(), _build.stream_of(benefit))
    _build.check_launch(name, err)
    auction_solve_resident.launches += 1
    return r2c, price_out


auction_solve_resident.launches = 0


def resident_available(n: int, m: int) -> bool:
    """Whether an (N, M) problem fits the resident kernel (shared memory: 16
    bytes per column plus one per row)."""
    return n * m <= RESIDENT_MAX_ELEMS and 16 * m + n <= _MAX_SMEM


def auction_solve_resident_hbm(benefit: torch.Tensor, price: torch.Tensor,
                               eps_list, max_sweeps: int,
                               return_stats: bool = False):
    """Full epsilon-scaled auction of a problem in the streamed window,
    1024^2 < N*M <= 2048^2; see auction_solve_resident_plain. One launch, no
    host synchronisation between sweeps."""
    name = "auction_solve_resident_hbm"
    eps_list = _check_solve_args(name, benefit, price, eps_list)
    b, n, m = benefit.shape
    if _build.is_cpu(name, benefit):
        return auction_solve_resident_hbm_plain(benefit, price, eps_list,
                                                max_sweeps, return_stats)
    _build.require_cuda(name, benefit, price, dtype=torch.float32)
    if not resident_hbm_available(n, m):
        raise ValueError(
            f"{name}: a {n}x{m} LAP is outside the streamed window (1024^2 < "
            f"N*M <= 2048^2, M <= {_MAX_SMEM // 4}); "
            f"ops.assignment.auction_lap picks the kernel by size")
    dev = benefit.device
    r2c = torch.empty((b, n), dtype=torch.int64, device=dev)
    price_out = torch.empty((b, m), dtype=torch.float32, device=dev)
    stats = torch.zeros((b, len(eps_list), 2), dtype=torch.int32, device=dev)
    # scratch the kernel initialises itself: bid keys (B, M) uint64, then
    # owner map (B, M), assigned flags (B, N) and owned counts (B,) int32
    scratch = torch.empty(b * (3 * m + n + 1), dtype=torch.int32, device=dev)
    key = scratch.data_ptr()
    c2r = key + 8 * b * m
    assigned = c2r + 4 * b * m
    owned = assigned + 4 * b * n
    eps_arr = (ctypes.c_float * len(eps_list))(*eps_list)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.reart_auction_resident_hbm(
            benefit.data_ptr(), price.data_ptr(), b, n, m,
            ctypes.cast(eps_arr, ctypes.c_void_p), len(eps_list),
            int(max_sweeps), r2c.data_ptr(), price_out.data_ptr(), key, c2r,
            assigned, owned, stats.data_ptr(), _build.stream_of(benefit))
    _build.check_launch(name, err)
    auction_solve_resident_hbm.launches += 1
    return (r2c, price_out, stats) if return_stats else (r2c, price_out)


auction_solve_resident_hbm.launches = 0


def resident_hbm_available(n: int, m: int) -> bool:
    """Whether an (N, M) problem is in the streamed kernel's window: past
    the resident kernel's, up to 2048^2, N <= M, and a block's shared memory
    holding one copy of the prices (4 bytes per column). No alignment is
    needed; the kernel loads 16 bytes at a time when M % 4 == 0."""
    return (0 < n <= m
            and RESIDENT_MAX_ELEMS < n * m <= RESIDENT_HBM_MAX_ELEMS
            and 4 * m <= _MAX_SMEM)


# ---------------------------------------------------------------------------
# the sweep kernels
# ---------------------------------------------------------------------------

def row_top2_plain(benefit: torch.Tensor, price: torch.Tensor):
    """benefit (B, N, M), price (B, M) -> (best_v (B, N), second_v (B, N),
    best_j (B, N) int64) of benefit - price: the largest value, the largest
    over the other columns (-inf when M == 1), and the best column, the
    lowest among equals."""
    values = benefit - price[:, None, :]
    best_j = torch.argmax(values, dim=-1)                     # first max
    best_v = torch.gather(values, -1, best_j[..., None])[..., 0]
    values.scatter_(-1, best_j[..., None], float("-inf"))
    return best_v, values.amax(dim=-1), best_j


def row_top2(benefit: torch.Tensor, price: torch.Tensor):
    """Per-row top-2 of benefit - price; see row_top2_plain."""
    name = "row_top2"
    if (benefit.dim() != 3 or 0 in benefit.shape
            or price.shape != (benefit.shape[0], benefit.shape[2])):
        raise ValueError(f"{name}: expected benefit (B, N, M) and price "
                         f"(B, M), got {tuple(benefit.shape)} and "
                         f"{tuple(price.shape)}")
    if _build.is_cpu(name, benefit):
        return row_top2_plain(benefit, price)
    _build.require_cuda(name, benefit, price, dtype=torch.float32)
    b, n, m = benefit.shape
    best_v = torch.empty((b, n), dtype=torch.float32, device=benefit.device)
    second_v = torch.empty_like(best_v)
    best_j = torch.empty((b, n), dtype=torch.int64, device=benefit.device)
    lib = _build.load_library()
    with torch.cuda.device(benefit.device):
        err = lib.reart_row_top2(benefit.data_ptr(), price.data_ptr(), b, n,
                                 m, best_v.data_ptr(), second_v.data_ptr(),
                                 best_j.data_ptr(), _build.stream_of(benefit))
    _build.check_launch(name, err)
    row_top2.launches += 1
    return best_v, second_v, best_j


row_top2.launches = 0


def col_winner_max_plain(bid: torch.Tensor, best_j: torch.Tensor, m: int):
    """bid (B, N) (-inf for rows that do not bid), best_j (B, N) int64 ->
    (col_bid (B, M), -inf where no row bid; col_winner (B, M) int64, the
    lowest row among the largest bids, 0 where no row bid). As masked
    reductions over (B, N, M)."""
    neg_inf = torch.tensor(float("-inf"), dtype=bid.dtype, device=bid.device)
    col_ids = torch.arange(m, device=bid.device)[None, None, :]
    bid_matrix = torch.where(best_j[..., None] == col_ids, bid[..., None],
                             neg_inf)
    col_bid = bid_matrix.amax(dim=1)
    is_win = (bid_matrix == col_bid[:, None, :]) & (bid_matrix > neg_inf)
    return col_bid, torch.argmax(is_win.to(torch.int32), dim=1)


def col_winner_max(bid: torch.Tensor, best_j: torch.Tensor, m: int):
    """Per-column largest bid and its row; see col_winner_max_plain."""
    name = "col_winner_max"
    if bid.dim() != 2 or best_j.shape != bid.shape or 0 in bid.shape or m < 1:
        raise ValueError(f"{name}: expected bid (B, N), best_j (B, N) and "
                         f"M >= 1, got {tuple(bid.shape)}, "
                         f"{tuple(best_j.shape)} and {m}")
    if _build.is_cpu(name, bid):
        return col_winner_max_plain(bid, best_j, m)
    _build.require_cuda(name, bid, dtype=torch.float32)
    _build.require_cuda(name, best_j, dtype=torch.int64)
    b, n = bid.shape
    if b > 65535:
        raise ValueError(f"{name}: batch {b} > 65535")
    col_bid = torch.empty((b, m), dtype=torch.float32, device=bid.device)
    col_winner = torch.empty((b, m), dtype=torch.int64, device=bid.device)
    lib = _build.load_library()
    with torch.cuda.device(bid.device):
        err = lib.reart_col_winner_max(bid.data_ptr(), best_j.data_ptr(), b,
                                       n, m, col_bid.data_ptr(),
                                       col_winner.data_ptr(),
                                       _build.stream_of(bid))
    _build.check_launch(name, err)
    col_winner_max.launches += 1
    return col_bid, col_winner


col_winner_max.launches = 0


# ---------------------------------------------------------------------------
# the banded solve
# ---------------------------------------------------------------------------

BAND_TILE = 256
# largest (N, w) band of one element the JAX package's dispatch admits (its
# VMEM budget there; here a dispatch rule, so that the same problems take
# the same solver)
BAND_MAX_BYTES = 16 * 1024 * 1024


def band_tile(n: int) -> int:
    """Row-tile size: at least 8 tiles, so the diagonal windows cover every
    column."""
    return max(8, min(BAND_TILE, n // 8))


def _band_offsets(n: int, m: int, w: int, tile: int) -> list[int]:
    """First sorted column of each row tile's window: diagonal-centred,
    clamped into [0, m - w]."""
    return [min(max(t * tile + tile // 2 - w // 2, 0), m - w)
            for t in range(n // tile)]


def banded_available(n: int, m: int, w: int, tile: int | None = None,
                     device=None) -> bool:
    """Whether an (N, M) problem with window w takes the banded solve: the
    JAX package's gates (square, 128-aligned window narrower than M, whole
    row tiles, past the resident window of 1024^2, a band of at most 16 MB
    an element) and a CUDA device."""
    if tile is None:
        tile = band_tile(n)
    if n != m or w >= m or w % 128 != 0:
        return False
    if n % tile != 0 or n * m <= RESIDENT_MAX_ELEMS:
        return False
    if n * w * 4 > BAND_MAX_BYTES:
        return False
    return device is not None and torch.device(device).type == "cuda"


def _check_banded_args(name, src, tgt, price, eps_list, w, tile):
    if (src.dim() != 3 or tgt.dim() != 3 or src.shape[2] != 3
            or tgt.shape[2] != 3 or src.shape[0] != tgt.shape[0]
            or price.shape != tgt.shape[:2]):
        raise ValueError(f"{name}: expected src (B, N, 3), tgt (B, M, 3) and "
                         f"price (B, M), got {tuple(src.shape)}, "
                         f"{tuple(tgt.shape)} and {tuple(price.shape)}")
    b, n, _ = src.shape
    m = tgt.shape[1]
    if tile is None:
        tile = band_tile(n)
    if b < 1 or n < 1 or not 1 <= w <= m or tile < 1 or n % tile:
        raise ValueError(f"{name}: needs B, N >= 1, 1 <= w <= M and tile "
                         f"dividing N, got B={b}, N={n}, M={m}, w={w}, "
                         f"tile={tile}")
    eps_list = tuple(float(e) for e in eps_list)
    if not 0 < len(eps_list) <= MAX_EPS:
        raise ValueError(f"{name}: 1 to {MAX_EPS} epsilon phases, got "
                         f"{len(eps_list)}")
    return eps_list, tile


def _bid_keys(bid: torch.Tensor) -> torch.Tensor:
    """(B, N) float32 bids -> int64 keys ordered as (bid, then the lower
    row): the order-preserving signed bits of the bid times 2^32 plus
    2^32 - 1 - row, as the kernels' 64-bit atomicMax keys order them."""
    bits = bid.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rows = torch.arange(bid.shape[1], device=bid.device, dtype=torch.int64)
    return bits * (1 << 32) + ((1 << 32) - 1 - rows)


def auction_solve_banded_plain(src: torch.Tensor, tgt: torch.Tensor,
                               price: torch.Tensor, eps_list,
                               max_sweeps: int, w: int,
                               tile: int | None = None, carry: bool = False,
                               return_stats: bool = False):
    """src (B, N, 3), tgt (B, M, 3) float32, both sorted along a
    space-filling curve, price (B, M) in sorted column order -> (row_to_col
    (B, N) int64 in sorted column indices, every row assigned: a row left at
    the sweep bound takes its best in-band column; final prices (B, M));
    with `return_stats` also stats (B, len(eps_list), 3) int32: per element
    and phase the sweeps run, the rows that bid and the row tiles that bid.

    Row tile t (`tile` rows) bids inside the w sorted columns from
    `_band_offsets`; the benefit is minus the points' distance. The band
    (B, N / tile, tile, w) is built once; a sweep takes each bidding row's
    best and second value of its window, the column maximum with the lowest
    row through a scatter of packed keys, then the prices and the owner
    maps. `carry` keeps a phase's owners into the next, unseating the rows
    that break eps-complementary slackness at the new epsilon."""
    eps_list, tile = _check_banded_args("auction_solve_banded_plain", src,
                                        tgt, price, eps_list, w, tile)
    b, n, _ = src.shape
    m = tgt.shape[1]
    dev = src.device
    nt = n // tile
    offs = torch.tensor(_band_offsets(n, m, w, tile), device=dev)
    cols = offs[:, None] + torch.arange(w, device=dev)          # (T, w)
    s = src.to(torch.float32).reshape(b, nt, tile, 1, 3)
    t = tgt.to(torch.float32)[:, cols][:, :, None]               # (B,T,1,w,3)
    acc = None
    for c in range(3):
        d = s[..., c] - t[..., c]
        acc = d * d if acc is None else acc + d * d
    # the root of a float32 taken in float64 and rounded to float32 is the
    # correctly rounded float32 root, the kernel's __fsqrt_rn, on any
    # device (PyTorch's vectorised float32 sqrt on the CPU is not always)
    band = -torch.sqrt(acc.double()).float()                     # (B,T,tile,w)
    del acc, d
    price = price.to(torch.float32).clone()
    off_rows = offs.repeat_interleave(tile)[None]                # (1, N)
    none = torch.iinfo(torch.int64).min
    r2c = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    c2r = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros((b, len(eps_list), 3), dtype=torch.int32, device=dev)

    def values():
        return band - price[:, cols][:, :, None, :]

    def top2(v):
        a1 = torch.argmax(v, dim=-1, keepdim=True)               # first max
        m1 = torch.gather(v, -1, a1)
        m2 = v.scatter(-1, a1, float("-inf")).amax(dim=-1, keepdim=True)
        return m1.reshape(b, n), m2.reshape(b, n), a1.reshape(b, n) + off_rows

    for e, eps in enumerate(eps_list):
        if not carry or e == 0:
            r2c.fill_(-1)
            c2r.fill_(-1)
        else:
            v = values()
            m1 = v.amax(dim=-1).reshape(b, n)
            loc = (r2c - off_rows).clamp(0, w - 1).reshape(b, nt, tile, 1)
            cur = torch.gather(v, -1, loc).reshape(b, n)
            viol = (r2c >= 0) & (cur < m1 - eps)
            freed = torch.full((b, m + 1), 0, dtype=torch.bool, device=dev)
            freed.scatter_(1, torch.where(viol, r2c, m), True)
            c2r = torch.where(freed[:, :m], -1, c2r)
            r2c = torch.where(viol, -1, r2c)
        for _ in range(max_sweeps):
            un = r2c < 0
            active = un.any(dim=1)
            if not bool(active.any()):
                break
            stats[:, e, 0] += active.to(torch.int32)
            stats[:, e, 1] += un.sum(dim=1, dtype=torch.int32)
            stats[:, e, 2] += un.reshape(b, nt, tile).any(dim=-1).sum(
                dim=1, dtype=torch.int32)
            m1, m2, col = top2(values())
            bid = (m1 - m2) + eps
            key = torch.where(un, _bid_keys(bid), none)
            col_key = torch.full((b, m), none, dtype=torch.int64, device=dev)
            col_key.scatter_reduce_(1, col, key, "amax")
            got = col_key != none
            winner = torch.where(got, (1 << 32) - 1 - (col_key & 0xFFFFFFFF),
                                 0)
            price = torch.where(got, price + torch.gather(bid, 1, winner),
                                price)
            # free the old owners of re-bid columns, seat the winners
            old = torch.where(got & (c2r >= 0), c2r, n)
            r2c = torch.cat([r2c, r2c[:, :1]], 1).scatter(1, old, -1)[:, :n]
            seat = torch.where(got, winner, n)
            cids = torch.arange(m, device=dev).expand(b, m)
            r2c = torch.cat([r2c, r2c[:, :1]], 1).scatter(1, seat, cids)[:, :n]
            c2r = torch.where(got, winner, c2r)
    fallback = top2(values())[2]
    row_to_col = torch.where(r2c >= 0, r2c, fallback)
    return (row_to_col, price, stats) if return_stats else (row_to_col, price)


def auction_solve_banded(src: torch.Tensor, tgt: torch.Tensor,
                         price: torch.Tensor, eps_list, max_sweeps: int,
                         w: int, tile: int | None = None, carry: bool = False,
                         return_stats: bool = False):
    """Banded epsilon-scaled auction from curve-sorted points; see
    auction_solve_banded_plain. One launch, no host synchronisation between
    sweeps. Inputs that are views are copied first."""
    name = "auction_solve_banded"
    eps_list, tile = _check_banded_args(name, src, tgt, price, eps_list, w,
                                        tile)
    if _build.is_cpu(name, src):
        return auction_solve_banded_plain(src, tgt, price, eps_list,
                                          max_sweeps, w, tile, carry,
                                          return_stats)
    src, tgt, price = (x.contiguous() for x in (src, tgt, price))
    _build.require_cuda(name, src, tgt, price, dtype=torch.float32)
    b, n, _ = src.shape
    m = tgt.shape[1]
    if 4 * m > _MAX_SMEM:
        raise ValueError(f"{name}: M={m} is past a block's shared memory "
                         f"for the prices (M <= {_MAX_SMEM // 4})")
    dev = src.device
    r2c_out = torch.empty((b, n), dtype=torch.int64, device=dev)
    price_out = torch.empty((b, m), dtype=torch.float32, device=dev)
    stats = torch.zeros((b, len(eps_list), 3), dtype=torch.int32, device=dev)
    nt = n // tile
    # scratch the kernel initialises itself: bid keys (B, M) uint64, then
    # owner map (B, M), row map (B, N), tile flags (B, N / tile) and owned
    # counts (B,) int32
    scratch = torch.empty(b * (3 * m + n + nt + 1), dtype=torch.int32,
                          device=dev)
    key = scratch.data_ptr()
    c2r = key + 8 * b * m
    r2c = c2r + 4 * b * m
    flags = r2c + 4 * b * n
    owned = flags + 4 * b * nt
    eps_arr = (ctypes.c_float * len(eps_list))(*eps_list)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.reart_auction_banded(
            src.data_ptr(), tgt.data_ptr(), price.data_ptr(), b, n, m, int(w),
            int(tile), ctypes.cast(eps_arr, ctypes.c_void_p), len(eps_list),
            int(max_sweeps), int(bool(carry)), r2c_out.data_ptr(),
            price_out.data_ptr(), key, c2r, r2c, flags, owned,
            stats.data_ptr(), _build.stream_of(src))
    _build.check_launch(name, err)
    auction_solve_banded.launches += 1
    if return_stats:
        return r2c_out, price_out, stats
    return r2c_out, price_out


auction_solve_banded.launches = 0

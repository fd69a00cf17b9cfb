"""Auction kernels (csrc/auction.cu, csrc/auction_hbm.cu,
csrc/auction_sweep.cu) with their plain PyTorch versions; counterpart of
reart_tpu/ops/pallas_auction.py.

  * `auction_solve_resident`: the whole epsilon-scaled solve in one launch,
    for N*M <= 1024^2 (Pallas `auction_solve_resident`);
  * `auction_solve_resident_hbm`: the same solve in one launch for
    1024^2 < N*M <= 2048^2, the benefit streamed from device memory by a
    cluster of blocks per element (Pallas `auction_solve_resident_hbm`);
  * `row_top2`, `col_winner_max`: the two matrix-shaped passes of one sweep
    of a still larger problem (Pallas `row_top2_pallas`,
    `col_winner_max_pallas`), driven by ops/assignment._auction_phase.

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

"""Auction kernels (csrc/auction.cu, csrc/auction_sweep.cu) with their plain
PyTorch versions; counterpart of reart_tpu/ops/pallas_auction.py.

  * `auction_solve_resident`: the whole epsilon-scaled solve in one launch,
    for N*M <= 1024^2 (Pallas `auction_solve_resident`);
  * `row_top2`, `col_winner_max`: the two matrix-shaped passes of one sweep
    of a larger problem (Pallas `row_top2_pallas`, `col_winner_max_pallas`),
    driven by ops/assignment._auction_phase.

Each wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor (or raises); `<wrapper>.launches` counts kernel launches.
The resident kernel keeps the TPU kernel's column-owner state, its plain
version the row-map sweep of ops/assignment._auction_phase; the two are the
same auction and return the same row_to_col and prices.
"""

from __future__ import annotations

import ctypes

import torch

from reart_tpu_torch.ops import _build

# the TPU kernel's VMEM window (benefit tile N*M <= 4 MB float32): larger
# problems took the HBM-streaming or the banded solve there, ported later
RESIDENT_MAX_ELEMS = 1024 * 1024
MAX_EPS = 8
# shared memory: 16 bytes per column plus one per row within 227 KB
_MAX_SMEM = 232448 - 1024


def auction_solve_resident_plain(benefit: torch.Tensor, price: torch.Tensor,
                                 eps_list, max_sweeps: int):
    """benefit (B, N, M), price (B, M) -> (row_to_col (B, N) int64, -1 for
    rows unassigned at the sweep bound; final prices (B, M))."""
    from reart_tpu_torch.ops.assignment import _auction_phase

    for eps in eps_list:
        row_to_col, price = _auction_phase(benefit, price, eps, max_sweeps,
                                           plain=True)
    return row_to_col, price


def auction_solve_resident(benefit: torch.Tensor, price: torch.Tensor,
                           eps_list, max_sweeps: int):
    """Full epsilon-scaled auction; see auction_solve_resident_plain.
    eps_list runs from the largest epsilon to the smallest."""
    name = "auction_solve_resident"
    if (benefit.dim() != 3
            or price.shape != (benefit.shape[0], benefit.shape[2])):
        raise ValueError(f"{name}: expected benefit (B, N, M) and price "
                         f"(B, M), got {tuple(benefit.shape)} and "
                         f"{tuple(price.shape)}")
    b, n, m = benefit.shape
    if not 0 < n <= m:
        raise ValueError(f"{name}: needs 0 < N <= M, got N={n}, M={m}")
    eps_list = tuple(float(e) for e in eps_list)
    if not 0 < len(eps_list) <= MAX_EPS:
        raise ValueError(f"{name}: 1 to {MAX_EPS} epsilon phases, got "
                         f"{len(eps_list)}")
    if _build.is_cpu(name, benefit):
        return auction_solve_resident_plain(benefit, price, eps_list,
                                            max_sweeps)
    _build.require_cuda(name, benefit, price, dtype=torch.float32)
    if not resident_available(n, m):
        raise ValueError(
            f"{name}: a {n}x{m} LAP is past the resident window (N*M <= "
            f"1024^2); ops.assignment.auction_lap solves it sweep by sweep")
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
    """Whether an (N, M) problem fits the resident kernel."""
    return n * m <= RESIDENT_MAX_ELEMS and 16 * m + n <= _MAX_SMEM


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

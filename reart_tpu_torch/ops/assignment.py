"""Linear assignment: batched epsilon-scaling auction, dense part
(reart_tpu/ops/assignment.py).

Sweep counts are bounded (`max_sweeps`); rows still unassigned at the bound
are completed greedily outside the kernel (they may duplicate a column).
Prices can be warm-started across solves (`price` in and out). `auction_lap`
picks its solver by size as the JAX package does: one launch up to 1024^2
(resident) and up to 2048^2 (streamed), sweep by sweep past that. The
banded points-level solve for giant problems is not ported yet;
`require_dense` is where a fit that asks for it is turned away.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.cuda_auction import (
    RESIDENT_MAX_ELEMS,
    auction_solve_resident,
    auction_solve_resident_hbm,
    col_winner_max,
    col_winner_max_plain,
    resident_available,
    resident_hbm_available,
    row_top2,
    row_top2_plain,
)


def require_dense(cost_like: torch.Tensor, n: int, m: int, band: int) -> None:
    """Turn away a LAP that the JAX package would hand to its banded
    points-level solve: past 1024^2, on the accelerator, with
    `assign_band != 0` (-1 scales the band with the problem). On the CPU
    every size goes dense, as in the JAX package off the TPU."""
    if (cost_like.device.type == "cuda" and n * m > RESIDENT_MAX_ELEMS
            and band != 0):
        raise NotImplementedError(
            f"a {n}x{m} LAP with assign_band={band} takes the banded "
            f"points-level solve (curve sort, guard, re-probe), which is "
            f"ported in slice 4; pass assign_band=0 (--assign_band 0) for "
            f"the dense solve")


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
    2048^2) is solved in one launch; a larger one sweep by sweep through the
    two sweep kernels (`use_resident=False` sends any size that way, with no
    one-launch kernel at all; True asks for the resident kernel)."""
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
    solve = None
    if use_resident or (use_resident is None and resident_available(n, m)):
        solve = auction_solve_resident
    elif use_resident is None and resident_hbm_available(n, m):
        solve = auction_solve_resident_hbm
    if solve is not None:
        row_to_col, price = solve(benefit, price, eps_list, max_sweeps)
    else:
        for eps in eps_list:
            row_to_col, price = _auction_phase(benefit, price, eps,
                                               max_sweeps)
    # greedy completion of any rows left by the sweep bound
    fallback = torch.argmax(benefit - price[:, None, :], dim=-1)
    row_to_col = torch.where(row_to_col < 0, fallback, row_to_col)
    return (row_to_col, price) if return_price else row_to_col


def assignment_cost(cost: torch.Tensor, row_to_col: torch.Tensor):
    """Total matched cost per batch element."""
    picked = torch.gather(cost, -1, row_to_col[..., None].long())
    return picked[..., 0].sum(dim=-1)

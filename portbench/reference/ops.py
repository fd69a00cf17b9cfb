"""Point operations the references share: a row gather whose backward
adds in a fixed order, farthest-point sampling, and the exact minimum
summed euclidean distance matching.

Autograd's own backward of a gather or of advanced indexing adds with
atomics in arrival order on the card, so its sums change from run to run
by rounding; the program's gathers add each row's contributions in
ascending order (a stable sort, then one ordered sum a row). The
references take this gather where a gradient flows back through one, so
that equal inputs give equal sums and a rounding difference cannot tip a
discrete choice (a part label, a mask, a bid) between the two sides.
"""

from __future__ import annotations

import numpy as np
import torch


class Gather(torch.autograd.Function):
    """points (B, N, C), flat (B, K) int64 -> points[b, flat[b, k]]."""

    @staticmethod
    def forward(ctx, points, flat):
        ctx.save_for_backward(flat)
        ctx.rows = points.shape[1]
        return torch.gather(points, 1,
                            flat[..., None].expand(-1, -1, points.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        b, n, c = flat.shape[0], ctx.rows, grad.shape[-1]
        offs = torch.arange(b, device=flat.device)[:, None] * n
        rows, order = torch.sort((flat + offs).reshape(-1), stable=True)
        bounds = torch.searchsorted(
            rows, torch.arange(b * n + 1, device=flat.device))
        out = torch.segment_reduce(grad.reshape(-1, c)[order], "sum",
                                   offsets=bounds, axis=0, unsafe=True)
        return out.reshape(b, n, c), None


def gather(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    flat = idx.reshape(idx.shape[0], -1)
    return Gather.apply(points, flat).reshape(idx.shape + points.shape[-1:])


@torch.no_grad()
def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling from index 0, ties to the lowest index, the
    distances summed (dx^2 + dy^2) + dz^2: (B, N, 3) -> (B, npoint)
    int64."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), float("inf"), device=xyz.device)
    far = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        d = None
        for k in range(3):
            diff = xyz[..., k] - c[:, k:k + 1]
            d = diff * diff if d is None else d + diff * diff
        dist = torch.minimum(dist, d)
        far = dist.argmax(1)
    return out


def _matching(args) -> np.ndarray:
    """The exact matching of one pair of clouds: row i to column perm[i]."""
    from scipy.optimize import linear_sum_assignment

    a, b = args
    d = [a[:, None, c] - b[None, :, c] for c in range(3)]
    cost = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    rows, cols = linear_sum_assignment(cost.astype(np.float64))
    perm = np.empty(len(rows), np.int64)
    perm[rows] = cols
    return perm


def exact_matchings(src, tgt, workers: int = 1) -> np.ndarray:
    """src (B, N, 3), tgt (B, N, 3) float32 -> (B, N) int64: for each pair
    the matching of least summed euclidean distance (scipy's
    linear_sum_assignment on the float32 distances, (dx^2 + dy^2) + dz^2
    then the root), solved in `workers` processes (spawned, and ended
    before this returns) where that is more than 1."""
    jobs = [(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in zip(src, tgt)]
    if workers > 1 and len(jobs) > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(workers, len(jobs)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            return np.stack(list(pool.map(_matching, jobs)))
    return np.stack([_matching(j) for j in jobs])

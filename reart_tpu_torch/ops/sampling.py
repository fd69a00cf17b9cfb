"""Farthest-point sampling, ball query and gathering
(reart_tpu/ops/sampling.py).

FPS keeps the reference CUDA kernel's determinism contract: it starts at
index 0 (or at the first masked index) and breaks ties to the lowest index.
`ball_query` (the kernel of ops/cuda_nn.py) keeps the first `nsample`
in-radius indices in point order, padded with the first. The JAX package's
`index_points_mm` (a gather whose backward is a one-hot matmul, a TPU
scatter workaround) has no counterpart: `gather_rows`, whose backward adds
in a fixed order, does its work.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.cuda_fps import fps
from reart_tpu_torch.ops.cuda_nn import ball_query  # noqa: F401  (re-export)
from reart_tpu_torch.ops.distance import scatter_rows


class _GatherRows(torch.autograd.Function):
    """points (B, N, C), idx (B, K) -> points[b, idx[b, k]] (B, K, C). The
    backward scatters the gradient through `scatter_rows`, which adds each
    row's contributions in ascending k on every device and in every run
    (autograd's own backward of a gather or of advanced indexing adds with
    float atomics in arrival order on the card)."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.rows = points.shape[1]
        return torch.gather(points, 1,
                            idx[..., None].expand(-1, -1, points.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, grad, ctx.rows), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather with a deterministic backward: points (B, N, C),
    idx (B, K) int64 -> (B, K, C)."""
    return _GatherRows.apply(points, idx)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    out = gather_rows(points, idx.reshape(points.shape[0], -1))
    return out.reshape(idx.shape + points.shape[-1:])


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS from index 0. xyz (B, N, 3) -> indices (B, npoint) int64."""
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    return fps(xyz.detach().contiguous(), mask, npoint)


def masked_farthest_point_sample(xyz: torch.Tensor, mask: torch.Tensor,
                                 npoint: int) -> torch.Tensor:
    """FPS restricted to `mask`-selected points, starting at the first masked
    index; returns indices into the original points. The caller guarantees
    >= npoint selected points per row."""
    return fps(xyz.detach().contiguous(), mask.to(torch.bool).contiguous(),
               npoint)

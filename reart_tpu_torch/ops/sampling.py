"""Farthest-point sampling, ball query and gathering
(reart_tpu/ops/sampling.py).

FPS keeps the reference CUDA kernel's determinism contract: it starts at
index 0 (or at the first masked index) and breaks ties to the lowest index.
`ball_query` (the kernel of ops/cuda_nn.py) keeps the first `nsample`
in-radius indices in point order, padded with the first. The JAX package's
`index_points_mm` (a gather whose backward is a one-hot matmul, a TPU
scatter workaround) has no counterpart: `index_points` and autograd's
gather backward do its work.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.cuda_fps import fps
from reart_tpu_torch.ops.cuda_nn import ball_query  # noqa: F401  (re-export)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)[:, None]
    out = points[rows, idx.reshape(b, -1)]
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

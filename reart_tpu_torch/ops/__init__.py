"""Neighbour, sampling and assignment ops (reart_tpu/ops).

The kernel modules are named after the Pallas modules they replace:
cuda_nn (pallas_nn), cuda_fps (pallas_fps), cuda_auction (pallas_auction).
Their CUDA sources live in reart_tpu_torch/csrc and are built on first use.
"""

from reart_tpu_torch.ops.assignment import assignment_cost, auction_lap
from reart_tpu_torch.ops.distance import (
    chamfer,
    chamfer_loss,
    knn,
    knn_transfer_features,
    knn_transfer_labels,
    nearest_neighbor,
    pairwise_sqdist,
)
from reart_tpu_torch.ops.interpolate import (
    blend_anchor_motion,
    blend_anchor_motion_batched,
    three_interpolate,
)
from reart_tpu_torch.ops.sampling import (
    ball_query,
    farthest_point_sample,
    index_points,
    masked_farthest_point_sample,
)

__all__ = [
    "assignment_cost", "auction_lap", "ball_query", "blend_anchor_motion",
    "blend_anchor_motion_batched", "chamfer", "chamfer_loss",
    "farthest_point_sample", "index_points", "knn", "knn_transfer_features",
    "knn_transfer_labels", "masked_farthest_point_sample", "nearest_neighbor",
    "pairwise_sqdist", "three_interpolate",
]

"""Models: the relaxation (base) stage. The kinematic stage follows."""

from reart_tpu_torch.models.base_model import (
    BaseModel,
    base_forward,
    compute_pc_transform,
    gumbel_noise,
    gumbel_softmax,
    refine_seg_motion,
    transform_points_blend,
)
from reart_tpu_torch.models.blocks import MLP

__all__ = [
    "BaseModel", "MLP", "base_forward", "compute_pc_transform",
    "gumbel_noise", "gumbel_softmax", "refine_seg_motion",
    "transform_points_blend",
]

"""Models: the relaxation (base) stage and the projection (kinematic)
stage."""

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
from reart_tpu_torch.models.kinematic import (
    KinematicModel,
    KinematicState,
    compile_tree,
    fk,
    kinematic_forward,
    make_kinematic_state,
)

__all__ = [
    "BaseModel", "KinematicModel", "KinematicState", "MLP", "base_forward",
    "compile_tree", "compute_pc_transform", "fk", "gumbel_noise",
    "gumbel_softmax", "kinematic_forward", "make_kinematic_state",
    "refine_seg_motion", "transform_points_blend",
]

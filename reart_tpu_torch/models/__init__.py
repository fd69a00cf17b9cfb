"""Models: the relaxation (base) stage, the projection (kinematic) stage
and the correspondence backbone (PointNet++ MSG)."""

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
from reart_tpu_torch.models.pointnet2 import (
    PointNet2Msg2,
    load_corr_model,
    save_corr_model,
    save_corr_model_torch,
)

__all__ = [
    "BaseModel", "KinematicModel", "KinematicState", "MLP", "PointNet2Msg2",
    "base_forward", "compile_tree", "compute_pc_transform", "fk",
    "gumbel_noise", "gumbel_softmax", "kinematic_forward", "load_corr_model",
    "make_kinematic_state", "refine_seg_motion", "save_corr_model",
    "save_corr_model_torch", "transform_points_blend",
]

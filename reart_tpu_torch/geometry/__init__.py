"""Geometry core: SO(3)/SE(3) maps, rotation representations, dual
quaternions and screws (reart_tpu/geometry)."""

from reart_tpu_torch.geometry.se3 import (
    hat,
    hat_inv,
    so3_exp_map,
    so3_log_map,
    so3_rotation_angle,
    se3_exp_map,
    se3_log_map,
    se3_exp_tw,
    inverse_transformation,
    acos_linear_extrapolation,
    matrix_to_quaternion,
    quaternion_to_axis_angle,
    standardize_quaternion,
    rotation_6d_to_matrix,
    matrix_to_rotation_6d,
    make_transform,
    rt_to_transform,
)
from reart_tpu_torch.geometry.dq import (
    q_mul,
    q_conjugate,
    q_normalize,
    q_angle,
    dq_mul,
    dq_normalize,
    dq_translation,
    dq_quaternion_conjugate,
    wrap_angle,
    transform_to_dq,
    dq_to_screw,
)
from reart_tpu_torch.geometry.screw import (
    screw_param_to_exponential_coordinates,
    transform_from_exponential_coordinates,
    screw_transform,
)

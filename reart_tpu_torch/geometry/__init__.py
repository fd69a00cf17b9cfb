"""Geometry core. Slice 1 ports only what the relaxation model needs; the
rest of reart_tpu/geometry follows in slice 2."""

from reart_tpu_torch.geometry.se3 import rotation_6d_to_matrix, rt_to_transform

__all__ = ["rotation_6d_to_matrix", "rt_to_transform"]

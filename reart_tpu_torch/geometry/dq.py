"""Quaternion / dual-quaternion algebra and screw extraction
(reart_tpu/geometry/dq.py).

The critical function is `dq_to_screw`: SE(3) -> Pluecker axis (l, m),
rotation angle theta and slide d, with the axis sign canonicalised against
up = (1, 1, 1) and the identity-transform guard. Branches are `torch.where`
selects with singularity-safe denominators.

Quaternions are (w, x, y, z), real part first. Dual quaternions are (..., 8)
= [real quat | dual quat].
"""

from __future__ import annotations

import math

import torch

from reart_tpu_torch.geometry.se3 import matrix_to_quaternion


def q_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _signs(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def q_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z)."""
    return q * _signs([1.0, -1.0, -1.0, -1.0], q)


def q_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions; a zero norm is clamped, not asserted."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp_min(norm, eps)


def q_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 4) quaternions, shape (..., 1):
    theta = 2 atan2(||im||, re), deliberately not wrapped to (-pi, pi]."""
    q = q_normalize(q)
    re, im = q[..., :1], q[..., 1:]
    norm = torch.linalg.norm(im, dim=-1, keepdim=True)
    return 2.0 * torch.atan2(norm, re)


def dq_mul(dq1: torch.Tensor, dq2: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion product."""
    r1, d1 = dq1[..., :4], dq1[..., 4:]
    r2, d2 = dq2[..., :4], dq2[..., 4:]
    return torch.cat([q_mul(r1, r2), q_mul(r1, d2) + q_mul(d1, r2)], dim=-1)


def dq_translation(dq: torch.Tensor) -> torch.Tensor:
    """Translation of a unit dual quaternion: 2 q_d q_r*."""
    r, d = dq[..., :4], dq[..., 4:]
    return q_mul(2.0 * d, q_conjugate(r))[..., 1:]


def dq_normalize(dq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Divide by the real-part norm."""
    norm = torch.sqrt(torch.sum(dq[..., :4] ** 2, dim=-1, keepdim=True))
    return dq / torch.clamp_min(norm, eps)


def dq_quaternion_conjugate(dq: torch.Tensor) -> torch.Tensor:
    """Element-wise quaternion conjugate of both parts."""
    return dq * _signs([1, -1, -1, -1, 1, -1, -1, -1], dq)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]; odd multiples of pi go to +pi."""
    res = torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(res == -math.pi, torch.full_like(res, math.pi), res)


def transform_to_dq(t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid transform -> unit dual quaternion."""
    q_r = matrix_to_quaternion(t[..., :3, :3])
    trans_q = torch.cat([torch.zeros_like(t[..., :1, 3]), t[..., :3, 3]],
                        dim=-1)
    q_d = 0.5 * q_mul(trans_q, q_r)
    return torch.cat([q_r, q_d], dim=-1)


def dq_to_screw(dq: torch.Tensor, eps: float = 1e-6):
    """Screw parameters of a rigid transform: (l, m, theta, d) with Pluecker
    axis direction l (..., 3), moment m (..., 3), rotation angle theta (...,)
    and slide d (...,).

      * no_rot frames (|theta| < eps or |theta - pi| < eps): axis from the
        translation direction, d = ||t||, theta pinned to eps;
      * the axis sign is canonicalised against up = (1, 1, 1): it flips
        (l, theta) and, for no_rot frames only, d;
      * identity transforms get l = (1, *, *): the axis is indeterminate
        there and only its x-component is forced.
    """
    dq_r = dq[..., :4]
    theta = q_angle(dq_r)  # (..., 1), from the normalized real part
    theta_sq = theta[..., 0]
    no_rot = (torch.abs(theta_sq) < eps) | (torch.abs(theta_sq - math.pi) < eps)
    t = dq_translation(dq)

    # with_rot axis: imaginary part / sin(theta / 2); safe where no_rot
    sin_half = torch.sin(theta / 2.0)
    sin_half_safe = torch.where(no_rot[..., None], torch.ones_like(sin_half),
                                sin_half)
    l_rot = dq_r[..., 1:] / sin_half_safe

    # no_rot axis: translation direction; d = ||t||
    t_norm = torch.linalg.norm(t, dim=-1)
    l_no = t / (t_norm[..., None] + 1e-10)

    l = torch.where(no_rot[..., None], l_no, l_rot)
    d = torch.where(no_rot, t_norm, torch.zeros_like(t_norm))

    # canonicalise the axis sign against up = (1, 1, 1)
    cos = torch.sum(l, dim=-1, keepdim=True)
    flip = cos < 0
    theta = torch.where(flip, -theta, theta)
    l = torch.where(flip, -l, l)
    d = torch.where(no_rot, torch.where(flip[..., 0], -d, d),
                    torch.sum(t * l, dim=-1))

    # identity transforms: axis indeterminate; force the x-component to 1
    no_trans = torch.abs(d) <= 1e-8
    unit_transform = no_rot & no_trans
    l = torch.where(unit_transform[..., None],
                    torch.cat([torch.ones_like(l[..., :1]), l[..., 1:]], -1),
                    l)

    theta = torch.where(no_rot[..., None], torch.full_like(theta, eps), theta)

    # moment m = 1/2 (t x l + l x (t x l) / tan(theta / 2))
    t_l_cross = torch.linalg.cross(t, l, dim=-1)
    m = 0.5 * (t_l_cross + torch.linalg.cross(
        l, t_l_cross / torch.tan(theta / 2.0), dim=-1))
    return l, m, theta[..., 0], d

"""SO(3)/SE(3) exponential and log maps and rotation representations
(reart_tpu/geometry/se3.py).

Everything is branchless (`torch.where` selects with singularity-safe
operands), so gradients stay finite at the singular inputs.

Conventions:
  * Rotation matrices act on column vectors: x' = R @ x.
  * 4x4 rigid transforms are column convention: [[R, t], [0, 1]].
  * `se3_exp_map` / `se3_log_map` keep the row-vector layout of the
    reference (input [log_translation | log_rotation], transposed matrices
    with the translation in the bottom row); new code uses `se3_exp_tw`.
"""

from __future__ import annotations

import math

import torch

DEFAULT_ACOS_BOUND: float = 1.0 - 1e-4


# ---------------------------------------------------------------------------
# hat / vee
# ---------------------------------------------------------------------------

def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of 3-vectors: (..., 3) -> (..., 3, 3) with rows
    [[0,-z,y],[z,0,-x],[-y,x,0]]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def hat_inv(h: torch.Tensor) -> torch.Tensor:
    """Inverse hat: (..., 3, 3) skew matrix -> (..., 3); skew-symmetry is
    assumed, not checked."""
    return torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def _so3_exp_terms(log_rot: torch.Tensor, eps: float = 1e-4):
    """Rotation matrix plus reusable intermediates. The squared norm of the
    rotation log is clamped at `eps` before the sqrt, so the effective
    minimum angle is sqrt(eps)."""
    nrms = torch.sum(log_rot * log_rot, dim=-1)
    rot_angles = torch.sqrt(torch.clamp_min(nrms, eps))
    inv = 1.0 / rot_angles
    fac1 = inv * torch.sin(rot_angles)
    fac2 = inv * inv * (1.0 - torch.cos(rot_angles))
    skews = hat(log_rot)
    eye = _eye(3, log_rot)
    # K^2 = w w^T - ||w||^2 I, computed analytically
    skews_sq = (log_rot[..., :, None] * log_rot[..., None, :]
                - nrms[..., None, None] * eye)
    r = fac1[..., None, None] * skews + fac2[..., None, None] * skews_sq + eye
    return r, rot_angles, skews, skews_sq


def so3_exp_map(log_rot: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): (..., 3) -> (..., 3, 3)."""
    return _so3_exp_terms(log_rot, eps)[0]


def acos_linear_extrapolation(
    x: torch.Tensor,
    bounds: tuple = (-DEFAULT_ACOS_BOUND, DEFAULT_ACOS_BOUND),
) -> torch.Tensor:
    """arccos with linear extrapolation outside `bounds`, for stable
    gradients."""
    lower, upper = bounds

    def _lin(xv, x0):
        dacos = -1.0 / math.sqrt(1.0 - x0 * x0)
        return (xv - x0) * dacos + math.acos(x0)

    acos_mid = torch.arccos(torch.clamp(x, lower, upper))
    return torch.where(
        x >= upper, _lin(x, upper),
        torch.where(x <= lower, _lin(x, lower), acos_mid))


def so3_rotation_angle(r: torch.Tensor, eps: float = 1e-4,
                       cos_angle: bool = False,
                       cos_bound: float = 1e-4) -> torch.Tensor:
    """Rotation angle from the matrix trace; invalid traces are clipped by
    the acos extrapolation."""
    rot_trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    phi_cos = (rot_trace - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        bound = 1.0 - cos_bound
        return acos_linear_extrapolation(phi_cos, (-bound, bound))
    return torch.arccos(phi_cos)


def so3_log_map(r: torch.Tensor, eps: float = 1e-4,
                cos_bound: float = 1e-4) -> torch.Tensor:
    """Log map SO(3) -> so(3), branchless."""
    phi = so3_rotation_angle(r, cos_bound=cos_bound, eps=eps)
    phi_sin = torch.sin(phi)
    ok = torch.abs(phi_sin) > (0.5 * eps)
    safe_sin = torch.where(ok, phi_sin, torch.ones_like(phi_sin))
    phi_factor = torch.where(ok, phi / (2.0 * safe_sin),
                             0.5 + (phi * phi) * (1.0 / 12))
    log_rot_hat = phi_factor[..., None, None] * (r - r.transpose(-1, -2))
    return hat_inv(log_rot_hat)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _se3_v_matrix(log_rotation, log_rotation_hat, log_rotation_hat_square,
                  rotation_angles) -> torch.Tensor:
    """The "V" matrix of the SE(3) exponential."""
    ang = rotation_angles
    fac1 = ((1.0 - torch.cos(ang)) / (ang ** 2))[..., None, None]
    fac2 = ((ang - torch.sin(ang)) / (ang ** 3))[..., None, None]
    return (_eye(3, log_rotation) + log_rotation_hat * fac1
            + log_rotation_hat_square * fac2)


def se3_exp_tw(omega_theta: torch.Tensor, v_theta: torch.Tensor,
               eps: float = 1e-4) -> torch.Tensor:
    """SE(3) exponential in column convention: rotation log (..., 3) and
    translation log (..., 3) -> (..., 4, 4) transforms [[R, V v], [0, 1]]."""
    r, rot_angles, skews, skews_sq = _so3_exp_terms(omega_theta, eps)
    v = _se3_v_matrix(omega_theta, skews, skews_sq, rot_angles)
    t = torch.sum(v * v_theta[..., None, :], dim=-1)
    return rt_to_transform(r, t)


def se3_exp_map(log_transform: torch.Tensor, eps: float = 1e-4):
    """Row-vector-convention SE(3) exp: (..., 6) = [log_translation |
    log_rotation] -> transposed matrices, translation in the bottom row."""
    m = se3_exp_tw(log_transform[..., 3:], log_transform[..., :3], eps)
    return m.transpose(-1, -2)


def se3_log_map(transform: torch.Tensor, eps: float = 1e-4,
                cos_bound: float = 1e-4) -> torch.Tensor:
    """Row-vector-convention SE(3) log: (..., 4, 4) with the translation in
    the bottom row -> (..., 6) = [log_translation | log_rotation]."""
    r = transform[..., :3, :3].transpose(-1, -2)
    log_rotation = so3_log_map(r, eps=eps, cos_bound=cos_bound)
    t = transform[..., 3, :3]
    nrms = torch.sum(log_rotation ** 2, dim=-1)
    rotation_angles = torch.sqrt(torch.clamp_min(nrms, eps))
    lr_hat = hat(log_rotation)
    lr_hat_sq = (log_rotation[..., :, None] * log_rotation[..., None, :]
                 - nrms[..., None, None] * _eye(3, log_rotation))
    v = _se3_v_matrix(log_rotation, lr_hat, lr_hat_sq, rotation_angles)
    log_translation = torch.linalg.solve(v, t[..., None])[..., 0]
    return torch.cat([log_translation, log_rotation], dim=-1)


def inverse_transformation(trans: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms analytically."""
    r = trans[..., :3, :3]
    t = trans[..., :3, 3:4]
    r_inv = r.transpose(-1, -2)
    t_inv = -(r_inv @ t)
    return rt_to_transform(r_inv, t_inv[..., 0])


def rt_to_transform(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation (..., 3, 3) and translation (..., 3) into (..., 4, 4)."""
    top = torch.cat([r, t[..., :, None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def make_transform(rotation: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """rt_to_transform that also takes a (..., 3, 1) translation."""
    if translation.shape[-1] == 1:
        translation = translation.reshape(translation.shape[:-2] + (3,))
    return rt_to_transform(rotation, translation)


# ---------------------------------------------------------------------------
# rotation representations
# ---------------------------------------------------------------------------

def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with zero subgradient at x <= 0."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4), real part
    first, choosing the best-conditioned of the four candidates."""
    batch = matrix.shape[:-2]
    m = matrix.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [m[..., i] for i in range(9)]

    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))

    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)  # (..., 4, 4): candidate i = desired quaternion * component i

    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    sel = torch.gather(quat_candidates, -2,
                       best[..., None, None].expand(batch + (1, 4)))
    return sel[..., 0, :]


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) -> axis-angle (..., 3)."""
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    small = torch.abs(angles) < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    ratio = torch.where(small, 0.5 - (angles * angles) / 48.0,
                        torch.sin(half_angles) / safe_angles)
    return quaternions[..., 1:] / ratio


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real part is non-negative."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D rotation -> matrix via Gram-Schmidt, norms clamped at
    1e-12 as in the reference."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Drop the last row of the rotation matrix: (..., 3, 3) -> (..., 6)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))

"""Screw parameters <-> SE(3) exponential coordinates
(reart_tpu/geometry/screw.py).

A joint's inactive coordinate is pinned to 1e-6 instead of 0 by the callers,
which keeps every frame in the `with_rot` branch (the no-rot test is a
strict `< eps` with eps = 1e-6), so h = d / theta stays finite and the screw
exponential gives the correct near-pure rotation or translation.
"""

from __future__ import annotations

import math

import torch

from reart_tpu_torch.geometry.se3 import se3_exp_tw


def screw_param_to_exponential_coordinates(
        l: torch.Tensor, m: torch.Tensor, theta: torch.Tensor,
        d: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(l, m, theta, d) -> exponential coordinates (omega theta | v theta),
    shape (..., 6). With rotation: omega = l, v = (l x m) x l + (d / theta) l.
    Without (|theta| < eps or |theta - pi| < eps, strict): omega = 0, v = l."""
    no_rot = (torch.abs(theta) < eps) | (torch.abs(theta - math.pi) < eps)
    with_rot = (~no_rot)[..., None]
    q = torch.linalg.cross(l, m, dim=-1)
    theta_safe = torch.where(no_rot, torch.ones_like(theta), theta)
    h = (d / theta_safe)[..., None]
    v_rot = torch.linalg.cross(q, l, dim=-1) + h * l
    w = torch.where(with_rot, l, torch.zeros_like(l))
    v = torch.where(with_rot, v_rot, l)
    return torch.cat([w, v], dim=-1) * theta[..., None]


def transform_from_exponential_coordinates(
        log_transform: torch.Tensor) -> torch.Tensor:
    """(omega theta | v theta), shape (..., 6) -> (..., 4, 4) column-
    convention transform."""
    return se3_exp_tw(log_transform[..., :3], log_transform[..., 3:])


def screw_transform(l: torch.Tensor, m: torch.Tensor, theta: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(l, m, theta, d) -> (..., 4, 4): the per-edge joint transform."""
    return transform_from_exponential_coordinates(
        screw_param_to_exponential_coordinates(l, m, theta, d))

"""SE(3) helpers needed by the relaxation model (reart_tpu/geometry/se3.py)."""

from __future__ import annotations

import torch


def rt_to_transform(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation (..., 3, 3) and translation (..., 3) into (..., 4, 4)."""
    top = torch.cat([r, t[..., :, None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D rotation -> matrix via Gram-Schmidt, norms clamped at
    1e-12 as in the reference."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)

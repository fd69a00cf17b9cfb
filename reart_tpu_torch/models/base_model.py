"""Relaxation ("base") model (reart_tpu/models/base_model.py).

A per-point seg MLP 3 -> hidden -> P (no bias on the last layer), learnable
per-part proposals `proposal_6d` (T-1, P, 6), initialised to the identity 6d
rep, and `proposal_t` (T-1, P, 3), initialised to zeros. The forward takes
Gumbel-softmax (hard) part weights, blends the per-part 3x4 transforms per
point, and applies the blend to the canonical cloud.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from reart_tpu_torch.geometry import rotation_6d_to_matrix, rt_to_transform
from reart_tpu_torch.models.blocks import MLP

IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class BaseModel(nn.Module):
    """Trainable state of the relaxation stage."""

    def __init__(self, num_parts: int, pose_len: int, hidden: int = 128, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.seg = MLP((3, hidden, num_parts), generator=generator,
                       device=device)
        ident = torch.tensor(IDENTITY_6D, dtype=torch.float32, device=device)
        self.proposal_6d = nn.Parameter(
            ident.repeat(pose_len, num_parts, 1))
        self.proposal_t = nn.Parameter(
            torch.zeros(pose_len, num_parts, 3, device=device))

    @property
    def num_parts(self) -> int:
        return self.proposal_6d.shape[1]

    def forward(self, cano_pc: torch.Tensor, noise: torch.Tensor,
                tau: float | torch.Tensor = 1.0):
        return base_forward(self, cano_pc, noise, tau)


def gumbel_noise(shape, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Standard Gumbel draw -log(-log(U)), with U kept away from 0."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, tau,
                   noise: torch.Tensor) -> torch.Tensor:
    """Straight-through (hard) Gumbel-softmax over the last axis with the
    Gumbel draw given as a tensor (torch.nn.functional.gumbel_softmax's
    protocol with hard=True)."""
    y = torch.softmax((logits + noise) / tau, dim=-1)
    one_hot = F.one_hot(torch.argmax(y, dim=-1), logits.shape[-1]).to(y.dtype)
    return one_hot + y - y.detach()


def transform_points_blend(weight: torch.Tensor, trans_list: torch.Tensor,
                           pc: torch.Tensor) -> torch.Tensor:
    """weight (N, P), trans_list (T, P, 4, 4), pc (N, 3) -> (T, N, 3).

    sum_p w[n,p] (R_tp x_n + t_tp) == (sum_p w[n,p] M_tp) x_n: the 3x4
    transforms are blended per point first, then applied once."""
    m34 = trans_list[..., :3, :]
    blended = torch.einsum("np,tpij->tnij", weight, m34)
    xh = torch.cat([pc, torch.ones_like(pc[:, :1])], dim=-1)
    return torch.einsum("tnij,nj->tni", blended, xh)


def base_forward(model: BaseModel, cano_pc: torch.Tensor,
                 noise: torch.Tensor, tau=1.0):
    """Returns (pc_trans_list (T-1, N, 3), seg_argmax (N,), trans_list
    (T-1, P, 4, 4)). `noise` is the (N, P) Gumbel draw."""
    logits = model.seg(cano_pc)
    weight = gumbel_softmax(logits, tau, noise)
    rotation = rotation_6d_to_matrix(model.proposal_6d)
    trans_list = rt_to_transform(rotation, model.proposal_t)
    pc_trans_list = transform_points_blend(weight, trans_list, cano_pc)
    return pc_trans_list, torch.argmax(logits, dim=-1), trans_list


def compute_pc_transform(cano_pc: torch.Tensor, pose_list: torch.Tensor,
                         cano_part: torch.Tensor) -> torch.Tensor:
    """Apply per-part poses (T, P, 4, 4) to cano_pc (N, 3) with hard labels
    cano_part (N,) -> (T, N, 3)."""
    weight = F.one_hot(cano_part.long(), pose_list.shape[1]).to(cano_pc.dtype)
    return transform_points_blend(weight, pose_list, cano_pc)

"""Relaxation ("base") model (reart_tpu/models/base_model.py).

A per-point seg MLP 3 -> hidden -> P (no bias on the last layer), learnable
per-part proposals `proposal_6d` (T-1, P, 6), initialised to the identity 6d
rep, and `proposal_t` (T-1, P, 3), initialised to zeros. The forward takes
Gumbel-softmax (hard) part weights, blends the per-part 3x4 transforms per
point, and applies the blend to the canonical cloud. `refine_seg_motion` is
the segmentation E-step that runs after the fit.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from reart_tpu_torch import device_of, resolve_device
from reart_tpu_torch.geometry import rotation_6d_to_matrix, rt_to_transform
from reart_tpu_torch.models.blocks import MLP
from reart_tpu_torch.ops.cuda_nn import nn_topk

IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class BaseModel(nn.Module):
    """Trainable state of the relaxation stage, built on the card unless
    `device` names another device."""

    def __init__(self, num_parts: int, pose_len: int, hidden: int = 128, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
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
                 noise: torch.Tensor, tau=1.0,
                 proposal_6d: torch.Tensor | None = None,
                 proposal_t: torch.Tensor | None = None):
    """Returns (pc_trans_list (T-1, N, 3), seg_argmax (N,), trans_list
    (T-1, P, 4, 4)). `noise` is the (N, P) Gumbel draw; `proposal_6d` /
    `proposal_t` stand in for the model's own (inverse kinematics)."""
    logits = model.seg(cano_pc)
    weight = gumbel_softmax(logits, tau, noise)
    p6d = model.proposal_6d if proposal_6d is None else proposal_6d
    pt = model.proposal_t if proposal_t is None else proposal_t
    trans_list = rt_to_transform(rotation_6d_to_matrix(p6d), pt)
    pc_trans_list = transform_points_blend(weight, trans_list, cano_pc)
    return pc_trans_list, torch.argmax(logits, dim=-1), trans_list


def compute_pc_transform(cano_pc: torch.Tensor, pose_list: torch.Tensor,
                         cano_part: torch.Tensor) -> torch.Tensor:
    """Apply per-part poses (T, P, 4, 4) to cano_pc (N, 3) with hard labels
    cano_part (N,) -> (T, N, 3)."""
    weight = F.one_hot(cano_part.long(), pose_list.shape[1]).to(cano_pc.dtype)
    return transform_points_blend(weight, pose_list, cano_pc)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor as numpy defines it: the mean of the two
    middle order statistics for an even count (torch.median returns the
    lower one)."""
    s, _ = torch.sort(x)
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


@torch.no_grad()
def refine_seg_motion(cano_pc, pc_list, trans_list, seg_part,
                      smooth_k: int = 8, smooth_alpha: float = 0.5,
                      rel_margin: float = 0.8, floor_mult: float = 4.0,
                      n_it: int = 1, device=None) -> torch.Tensor:
    """Motion-consistency segmentation E-step over fixed fitted poses.

    For each canonical point and each surviving part label, score the mean
    (over frames) 1-NN squared distance from the point carried by that
    part's fitted trajectory to the observed cloud, smooth the score field
    over each point's smooth_k nearest canonical neighbours, and relabel a
    point only when the best alternative beats its current label's score by
    the relative margin (new < rel_margin * current) and by an absolute
    floor (current - new > floor_mult * the cloud's median score).

    cano_pc (N, 3), pc_list (T, N', 3), trans_list (T, P_raw, 4, 4),
    seg_part (N,) int: labels index trans_list columns. Tensors, or arrays
    moved to `device` (the card when None). Returns the refined (N,) int64
    labels (same label space) as a tensor on that device.

    The candidate-part axis is not padded: the reference pads it to a
    multiple of 4 with duplicates of the first label, and a duplicate at a
    higher index never wins argmin, so the labels are equal.
    """
    dev = device_of(cano_pc, pc_list, trans_list, device=device)
    cano = torch.as_tensor(cano_pc, dtype=torch.float32, device=dev)
    pcs = torch.as_tensor(pc_list, dtype=torch.float32, device=dev)
    trans = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    seg = torch.as_tensor(seg_part, device=dev).long()
    n, t = cano.shape[0], pcs.shape[0]
    lab = torch.unique(seg)  # sorted
    p = lab.shape[0]
    if p < 2:
        return seg

    # spatial smoothing neighbourhood, computed once on the cano cloud
    _, nbr = nn_topk(cano, cano, smooth_k)  # (N, K) incl. self

    inv = torch.zeros(int(lab.max()) + 1, dtype=torch.long, device=dev)
    inv[lab] = torch.arange(p, device=dev)
    seg_c = inv[seg]  # compact current labels (N,)

    # (T, P, N, 3): every point carried by every candidate pose
    sub = trans[:, lab]
    moved = torch.einsum("tpij,nj->tpni", sub[:, :, :3, :3], cano) \
        + sub[:, :, None, :3, 3]
    # the observed cloud of frame t is shared by its P candidates and read
    # in place by the kernel. The scores do not depend on the labels, so
    # they are computed once; only the relabelling below iterates (the
    # reference recomputes the same scores in every pass).
    d, _ = nn_topk(moved, pcs[:, None], 1)  # (T, P, N, 1)
    cost = d[..., 0].mean(0).T  # (N, P)
    cost = ((1.0 - smooth_alpha) * cost
            + smooth_alpha * cost[nbr].mean(dim=1))
    best_cost, best = torch.min(cost, dim=1)
    for _ in range(n_it):
        cur = torch.gather(cost, 1, seg_c[:, None])[:, 0]
        floor = floor_mult * _median(cur)
        move = (best_cost < rel_margin * cur) & (cur - best_cost > floor)
        seg_c = torch.where(move, best, seg_c)
    return lab[seg_c]

"""Edge and merge costs of the graph stage (reart_tpu/graph/costs.py):
batched tensor code that runs between the fit and the metrics, on the
device of its inputs.

Quirks of the reference kept on purpose (they shape the selected tree):
  * `compute_mean_screw_param` plain-means over time when E <= 1 (no
    identity masking);
  * the prismatic branch of `compute_geo_cost` adds a scalar rotation MSE
    (mean over all pairs) to the per-pair cost matrix;
  * thetas and distances pinned at 1e-6 throughout.
"""

from __future__ import annotations

import math

import torch

from reart_tpu_torch.geometry import (
    dq_to_screw,
    inverse_transformation,
    screw_param_to_exponential_coordinates,
    transform_from_exponential_coordinates,
    transform_to_dq,
)
from reart_tpu_torch.ops import chamfer, masked_farthest_point_sample


def frobenius_cost(predict: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """sum |predict @ gt^-1 - I|^2 over matrix entries."""
    err = predict @ inverse_transformation(gt)
    eye = torch.eye(4, dtype=predict.dtype, device=predict.device)
    return torch.sum((err - eye) ** 2, dim=(-2, -1))


def compute_root_cost(trans_list: torch.Tensor) -> torch.Tensor:
    """Static-part score: time-mean squared deviation from identity.
    trans_list (T, P, 4, 4) -> (P,)."""
    eye = torch.eye(4, dtype=trans_list.dtype, device=trans_list.device)
    return torch.mean(torch.sum((trans_list - eye) ** 2, dim=(2, 3)), dim=0)


def compute_mean_screw_param(s_axis: torch.Tensor, moment: torch.Tensor,
                             theta: torch.Tensor, distance: torch.Tensor,
                             eps_tol: float = 1e-5):
    """Time-mean screw axis and moment with identity-frame masking.
    s_axis, moment (T, E, 3); theta, distance (T, E) -> two (E, 3). For
    E <= 1 the reference plain-means with no masking: kept."""
    e = s_axis.shape[1]
    if e <= 1:
        return torch.mean(s_axis, dim=0), torch.mean(moment, dim=0)
    no_rot = ((torch.abs(theta) <= eps_tol)
              | (torch.abs(theta - math.pi) <= eps_tol))
    unit = no_rot & (distance <= eps_tol)                     # (T, E)
    keep = (~unit).to(s_axis.dtype)[..., None]                # (T, E, 1)
    cnt = torch.sum(keep, dim=0)                              # (E, 1)
    denom = torch.clamp_min(cnt, 1.0)
    masked_axis = torch.sum(s_axis * keep, dim=0) / denom
    masked_moment = torch.sum(moment * keep, dim=0) / denom
    all_unit = cnt == 0
    return (torch.where(all_unit, torch.mean(s_axis, dim=0), masked_axis),
            torch.where(all_unit, torch.mean(moment, dim=0), masked_moment))


def compute_relative_trans(trans_list: torch.Tensor,
                           return_trans: bool = False):
    """All-pairs relative screws: rel[t, i, j] = T_i^-1 T_j. trans_list
    (T, P, 4, 4) -> (axis, moment (T, P, P, 3), theta, distance (T, P, P)
    [, rel (T, P, P, 4, 4)])."""
    t, p = trans_list.shape[:2]
    inv = inverse_transformation(trans_list)
    rel = inv[:, :, None] @ trans_list[:, None, :]            # (T, P, P, 4, 4)
    s_axis, moment, theta, distance = dq_to_screw(
        transform_to_dq(rel.reshape(-1, 4, 4)))
    out = (s_axis.reshape(t, p, p, 3), moment.reshape(t, p, p, 3),
           theta.reshape(t, p, p), distance.reshape(t, p, p))
    return out + (rel,) if return_trans else out


def _recon_from_screws(mean_axis, mean_moment, theta, distance):
    return transform_from_exponential_coordinates(
        screw_param_to_exponential_coordinates(mean_axis, mean_moment, theta,
                                               distance))


def _without_rotation(trans: torch.Tensor) -> torch.Tensor:
    """A copy of (..., 4, 4) transforms with the rotation block set to I."""
    out = trans.clone()
    out[..., :3, :3] = torch.eye(3, dtype=trans.dtype, device=trans.device)
    return out


def _joint_hypotheses(trans, mean_axis, mean_moment, theta, distance):
    """Reconstruction cost of the revolute (distance pinned) and prismatic
    (theta pinned, compared against the rotation-stripped transforms)
    hypotheses. trans (T, ..., 4, 4); mean_* (T, ..., 3); theta, distance
    (T, ...) -> (t_recon_r, cost_r (...), t_recon_p, cost_p (...))."""
    t_recon_r = _recon_from_screws(mean_axis, mean_moment, theta,
                                   torch.full_like(distance, 1e-6))
    cost_r = torch.sum(frobenius_cost(t_recon_r, trans), dim=0)
    t_recon_p = _recon_from_screws(mean_axis, mean_moment,
                                   torch.full_like(theta, 1e-6), distance)
    cost_1 = torch.sum(frobenius_cost(t_recon_p, _without_rotation(trans)),
                       dim=0)
    # scalar rotation MSE over all pairs and frames (reference quirk)
    cost_2 = torch.mean((t_recon_p[..., :3, :3] - trans[..., :3, :3]) ** 2)
    return t_recon_r, cost_r, t_recon_p, cost_1 + cost_2


def compute_geo_cost(rel_trans, axis, moment, theta, distance) -> torch.Tensor:
    """Screw-consistency cost per part pair, min(revolute, prismatic).
    rel_trans (T, P, P, 4, 4); screws (T, P, P, *) -> (P, P)."""
    t, p = axis.shape[:2]
    mean_axis, mean_moment = compute_mean_screw_param(
        axis.reshape(t, -1, 3), moment.reshape(t, -1, 3),
        theta.reshape(t, -1), distance.reshape(t, -1))
    mean_axis = mean_axis.reshape(1, p, p, 3).expand(t, p, p, 3)
    mean_moment = mean_moment.reshape(1, p, p, 3).expand(t, p, p, 3)
    _, cost_r, _, cost_p = _joint_hypotheses(rel_trans, mean_axis,
                                             mean_moment, theta, distance)
    return torch.minimum(cost_r, cost_p)


def compute_screw_trans(trans_list: torch.Tensor, return_cost: bool = False):
    """Project per-edge transforms onto their best-fit constant screw.
    trans_list (T, E, 4, 4) -> (T, E, 4, 4) (+ scalar cost mean / T)."""
    t, e = trans_list.shape[:2]
    s_axis, moment, theta, distance = dq_to_screw(
        transform_to_dq(trans_list.reshape(-1, 4, 4)))
    s_axis, moment = s_axis.reshape(t, e, 3), moment.reshape(t, e, 3)
    theta, distance = theta.reshape(t, e), distance.reshape(t, e)
    mean_axis, mean_moment = compute_mean_screw_param(s_axis, moment, theta,
                                                      distance)
    mean_axis = mean_axis[None].expand(t, e, 3)
    mean_moment = mean_moment[None].expand(t, e, 3)
    t_recon_r, cost_r, t_recon_p, cost_p = _joint_hypotheses(
        trans_list, mean_axis, mean_moment, theta, distance)
    pris = (cost_p <= cost_r)[None, :, None, None]
    t_recon = torch.where(pris, t_recon_p, t_recon_r)
    if return_cost:
        return t_recon, torch.mean(torch.minimum(cost_r, cost_p)) / t
    return t_recon


def compute_screw_cost(pred_trans_list: torch.Tensor,
                       pred_connection: torch.Tensor) -> torch.Tensor:
    """Screw-consistency energy over tree edges (model-selection term)."""
    src = pred_trans_list[:, pred_connection[:, 0]]
    tgt = pred_trans_list[:, pred_connection[:, 1]]
    _, cost = compute_screw_trans(inverse_transformation(src) @ tgt,
                                  return_cost=True)
    return cost


# ---------------------------------------------------------------------------
# FPS-anchored spatial / joint costs
# ---------------------------------------------------------------------------

def fps_sample_cano(cano_pc: torch.Tensor, cano_part: torch.Tensor,
                    uni_label: torch.Tensor, num_fps: int = 20):
    """Per-part FPS anchors in the canonical frame, all parts in one masked
    FPS launch: (part_fps (P, num_fps, 3), part_idx (P, num_fps) indices
    into cano_pc)."""
    masks = cano_part[None, :] == uni_label[:, None]          # (P, N)
    xyz = cano_pc[None].expand((uni_label.shape[0],) + cano_pc.shape)
    idx = masked_farthest_point_sample(xyz, masks, num_fps)   # (P, num_fps)
    return cano_pc[idx], idx


def fps_index_list(pc_trans_list: torch.Tensor,
                   cano_part_idx_list: torch.Tensor) -> torch.Tensor:
    """Track FPS anchors through time: (T, N, 3), (P, F) -> (T, P, F, 3)."""
    return pc_trans_list[:, cano_part_idx_list]


def compute_spatial_cost(cano_part_fps_list: torch.Tensor,
                         return_index: bool = False):
    """Min pairwise part-to-part anchor distance (squared) in the cano
    frame: (P, F, 3) -> (P, P) [+ (P, P, 2) closest anchor-index pairs].
    All P^2 pairs go through the 1-NN kernel in one launch."""
    p, f = cano_part_fps_list.shape[:2]
    src = cano_part_fps_list[:, None].expand(p, p, f, 3).reshape(-1, f, 3)
    tgt = cano_part_fps_list[None, :].expand(p, p, f, 3).reshape(-1, f, 3)
    d, idx = chamfer(src, tgt, return_index=True)             # (P*P, F)
    d = d.reshape(p, p, f)
    src_idx = torch.argmin(d, dim=2)                          # (P, P)
    dist_cost = torch.gather(d, 2, src_idx[..., None])[..., 0]
    if not return_index:
        return dist_cost
    tgt_idx = torch.gather(idx.reshape(p, p, f), 2, src_idx[..., None])[..., 0]
    return dist_cost, torch.stack([src_idx, tgt_idx], dim=2)


def compute_joint_cost(part_fps_list: torch.Tensor,
                       joint_connection: torch.Tensor,
                       edge_pair_indices: torch.Tensor) -> torch.Tensor:
    """Temporal joint-contact cost per candidate edge. part_fps_list
    (T, P, F, 3); joint_connection (E, 2) part ids; edge_pair_indices (E, 2)
    anchor ids -> (T, E)."""
    j0 = part_fps_list[:, joint_connection[:, 0], edge_pair_indices[:, 0]]
    j1 = part_fps_list[:, joint_connection[:, 1], edge_pair_indices[:, 1]]
    return torch.sum((j0 - j1) ** 2, dim=-1)

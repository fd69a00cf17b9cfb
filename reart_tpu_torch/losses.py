"""Training losses of both model stages and the group term of the
selection energy (reart_tpu/losses.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from reart_tpu_torch import to_numpy
from reart_tpu_torch.ops.distance import chamfer, chamfer_loss


def recon_loss(pc_trans_list: torch.Tensor,
               pc_list: torch.Tensor) -> torch.Tensor:
    """Summed bidirectional Chamfer."""
    return chamfer_loss(pc_trans_list, pc_list)


def _huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    absx = torch.abs(x)
    return torch.where(absx < delta, 0.5 * x * x, delta * (absx - 0.5 * delta))


def flow_loss(gt_flow_list: torch.Tensor, pred_flow_list: torch.Tensor,
              flow_mask_list: torch.Tensor | None = None,
              robust: bool = False,
              smooth_weight: float = 1e-2) -> torch.Tensor:
    """Masked per-point flow loss plus smoothness on unmasked points."""
    if flow_mask_list is None:
        flow_mask_list = torch.ones(pred_flow_list.shape[:2],
                                    dtype=pred_flow_list.dtype,
                                    device=pred_flow_list.device)
    else:
        flow_mask_list = flow_mask_list.to(pred_flow_list.dtype)
    diff = pred_flow_list - gt_flow_list
    f = torch.sum(_huber(diff) if robust else diff * diff, dim=2)
    smooth = torch.sum(pred_flow_list ** 2, dim=2)
    return torch.sum(flow_mask_list * f
                     + smooth_weight * (1.0 - flow_mask_list) * smooth)


def assignment_loss(pc_src: torch.Tensor, pc_tgt: torch.Tensor,
                    perm: torch.Tensor) -> torch.Tensor:
    """Squared error over matched pairs: pc_src, pc_tgt (T, M, 3), perm
    (T, M) int — row i of frame t is matched to pc_tgt[t, perm[t, i]]."""
    matched = torch.gather(pc_tgt, 1, perm[..., None].expand(-1, -1, 3))
    return torch.sum((pc_src - matched) ** 2)


def structure_loss(rel_trans_list, axis, moment, theta, distance, edge_list):
    """Screw-consistency loss: per-edge relative transforms against the
    transform rebuilt from the (no-grad) time-mean screw, with hard joint
    typing by mean |theta| vs mean |d|.

    rel_trans_list (T, P, P, 4, 4); axis/moment (T, P, P, 3); theta/distance
    (T, P, P); edge_list (E, 2)."""
    from reart_tpu_torch.geometry import (
        screw_param_to_exponential_coordinates,
        transform_from_exponential_coordinates,
    )
    from reart_tpu_torch.graph.costs import (
        compute_mean_screw_param,
        frobenius_cost,
    )

    edge_list = torch.as_tensor(edge_list, device=theta.device)
    e0, e1 = edge_list[:, 0], edge_list[:, 1]
    sel_rel = rel_trans_list[:, e0, e1]
    sel_theta = theta[:, e0, e1]
    sel_dist = distance[:, e0, e1]
    t, e = sel_theta.shape

    mean_axis, mean_moment = compute_mean_screw_param(
        axis[:, e0, e1], moment[:, e0, e1], sel_theta, sel_dist)
    pris = (torch.mean(torch.abs(sel_dist), 0)
            > torch.mean(torch.abs(sel_theta), 0))[None]
    theta_eff = torch.where(pris, 1e-6, sel_theta)
    dist_eff = torch.where(pris, sel_dist, 1e-6)
    log_t = screw_param_to_exponential_coordinates(
        mean_axis[None].expand(t, e, 3), mean_moment[None].expand(t, e, 3),
        theta_eff, dist_eff)
    target = transform_from_exponential_coordinates(log_t).detach()
    return torch.sum(frobenius_cost(sel_rel, target))


def compute_connection_loss(cano_pc, seg_part, joint_connection,
                            pc_trans_list, k: int = 10):
    """Joint-contact consistency: the k closest cross-part point pairs (in
    the canonical frame) must stay together over time. A host loop over the
    edges, since part sizes depend on the data; each edge is one launch of
    the 1-NN kernel."""
    seg = to_numpy(seg_part)
    dev = pc_trans_list.device
    loss = torch.zeros((), dtype=pc_trans_list.dtype, device=dev)
    for edge in np.asarray(joint_connection):
        src_all = torch.as_tensor(np.nonzero(seg == edge[0])[0], device=dev)
        tgt_all = torch.as_tensor(np.nonzero(seg == edge[1])[0], device=dev)
        d_s2t, nn_tgt = chamfer(cano_pc[src_all], cano_pc[tgt_all],
                                return_index=True)
        _, src_sel = torch.topk(-d_s2t, k)
        raw_src = src_all[src_sel]
        raw_tgt = tgt_all[nn_tgt[src_sel]]
        d = torch.sum((pc_trans_list[:, raw_src] - pc_trans_list[:, raw_tgt])
                      ** 2, dim=2).mean(dim=1)
        loss = loss + torch.sum(d)
    return loss


def group_temporal_err(pc_list: torch.Tensor, seg_part: torch.Tensor,
                       num_parts: int) -> torch.Tensor:
    """Max over parts of the mean squared spread of a part's points around
    its centroid across time. pc_list (T, N, 3), seg_part (N,) int. Parts
    absent from seg_part get -inf and never win the max."""
    w = F.one_hot(seg_part.long(), num_parts).to(pc_list.dtype)   # (N, P)
    cnt = torch.sum(w, dim=0)                                     # (P,)
    safe_cnt = torch.clamp_min(cnt, 1.0)
    centroid = torch.einsum("tnc,np->tpc", pc_list, w) \
        / safe_cnt[None, :, None]
    cent_per_point = torch.einsum("tpc,np->tnc", centroid, w)
    d = torch.sum((pc_list - cent_per_point) ** 2, dim=2)         # (T, N)
    per_part = torch.einsum("tn,np->p", d, w) / (safe_cnt * pc_list.shape[0])
    neg_inf = torch.full_like(per_part, float("-inf"))
    return torch.max(torch.where(cnt > 0, per_part, neg_inf))

"""Training losses of the relaxation fit (reart_tpu/losses.py). The
structure and connection losses come in slice 2."""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.distance import chamfer_loss


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

"""Inverse-distance interpolation and anchor-flow blending
(reart_tpu/ops/interpolate.py).

Weights are inverse euclidean distances floored at 1e-10. The validity mask
is min_dist <= max squared flow norm OR min_dist <= 0.05: the reference's
unit-mixing comparison, kept as it is.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.cuda_nn import blend3, nn_topk
from reart_tpu_torch.ops.distance import knn


def three_interpolate(xyz_query: torch.Tensor, xyz_ref: torch.Tensor,
                      feat_ref: torch.Tensor, eps: float = 1e-8):
    """Inverse-square-distance 3-NN feature interpolation: xyz_query
    (..., N, 3), xyz_ref (..., S, 3), feat_ref (..., S, D) -> (..., N, D),
    weights 1 / (sqdist + eps), normalised. The neighbours come from the
    k-NN kernel (not differentiable); the squared distances are recomputed
    from the gathered points, so gradients reach both clouds and the
    features alike on the CPU and on the card."""
    k = min(3, xyz_ref.shape[-2])
    _, idx = nn_topk(xyz_query, xyz_ref, k)                    # (..., N, k)
    flat = idx.reshape(idx.shape[:-2] + (-1,))

    def gather(ref):                        # (..., S, C) -> (..., N, k, C)
        c = ref.shape[-1]
        ref = ref.expand(idx.shape[:-2] + ref.shape[-2:])
        out = torch.gather(ref, -2, flat[..., None].expand(
            flat.shape + (c,)))
        return out.reshape(idx.shape + (c,))

    diff = xyz_query[..., None, :] - gather(xyz_ref)
    d = torch.sum(diff * diff, dim=-1)
    w = 1.0 / (d + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(gather(feat_ref) * w[..., None], dim=-2)


def blend_anchor_motion(query_loc: torch.Tensor, reference_loc: torch.Tensor,
                        reference_flow: torch.Tensor, k: int = 3,
                        return_mask: bool = False):
    """Flow on query points (m, 3) from the k nearest anchors (n, 3): the
    k-NN kernel, then gathers. The batched k=3 form below runs its own fused
    kernel."""
    dists, idx = knn(query_loc, reference_loc, k)   # euclidean, ascending
    dists = torch.clamp_min(dists, 1e-10)
    weight = 1.0 / dists
    weight = weight / torch.sum(weight, dim=-1, keepdim=True)
    flows = reference_flow[idx]                                # (m, k, 3)
    blended = torch.sum(flows * weight[..., None], dim=-2)
    if not return_mask:
        return blended
    min_dists = torch.amin(dists, dim=-1)
    flow_dists = torch.amax(torch.sum(flows ** 2, dim=-1), dim=-1)
    mask = (min_dists <= flow_dists) | (min_dists <= 0.05)
    return blended, mask


@torch.no_grad()
def blend_anchor_motion_batched(query_loc: torch.Tensor,
                                reference_loc: torch.Tensor,
                                reference_flow: torch.Tensor):
    """Batched blend_anchor_motion(k=3, return_mask=True) through the blend3
    kernel: query (B, N, 3), anchors/flows (B, M >= 3, 3) ->
    (blended (B, N, 3), mask (B, N) bool). Not differentiable."""
    blended, min_d, flow_d = blend3(query_loc.contiguous(),
                                    reference_loc.contiguous(),
                                    reference_flow.contiguous())
    return blended, (min_d <= flow_d) | (min_d <= 0.05)

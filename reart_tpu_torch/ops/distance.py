"""Pairwise distances, 1-NN and the bidirectional Chamfer
(reart_tpu/ops/distance.py).

Neighbour indices are not differentiable; gradients flow through the
winners' coordinates that the fused kernel returns, never through an
(N, M) distance matrix.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops import _build
from reart_tpu_torch.ops.cuda_nn import nn1_bidir_coords


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ||x||^2 + ||y||^2 - 2 x.y^T, clamped at
    0. x (..., N, C), y (..., M, C) -> (..., N, M)."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor):
    """1-NN: (sq_dists (..., N), idx (..., N)), ties to the lowest index.

    The TPU path of this op is the k-NN kernel (pallas_nn.nn_topk), which is
    ported in slice 2; until then a CUDA tensor raises."""
    if not _build.is_cpu("nearest_neighbor", query):
        raise NotImplementedError(
            "nearest_neighbor on CUDA needs the k-NN kernel (nn_topk), "
            "ported in slice 2")
    sq = pairwise_sqdist(query, ref)
    idx = torch.argmin(sq, dim=-1)
    return torch.gather(sq, -1, idx[..., None])[..., 0], idx


def _scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int):
    """Batched scatter-add: idx (B, K), vals (B, K, 3) -> (B, n, 3)."""
    b = idx.shape[0]
    offs = torch.arange(b, device=idx.device)[:, None] * n
    out = torch.zeros((b * n, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, (idx + offs).reshape(-1),
                   vals.reshape(-1, vals.shape[-1]))
    return out.reshape(b, n, vals.shape[-1])


class _NNBidir(torch.autograd.Function):
    """Bidirectional per-point NN squared distances and (non-differentiable)
    indices from one fused kernel pass. Gradients: a direct residual
    2 g (x - nn) on the query side of each direction and the matching
    scatter-add on its ref side; a cloud that needs no gradient (the
    observed clouds of recon_loss) skips its scatter."""

    @staticmethod
    def forward(ctx, src, tgt):
        fd, fi, fc, bd, bi, bc = nn1_bidir_coords(src, tgt)
        ctx.save_for_backward(src, tgt, fc, bc, fi, bi)
        ctx.mark_non_differentiable(fi, bi)
        return fd, fi, bd, bi

    @staticmethod
    def backward(ctx, gf, _gfi, gb, _gbi):
        src, tgt, fc, bc, fi, bi = ctx.saved_tensors
        resid_f = 2.0 * gf[..., None] * (src - fc)   # (B, N, 3)
        resid_b = 2.0 * gb[..., None] * (tgt - bc)   # (B, M, 3)
        grad_src = grad_tgt = None
        if ctx.needs_input_grad[0]:
            grad_src = resid_f + _scatter_rows(bi, -resid_b, src.shape[1])
        if ctx.needs_input_grad[1]:
            grad_tgt = resid_b + _scatter_rows(fi, -resid_f, tgt.shape[1])
        return grad_src, grad_tgt


def nn_bidir_sqdist_with_idx(src: torch.Tensor, tgt: torch.Tensor):
    """((d_fwd, idx_fwd), (d_bwd, idx_bwd)) of the bidirectional 1-NN,
    differentiable in both clouds. src (..., N, 3), tgt (..., M, 3) with
    the same leading dims."""
    batch = src.shape[:-2]
    fd, fi, bd, bi = _NNBidir.apply(
        src.reshape((-1,) + src.shape[-2:]).contiguous(),
        tgt.reshape((-1,) + tgt.shape[-2:]).contiguous())

    def rs(x):
        return x.reshape(batch + x.shape[-1:])

    return (rs(fd), rs(fi)), (rs(bd), rs(bi))


def chamfer_loss(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Summed bidirectional Chamfer (the reference's recon_loss); both
    directions come from one fused kernel launch."""
    (d_fwd, _), (d_bwd, _) = nn_bidir_sqdist_with_idx(src, tgt)
    return torch.sum(d_fwd) + torch.sum(d_bwd)

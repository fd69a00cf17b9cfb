"""Pairwise distances, k-NN, Chamfer and 1-NN transfer
(reart_tpu/ops/distance.py).

Neighbour indices are not differentiable; gradients flow through the
winners' coordinates that the 1-NN kernels return, never through an
(N, M) distance matrix. 3-D clouds go through the neighbour kernels of
ops/cuda_nn.py (their plain versions on the CPU); other widths take the
materialised-matrix path.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops.cuda_nn import (
    ksmallest,
    nn1_bidir_coords,
    nn1_coords,
    nn_topk,
)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ||x||^2 + ||y||^2 - 2 x.y^T, clamped at
    0. x (..., N, C), y (..., M, C) -> (..., N, M)."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def _is_3d(query: torch.Tensor, ref: torch.Tensor) -> bool:
    return query.shape[-1] == 3 and ref.shape[-1] == 3


def knn(query: torch.Tensor, ref: torch.Tensor, k: int):
    """k nearest neighbours of `query` (..., N, C) in `ref` (..., M, C):
    (dists, idx), euclidean (not squared) distances (..., N, k) in ascending
    order, equal distances in ascending index."""
    if _is_3d(query, ref):
        sq, idx = nn_topk(query, ref, k)
    else:
        sq, idx = ksmallest(pairwise_sqdist(query, ref), k)
    return torch.sqrt(torch.clamp_min(sq, 0.0)), idx


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor):
    """1-NN: (sq_dists (..., N), idx (..., N)), ties to the lowest index."""
    if _is_3d(query, ref):
        sq, idx = nn_topk(query, ref, 1)
        return sq[..., 0], idx[..., 0]
    sq = pairwise_sqdist(query, ref)
    idx = torch.argmin(sq, dim=-1)
    return torch.gather(sq, -1, idx[..., None])[..., 0], idx


def scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int):
    """Batched scatter-add in a fixed order: idx (B, K), vals (B, K, C) ->
    (B, n, C), row i of element b the sum of the vals whose idx is i, added
    one by one in ascending k, starting from zero. That is the order of
    `index_add_` on the CPU, and it is the same on every device and in every
    run: the rows are sorted stably, and each row's run is summed in order
    by one thread of `segment_reduce` (an `index_add_` on the card adds with
    float atomics in arrival order)."""
    b, c = idx.shape[0], vals.shape[-1]
    offs = torch.arange(b, device=idx.device)[:, None] * n
    rows, order = torch.sort((idx + offs).reshape(-1), stable=True)
    bounds = torch.searchsorted(
        rows, torch.arange(b * n + 1, device=idx.device))
    out = torch.segment_reduce(vals.reshape(-1, c)[order], "sum",
                               offsets=bounds, axis=0, unsafe=True)
    return out.reshape(b, n, c)


class _NNPoints(torch.autograd.Function):
    """Per-point NN squared distance and (non-differentiable) index of
    query (B, N, 3) in ref (B, M, 3), with the winners' coordinates from the
    kernel. Gradients: 2 g (query - nn) to the query, the scatter-add of its
    negative to the ref (`scatter_rows`: the same bits in every run),
    skipped when the ref needs no gradient."""

    @staticmethod
    def forward(ctx, query, ref):
        d, idx, coords = nn1_coords(query, ref)
        ctx.save_for_backward(query, coords, idx)
        ctx.ref_points = ref.shape[1]
        ctx.mark_non_differentiable(idx)
        return d, idx

    @staticmethod
    def backward(ctx, g, _gidx):
        query, coords, idx = ctx.saved_tensors
        resid = 2.0 * g[..., None] * (query - coords)   # (B, N, 3)
        grad_ref = None
        if ctx.needs_input_grad[1]:
            grad_ref = scatter_rows(idx, -resid, ctx.ref_points)
        return (resid if ctx.needs_input_grad[0] else None), grad_ref


class _NNBidir(torch.autograd.Function):
    """Bidirectional per-point NN squared distances and (non-differentiable)
    indices from one fused kernel pass. Gradients: a direct residual
    2 g (x - nn) on the query side of each direction and the matching
    scatter-add (`scatter_rows`: the same bits in every run) on its ref
    side; a cloud that needs no gradient (the observed clouds of recon_loss)
    skips its scatter."""

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
            grad_src = resid_f + scatter_rows(bi, -resid_b, src.shape[1])
        if ctx.needs_input_grad[1]:
            grad_tgt = resid_b + scatter_rows(fi, -resid_f, tgt.shape[1])
        return grad_src, grad_tgt


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[-2:]).contiguous()


def nn_sqdist_with_idx(src: torch.Tensor, tgt: torch.Tensor):
    """(d (..., N), idx (..., N)) of each src point to its nearest tgt
    point, differentiable in both clouds. src (..., N, 3), tgt (..., M, 3)
    with the same leading dims."""
    batch = src.shape[:-2]
    d, idx = _NNPoints.apply(_flat(src), _flat(tgt))
    return d.reshape(batch + d.shape[-1:]), idx.reshape(batch + idx.shape[-1:])


def nn_bidir_sqdist_with_idx(src: torch.Tensor, tgt: torch.Tensor):
    """((d_fwd, idx_fwd), (d_bwd, idx_bwd)) of the bidirectional 1-NN,
    differentiable in both clouds. src (..., N, 3), tgt (..., M, 3) with
    the same leading dims."""
    batch = src.shape[:-2]
    fd, fi, bd, bi = _NNBidir.apply(_flat(src), _flat(tgt))

    def rs(x):
        return x.reshape(batch + x.shape[-1:])

    return (rs(fd), rs(fi)), (rs(bd), rs(bi))


def chamfer(src: torch.Tensor, tgt: torch.Tensor, bidirectional: bool = False,
            reverse: bool = False, return_index: bool = False):
    """Per-point squared-distance Chamfer, no reduction. src (..., N, 3),
    tgt (..., M, 3). Returns
      * default: dist_src2tgt (..., N);
      * reverse: dist_tgt2src (..., M);
      * bidirectional: dist_src2tgt + dist_tgt2src elementwise (N == M);
      * return_index: additionally the NN indices (fwd[, bwd])."""
    if bidirectional:
        (d_fwd, i_fwd), (d_bwd, i_bwd) = nn_bidir_sqdist_with_idx(src, tgt)
        if return_index:
            return d_fwd + d_bwd, i_fwd, i_bwd
        return d_fwd + d_bwd
    if reverse:
        d, idx = nn_sqdist_with_idx(tgt, src)
    else:
        d, idx = nn_sqdist_with_idx(src, tgt)
    return (d, idx) if return_index else d


def chamfer_loss(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Summed bidirectional Chamfer (the reference's recon_loss); both
    directions come from one fused kernel launch."""
    (d_fwd, _), (d_bwd, _) = nn_bidir_sqdist_with_idx(src, tgt)
    return torch.sum(d_fwd) + torch.sum(d_bwd)


def knn_transfer_labels(query_pc: torch.Tensor, src_pc: torch.Tensor,
                        src_labels: torch.Tensor) -> torch.Tensor:
    """1-NN label transfer: the label of each query point's nearest source
    point."""
    _, idx = nearest_neighbor(query_pc, src_pc)
    return src_labels[idx]


def knn_transfer_features(query_pc: torch.Tensor, src_pc: torch.Tensor,
                          src_feat: torch.Tensor) -> torch.Tensor:
    """1-NN feature transfer."""
    _, idx = nearest_neighbor(query_pc, src_pc)
    return src_feat[idx]

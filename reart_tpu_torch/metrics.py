"""Evaluation metrics (reart_tpu/metrics.py): flow EPE/accuracy/angle,
segmentation Rand index, Chamfer errors and the model-selection energy.

Flow and segmentation metrics are float64 numpy on the host. Chamfer runs
through the bidirectional 1-NN kernel on the device; the assignment error is
the exact host solver of reart_tpu_torch/native, started from the duals of
an auction presolve on the card. Callers get python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of, to_numpy
from reart_tpu_torch.losses import group_temporal_err
from reart_tpu_torch.ops.assignment import auction_lap
from reart_tpu_torch.ops.cuda_nn import nn_bidir
from reart_tpu_torch.ops.distance import pairwise_sqdist
from reart_tpu_torch.profiling import phase_timer

# the presolve pays off from this many cost entries on; below it the cold
# exact solver is already fast
PRESOLVE_MIN_ELEMS = 1024 * 1024


def eval_flow(pred_flow_list, gt_flow_list, acc1_thre=0.05, acc2_thre=0.1):
    """EPE, Acc@acc1, Acc@acc2 (absolute or relative), mean angle error;
    NaN dot products count as angle 0."""
    pred = np.asarray(pred_flow_list, np.float64)
    gt = np.asarray(gt_flow_list, np.float64)
    error = np.sqrt(np.sum((pred - gt) ** 2, 2) + 1e-20)
    gt_len = np.sqrt(np.sum(gt * gt, 2) + 1e-20)
    acc1 = np.mean(np.mean(np.logical_or(error <= acc1_thre,
                                         error / gt_len <= acc1_thre), axis=1))
    acc2 = np.mean(np.mean(np.logical_or(error <= acc2_thre,
                                         error / gt_len <= acc2_thre), axis=1))
    epe = np.mean(error)
    with np.errstate(invalid="ignore"):
        unit_gt = gt / np.linalg.norm(gt, axis=-1, keepdims=True)
        unit_pred = pred / np.linalg.norm(pred, axis=-1, keepdims=True)
        dot = (unit_gt * unit_pred).sum(2).clip(-1 + 1e-7, 1 - 1e-7)
    dot[np.isnan(dot)] = 1.0
    angle_error = np.mean(np.arccos(dot).mean(axis=1))
    return float(epe), float(acc1), float(acc2), float(angle_error)


def eval_seg(gt_segm, pd_segm) -> float:
    """Rand index over ordered point pairs incl. self-pairs, in closed form
    from the S x S contingency table:

        agree = N^2 - (same_gt + same_pd - 2 * same_both)

    with same_both = sum C[a,b]^2 and same_gt / same_pd the squared row /
    column marginals: the integer counts of the dense N x N co-membership
    comparison at O(N + S^2) memory."""
    gt = np.asarray(gt_segm).astype(np.int64).ravel()
    pd = np.asarray(pd_segm).astype(np.int64).ravel()
    n = gt.shape[0]
    assert pd.shape[0] == n
    assert gt.min() >= 0 and pd.min() >= 0, (
        "eval_seg requires non-negative labels (bincount of gt*s+pd); "
        f"got min gt={gt.min()}, pd={pd.min()}")
    s = int(max(gt.max(), pd.max())) + 1
    c = np.bincount(gt * s + pd, minlength=s * s).reshape(s, s)
    c = c.astype(np.float64)
    same_both = float((c ** 2).sum())
    same_gt = float((c.sum(axis=1) ** 2).sum())
    same_pd = float((c.sum(axis=0) ** 2).sum())
    return float((n * n - (same_gt + same_pd - 2.0 * same_both)) / (n * n))


def _chamfer_per_cloud(p1: torch.Tensor, p2: torch.Tensor,
                       reduction: str) -> torch.Tensor:
    """Bidirectional squared-distance Chamfer over the last two axes of
    p1 (..., N, 3), p2 (..., M, 3), both directions from one launch."""
    batch = p1.shape[:-2]
    d12, _, d21, _ = nn_bidir(
        p1.reshape((-1,) + p1.shape[-2:]).contiguous(),
        p2.reshape((-1,) + p2.shape[-2:]).contiguous())
    d12, d21 = d12.reshape(batch + (-1,)), d21.reshape(batch + (-1,))
    if reduction == "mean":
        return torch.mean(d12, -1) + torch.mean(d21, -1)
    return torch.sum(d12, -1) + torch.sum(d21, -1)


def compute_chamfer(points_1, points_2, reduction: str = "sum",
                    device=None) -> float:
    """Bidirectional squared-distance Chamfer of two clouds (N, 3), (M, 3):
    tensors, or arrays moved to `device` (the card when None)."""
    dev = device_of(points_1, points_2, device=device)
    p1 = torch.as_tensor(points_1, dtype=torch.float32, device=dev)
    p2 = torch.as_tensor(points_2, dtype=torch.float32, device=dev)
    return float(_chamfer_per_cloud(p1, p2, reduction))


def _stack(points_set, dev):
    """A (T, N, 3) tensor on `dev`, or None for a ragged list of clouds."""
    if isinstance(points_set, torch.Tensor):
        return points_set.to(dev, torch.float32)
    try:
        arr = np.asarray(points_set, np.float32)
    except ValueError:
        return None
    return torch.as_tensor(arr, device=dev) if arr.ndim == 3 else None


def compute_chamfer_list(points_set1, points_set2, reduction: str = "sum",
                         device=None):
    """Per-frame Chamfer, reduced over the frames ("mean", "sum") or
    returned per frame (any other value). Frame stacks of one shape run as
    one batched k-NN launch per direction; ragged inputs keep a per-frame
    loop."""
    dev = device_of(points_set1, points_set2, device=device)
    p1, p2 = _stack(points_set1, dev), _stack(points_set2, dev)
    if p1 is not None and p2 is not None:
        cd = _chamfer_per_cloud(p1, p2, reduction).cpu().numpy()
    else:
        cd = np.asarray([compute_chamfer(a, b, reduction, device=dev)
                         for a, b in zip(points_set1, points_set2)])
    if reduction == "mean":
        return float(cd.mean())
    if reduction == "sum":
        return float(cd.sum())
    return cd


def _auction_duals(src: torch.Tensor, tgt: torch.Tensor) -> np.ndarray:
    """Near-optimal column duals (B, M) for the exact solver, from an
    auction on the euclidean costs of src (B, N, 3), tgt (B, M, 3) on their
    device."""
    cost = torch.sqrt(pairwise_sqdist(src, tgt))
    # the JAX package's schedule (reart_tpu/metrics.py): deep duals leave the
    # exact solver little augmentation work
    _, price = auction_lap(cost, eps_min=1e-6, num_scales=4,
                           scale_factor=30.0, max_sweeps=400,
                           return_price=True)
    return -price.cpu().numpy()


def compute_ass_err(pc_src_list, pc_tgt_list, device=None) -> float:
    """Mean optimal-assignment point error: per frame, the exact LAP on the
    euclidean distances, then the mean squared distance over matched pairs.
    (T, N, 3) tensors or arrays. The exact solve runs on the host; from
    PRESOLVE_MIN_ELEMS cost entries on it starts from the duals of an auction
    on the tensors' device (arrays: on `device`, the card when None). Clouds
    on the CPU skip the presolve, whose sweeps cost more there than they
    save; the exact solver then starts cold and reaches the same matching."""
    from reart_tpu_torch.native import lap_solve_points

    src = to_numpy(pc_src_list).astype(np.float32)
    tgt = to_numpy(pc_tgt_list).astype(np.float32)
    v_init = None
    if src.shape[-2] * tgt.shape[-2] >= PRESOLVE_MIN_ELEMS:
        dev = device_of(pc_src_list, pc_tgt_list, device=device)
        if dev.type != "cpu":
            with phase_timer("ass_err/presolve", verbose=False):
                v_init = _auction_duals(torch.as_tensor(src, device=dev),
                                        torch.as_tensor(tgt, device=dev))
    with phase_timer("ass_err/exact", verbose=False):
        perm = lap_solve_points(src, tgt, v_init=v_init)
    matched = np.take_along_axis(tgt, perm[..., None].astype(np.int64), axis=1)
    sq_matched = ((src - matched) ** 2).sum(-1).sum(-1)  # (T,)
    return float(sq_matched.mean() / src.shape[1])


def energy(pred_pc_list, pc_list, trans_list, joint_connection, seg_part,
           complete_pred_pc_list=None, include_group: bool = True,
           ass_scale: float | None = None, device=None):
    """Model-selection energy: robot = 100 * ass_err + screw_err +
    group_err; sapien/real = raw ass_err + screw_err without the group term
    (ass_scale=None follows include_group). Tensors, or arrays moved to
    `device` (the card when None)."""
    from reart_tpu_torch.graph import compute_screw_cost

    dev = device_of(trans_list, complete_pred_pc_list, pred_pc_list,
                    device=device)
    if ass_scale is None:
        ass_scale = 100.0 if include_group else 1.0
    ass_err = ass_scale * compute_ass_err(pred_pc_list, pc_list, device=dev)
    conn = np.asarray(joint_connection)
    screw_err = 0.0
    if conn.shape[0] > 0:
        screw_err = float(compute_screw_cost(
            torch.as_tensor(trans_list, dtype=torch.float32, device=dev),
            torch.as_tensor(conn, device=dev)))
    total = ass_err + screw_err
    parts = {"ass_err": ass_err, "screw_err": screw_err}
    if include_group:
        assert complete_pred_pc_list is not None
        seg = torch.as_tensor(seg_part, device=dev)
        group_err = float(group_temporal_err(
            torch.as_tensor(complete_pred_pc_list, dtype=torch.float32,
                            device=dev), seg, int(seg.max()) + 1))
        parts["group_err"] = group_err
        total += group_err
    parts["total_err"] = total
    return parts

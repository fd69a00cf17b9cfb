"""Command line of the port: `python -m reart_tpu_torch robot [flags]`
(reart_tpu/cli.py).

The robot relaxation run, end to end: load the sequence, build the flow
anchors from the GT clouds, fit the base model, then `finalize`: the
segmentation E-step, the graph stage (denoise, merge, MST, relabel), the
metrics, the tree edit distance against the GT graph, the selection energy
and the result files (result.txt, result.pkl, model.ckpt.pkl). Flags and
defaults are the JAX package's for the robot domain.

Everything runs on the CUDA device unless `--device cpu` asks for the plain
PyTorch versions. Tensors stay on that device; the combinatorial graph
logic is numpy on the host. Not here yet: `--model kinematic` (with IK
retargeting, snapshots, resume and the gif/html artifacts) and
`--flow_provider corr`; both raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from reart_tpu_torch import resolve_device
from reart_tpu_torch.profiling import phase_report, phase_timer


# ---------------------------------------------------------------------------
# argument surface
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="reart_tpu_torch command line")
    sub = parser.add_subparsers(dest="domain", required=True)
    _robot_args(sub.add_parser("robot"))
    return parser


def _robot_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None, type=str,
                   help="torch device; the CUDA device when not given, "
                        "'cpu' runs the plain PyTorch versions")
    p.add_argument("--manual_seed", default=2, type=int)
    p.add_argument("--cano_idx", default=0, type=int)
    p.add_argument("--num_points", default=4096, type=int)
    p.add_argument("--seq_path", default="data/robot/nao", type=str)
    p.add_argument("--start_tau", default=5.0, type=float)
    p.add_argument("--end_tau", default=1.0, type=float)
    p.add_argument("--seg_lr", default=1e-3, type=float)
    p.add_argument("--trans_lr", default=1e-2, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--n_iter", default=15000, type=int)
    p.add_argument("--assign_iter", default=5000, type=int)
    p.add_argument("--num_parts", default=20, type=int)
    p.add_argument("--model", default="base", choices=["base", "kinematic"])
    p.add_argument("--use_flow_loss", action="store_true")
    p.add_argument("--use_robust_loss", action="store_true")
    p.add_argument("--use_assign_loss", action="store_true")
    p.add_argument("--downsample", default=4, type=int)
    p.add_argument("--assign_gap", default=5, type=int)
    p.add_argument("--assign_sweeps", default=100, type=int,
                   help="auction sweep bound per epsilon phase")
    p.add_argument("--lambda_assign", default=3e-1, type=float)
    p.add_argument("--lambda_flow", default=1.0, type=float)
    p.add_argument("--lambda_joint", default=100.0, type=float)
    p.add_argument("--cano_dist_thr", default=1e-2, type=float)
    p.add_argument("--merge_thr", default=3e-2, type=float)
    p.add_argument("--merge_it", default=2, type=int)
    p.add_argument("--save_root", default="exp", type=str)
    p.add_argument("--seg_refine", default=2, type=int,
                   help="motion-consistency segmentation E-step iterations "
                        "at the end of the base stage (0 = off)")
    p.add_argument("--silence", action="store_true",
                   help="suppress per-phase prints")
    p.add_argument("--flow_provider", default="corr", choices=["corr", "gt"],
                   help="flow supervision source: the frozen corr model or "
                        "GT correspondences (robot datasets carry per-point "
                        "GT)")


def fit_config(args):
    from reart_tpu_torch.train import FitConfig

    return FitConfig(
        n_iter=args.n_iter,
        use_assign_loss=args.use_assign_loss,
        use_flow_loss=args.use_flow_loss,
        use_robust_loss=args.use_robust_loss,
        always_recon=False,  # robot: the assignment loss replaces recon
        assign_iter=args.assign_iter,
        assign_gap=args.assign_gap,
        downsample=args.downsample,
        lambda_assign=args.lambda_assign,
        lambda_flow=args.lambda_flow,
        start_tau=args.start_tau,
        end_tau=args.end_tau,
        seg_lr=args.seg_lr,
        trans_lr=args.trans_lr,
        weight_decay=args.weight_decay,
        cano_idx=args.cano_idx,
        assign_sweeps=args.assign_sweeps,
    )


# ---------------------------------------------------------------------------
# setup helpers
# ---------------------------------------------------------------------------

def load_dataset(args):
    from reart_tpu_torch.data.robot import RobotSequence

    return RobotSequence(args.seq_path, args.num_points, args.cano_idx)


def setup_flow(args, sample, device=None):
    """The FlowContext of the fit, or None without --use_flow_loss."""
    if not args.use_flow_loss:
        return None
    if args.flow_provider != "gt":
        raise NotImplementedError(
            "--flow_provider corr (the PointNet++ correspondence model and "
            "its matching) is ported in slice 3; use --flow_provider gt")
    from reart_tpu_torch.train import FlowContext

    # GT-correspondence flow anchors (per-point GT poses in the dataset)
    gt = sample["complete_gt_pc_list"]
    return FlowContext.from_lists(
        [gt[i] for i in range(gt.shape[0] - 1)],
        [gt[i + 1] - gt[i] for i in range(gt.shape[0] - 1)],
        device=resolve_device(device))


# ---------------------------------------------------------------------------
# final snapshot: graph extraction + metrics + result files
# ---------------------------------------------------------------------------

def finalize(args, domain: str, sample, seg_part, trans_list, params, state,
             save_dir: str, tau: float, device=None):
    """Everything the reference does at its last iteration, for a base
    model: seg refinement, graph stage, metrics, TED, energy, result files.

    sample: the dataset's dict of numpy arrays (`gt_edges`, where present,
    stands in for the sequence's graph.gpickle); seg_part (N,) int labels
    and trans_list (T-1, P, 4, 4) of the final forward, tensors or arrays;
    params: the fitted BaseModel. Runs on `device` (the card when None).
    Returns the dict of numbers that result.txt lists."""
    if domain != "robot":
        raise NotImplementedError(
            f"domain {domain!r}: the sapien and real runs are later slices")
    if state is not None:
        raise NotImplementedError(
            "finalize of a kinematic model (IK retargeting, fixed tree) is "
            "ported in slice 2b")
    from reart_tpu_torch import checkpoint as ckpt
    from reart_tpu_torch import metrics as M
    from reart_tpu_torch.graph import (
        compute_root_cost,
        compute_ted,
        denoise_seg_label,
        extract_kinematic,
        find_root_node,
        merging_wrapper,
        mst_wrapper,
    )
    from reart_tpu_torch.models.base_model import (
        compute_pc_transform,
        refine_seg_motion,
    )

    dev = resolve_device(device)
    quiet = args.silence

    def sub(name):
        return phase_timer(f"finalize/{name}", verbose=not quiet)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    cano_pc = tensor(sample["cano_pc"])
    pc_list = tensor(sample["pc_list"])
    trans_list = tensor(trans_list)
    seg_part = torch.as_tensor(seg_part).cpu().numpy()
    cano_idx = args.cano_idx

    # motion-consistency segmentation E-step, before the graph stage
    if args.seg_refine > 0:
        with sub("seg_refine"):
            seg_part = refine_seg_motion(
                cano_pc, pc_list, trans_list, seg_part,
                n_it=int(args.seg_refine)).cpu().numpy()

    with sub("graph"):
        seg_part = denoise_seg_label(seg_part, cano_pc, min_num=20)
        if len(np.unique(seg_part)) > 1:
            seg_part = merging_wrapper(seg_part, trans_list, cano_pc,
                                       args.merge_thr, n_it=args.merge_it)
        if len(np.unique(seg_part)) > 1:
            joint_connection = mst_wrapper(
                seg_part, trans_list, cano_pc, num_fps=20,
                cano_dist_thr=args.cano_dist_thr,
                joint_cost_weight=args.lambda_joint)
        else:  # degenerate single-part fit: rigid object, no tree
            joint_connection = np.zeros((0, 2), np.int64)
        if joint_connection.shape[0] > 0:
            seg_part, trans_list, joint_connection = extract_kinematic(
                seg_part, trans_list, joint_connection)
        else:
            lab = int(np.unique(seg_part)[0])
            seg_part = np.zeros_like(seg_part)
            trans_list = trans_list[:, lab:lab + 1]
    joint_connection_list = np.asarray(joint_connection).tolist()

    pred_pc = compute_pc_transform(cano_pc, trans_list,
                                   torch.as_tensor(seg_part, device=dev))
    complete_pred_t = torch.cat(
        [pred_pc[:cano_idx], cano_pc[None], pred_pc[cano_idx:]], 0)
    complete_pred = complete_pred_t.cpu().numpy()

    results = {}
    with sub("metrics"):
        if "gt_flow_list" in sample:
            pred_flow = complete_pred[1:] - complete_pred[:-1]
            epe, acc1, acc2, angle = M.eval_flow(
                pred_flow, sample["gt_flow_list"], 0.005, 0.01)
            results.update(flow_epe=epe * 100.0, flow_acc5=acc1,
                           flow_acc10=acc2, flow_angle=angle)
            results["seg_ri"] = M.eval_seg(sample["gt_cano_part"], seg_part)
            mse = np.sqrt(((complete_pred - sample["complete_gt_pc_list"])
                           ** 2).sum(-1)).mean(1).mean()
            results["recon_err"] = float(mse) * 100.0
        results["cd_err"] = 100.0 * M.compute_chamfer_list(
            pred_pc, pc_list, reduction="mean")

    # retargeting needs the kinematic model
    results["retarget_err"] = 9999.0

    # TED against the GT graph
    with sub("ted"):
        root_cost = compute_root_cost(trans_list).cpu().numpy()
        labels = (np.unique(joint_connection) if joint_connection_list
                  else np.array([0]))
        pred_root = int(labels[root_cost.argmin()])
        if "gt_edges" in sample:
            gt_edges = [tuple(e) for e in sample["gt_edges"]]
        else:
            from reart_tpu_torch.data.common import load_gt_graph

            _, gt_edges = load_gt_graph(args.seq_path)
        results["ted"] = compute_ted(joint_connection_list, pred_root,
                                     gt_edges, find_root_node(gt_edges))

    with sub("energy"):
        results.update(M.energy(
            pred_pc, pc_list, trans_list, joint_connection, seg_part,
            complete_pred_pc_list=complete_pred_t, include_group=True))

    with sub("save"):
        ckpt.save_result(os.path.join(save_dir, "result.pkl"), seg_part,
                         trans_list, cano_idx, joint_connection_list, sample)
        ckpt.save_checkpoint(os.path.join(save_dir, "model.ckpt.pkl"),
                             params, tau, cano_idx)

    lines = [f"{k}: {v:.3f}" for k, v in results.items()]
    with open(os.path.join(save_dir, "result.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if not quiet:
        print("\n".join(lines), flush=True)
    return results


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def run_sample(args, domain: str, sample, save_dir: str, device=None,
               noise=None):
    """Everything after dataset loading: flow anchors, the fit, the final
    forward and `finalize`. `sample` is the dataset's dict (or one made in
    memory, reart_tpu_torch/data/synth.py). `noise(it)` -> (N, P) Gumbel
    draw of iteration `it`; by default drawn on the device from
    --manual_seed. Returns finalize's results."""
    if args.model != "base":
        raise NotImplementedError(
            "--model kinematic (the projection stage and its fit) is ported "
            "in slice 2b")
    from reart_tpu_torch.models.base_model import (
        BaseModel,
        base_forward,
        gumbel_noise,
    )
    from reart_tpu_torch.train import fit_base

    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    pc_list = torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                              device=dev)
    flow_ctx = setup_flow(args, sample, dev)
    cfg = fit_config(args)

    params = BaseModel(
        args.num_parts, pc_list.shape[0], device=dev,
        generator=torch.Generator().manual_seed(args.manual_seed))
    shape = (cano_pc.shape[0], args.num_parts)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(args.manual_seed)

        def noise(_it):
            return gumbel_noise(shape, gen, dev)

    with phase_timer("fit", verbose=not args.silence):
        params, hist = fit_base(
            params, cfg, cano_pc, pc_list, flow_ctx=flow_ctx, noise=noise,
            device=dev)
        final_loss = float(hist["total_loss"][-1])
    if not args.silence:
        print(f"fit done: final total_loss {final_loss:.3f}", flush=True)

    # final forward at tau 1: the labels are the argmax of the logits and
    # the poses do not depend on the draw, so the noise is zero
    with torch.no_grad():
        _, seg_part, trans_list = base_forward(
            params, cano_pc, torch.zeros(shape, device=dev), tau=1.0)

    with phase_timer("finalize", verbose=not args.silence):
        return finalize(args, domain, sample, seg_part, trans_list, params,
                        None, save_dir, args.end_tau, device=dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.manual_seed)
    device = resolve_device(args.device)

    dataset = load_dataset(args)
    sample = dataset[0]
    seq_name = args.seq_path.rstrip("/").split("/")[-1]
    results = run_sample(args, args.domain, sample,
                         os.path.join(args.save_root, seq_name), device)
    if not args.silence:
        print(f"[phases] {phase_report()}")
    return results

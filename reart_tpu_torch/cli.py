"""Command line of the port: `python -m reart_tpu_torch robot [flags]`
(reart_tpu/cli.py).

The robot domain's two stages, end to end. `--model base` (relaxation):
load the sequence, build the flow anchors from the GT clouds, fit the base
model, then `finalize`: the segmentation E-step, the graph stage (denoise,
merge, MST, relabel), the metrics, the tree edit distance against the GT
graph, the selection energy and the result files (result.txt, result.pkl,
model.ckpt.pkl). `--model kinematic --base_result_path <result.pkl>`
(projection): build the kinematic tree and its screws from the relaxation
result, fit the kinematic model with the same loss stack, then `finalize`
on the fixed tree with the retargeting error from inverse kinematics.
`--resume` starts either stage from a model.ckpt.pkl, `--evaluate` skips
the fit. Flags and defaults are the JAX package's for the robot domain.

Everything runs on the CUDA device unless `--device cpu` asks for the plain
PyTorch versions. Tensors stay on that device; the combinatorial graph
logic is numpy on the host. Not here yet, each raising NotImplementedError:
`--flow_provider corr`, `--tree_search` other than 0 or 1, torch-format
(zip) checkpoints, and a LAP past 1024^2 with `--assign_band` other than 0
on a CUDA device. The gif/html artifacts and the mid-fit snapshot metrics
are not written.
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
    p.add_argument("--resume", type=str, nargs="+", metavar="PATH",
                   help="start from this model.ckpt.pkl (either model)")
    p.add_argument("--evaluate", action="store_true",
                   help="no fit, no energy, no result.pkl / model.ckpt.pkl")
    p.add_argument("--snapshot_gap", default=100, type=int,
                   help="iterations between the fit's progress lines")
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
    p.add_argument("--base_result_path", default=None, type=str,
                   help="the relaxation run's result.pkl, where the "
                        "kinematic stage starts")
    p.add_argument("--use_flow_loss", action="store_true")
    p.add_argument("--use_robust_loss", action="store_true")
    p.add_argument("--use_assign_loss", action="store_true")
    p.add_argument("--downsample", default=4, type=int)
    p.add_argument("--assign_gap", default=5, type=int)
    p.add_argument("--assign_sweeps", default=100, type=int,
                   help="auction sweep bound per epsilon phase")
    p.add_argument("--assign_band", default=-1, type=int,
                   help="column-window width of the banded LAP for "
                        "assignment problems past 1024^2; -1 = auto, 0 = "
                        "dense path (the only one ported: on a CUDA device "
                        "any other value raises for such a problem)")
    p.add_argument("--assign_band_guard", default=0.05, type=float)
    p.add_argument("--assign_band_reprobe", default=1000, type=int)
    p.add_argument("--lambda_assign", default=3e-1, type=float)
    p.add_argument("--lambda_flow", default=1.0, type=float)
    p.add_argument("--lambda_joint", default=100.0, type=float)
    p.add_argument("--cano_dist_thr", default=1e-2, type=float)
    p.add_argument("--merge_thr", default=3e-2, type=float)
    p.add_argument("--merge_it", default=2, type=int)
    p.add_argument("--save_root", default="exp", type=str)
    p.add_argument("--tree_search", default=-1, type=int,
                   help="kinematic stage: energy-scored sweep over the MST "
                        "and its edge-swap neighbours (-1 = auto); only 0 "
                        "or 1 (off) is ported, any other value raises")
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
        assign_band=args.assign_band,
        assign_band_guard=args.assign_band_guard,
        assign_band_reprobe=args.assign_band_reprobe,
    )


# ---------------------------------------------------------------------------
# setup helpers
# ---------------------------------------------------------------------------

def load_dataset(args):
    from reart_tpu_torch.data.robot import RobotSequence

    return RobotSequence(args.seq_path, args.num_points, args.cano_idx)


# what inverse kinematics reads off the dataset object in the JAX package;
# here it rides in the sample and stays out of result.pkl
IK_KEYS = ("pose_list", "cano_idx", "novel_pose_list")


def dataset_sample(dataset) -> dict:
    """The sequence's sample with the dataset's poses beside it."""
    return dict(dataset[0], pose_list=dataset.pose_list,
                cano_idx=dataset.cano_idx,
                novel_pose_list=dataset.novel_pose_list)


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
# kinematic model construction
# ---------------------------------------------------------------------------

def kinematic_from_tree(args, domain: str, cano_pc, seg_part, trans_list,
                        joint_connection, pad_depth=None, device=None):
    """Labels, poses and a tree -> (KinematicModel, KinematicState): the
    relabelling, the child-to-parent DAG and the screws of its edges. The
    robot domain builds a revolute-only model."""
    if domain != "robot":
        raise NotImplementedError(
            f"domain {domain!r}: the sapien and real runs are later slices")
    from reart_tpu_torch.graph import build_graph, extract_kinematic
    from reart_tpu_torch.models.kinematic import (
        KinematicModel,
        make_kinematic_state,
    )

    dev = resolve_device(device)
    trans_list = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    new_seg, new_trans, new_conn = extract_kinematic(
        seg_part, trans_list, joint_connection)
    edges, root, axis, moment, theta, _ = build_graph(
        new_conn, new_trans, revolute_only=True)
    state = make_kinematic_state(new_seg, cano_pc, edges, root,
                                 pad_depth=pad_depth, device=dev)
    params = KinematicModel(new_trans.shape[0], state.num_edges,
                            axis_list=axis, moment_list=moment,
                            theta_list=theta, device=dev)
    return params, state


def build_kinematic_from_result(args, domain: str, cano_pc, result: dict,
                                device=None):
    """The relaxation result -> (KinematicModel, KinematicState). A tree
    stored in the result is used as stored; else the parts are merged and
    the MST is built here."""
    from reart_tpu_torch.graph import merging_wrapper, mst_wrapper

    if args.tree_search not in (0, 1):
        raise NotImplementedError(
            f"--tree_search {args.tree_search}: the energy-scored tree "
            f"search is ported in slice 5; pass --tree_search 0")
    if args.cano_idx != result["cano_idx"]:
        raise ValueError(f"--cano_idx {args.cano_idx} is not the result's "
                         f"cano_idx {result['cano_idx']}")
    dev = resolve_device(device)
    cano_pc = torch.as_tensor(cano_pc, dtype=torch.float32, device=dev)
    seg_part = np.asarray(result["pred_cano_part"])
    trans_list = torch.as_tensor(np.asarray(result["pred_pose_list"]),
                                 dtype=torch.float32, device=dev)
    stored = np.asarray(result.get("joint_connection", ()), dtype=np.int64)
    if stored.size:
        joint_connection = stored
    else:
        seg_part = merging_wrapper(seg_part, trans_list, cano_pc,
                                   args.merge_thr)
        joint_connection = mst_wrapper(
            seg_part, trans_list, cano_pc, num_fps=20,
            cano_dist_thr=args.cano_dist_thr,
            joint_cost_weight=args.lambda_joint)
    return kinematic_from_tree(args, domain, cano_pc, seg_part, trans_list,
                               joint_connection, device=dev)


# ---------------------------------------------------------------------------
# final snapshot: graph extraction + metrics + result files
# ---------------------------------------------------------------------------

def finalize(args, domain: str, sample, seg_part, trans_list, params, state,
             save_dir: str, tau: float, device=None):
    """Everything the reference does at its last iteration: seg refinement,
    graph stage, metrics, retargeting, TED, energy, result files.

    sample: the dataset's dict of numpy arrays (`gt_edges`, where present,
    stands in for the sequence's graph.gpickle; IK_KEYS for the retargeting
    error); seg_part (N,) int labels and trans_list (T-1, P, 4, 4) of the
    final forward, tensors or arrays; params: the fitted BaseModel, or the
    KinematicModel with its `state`. A kinematic model keeps its labels and
    its tree (no seg refinement, no merge, no MST) and gets `retarget_err`
    from inverse kinematics. With --evaluate there is no energy and only
    result.txt is written. Runs on `device` (the card when None). Returns
    the dict of numbers that result.txt lists."""
    if domain != "robot":
        raise NotImplementedError(
            f"domain {domain!r}: the sapien and real runs are later slices")
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
    is_kinematic = state is not None

    # motion-consistency segmentation E-step, before the graph stage
    if not is_kinematic and args.seg_refine > 0:
        with sub("seg_refine"):
            seg_part = refine_seg_motion(
                cano_pc, pc_list, trans_list, seg_part,
                n_it=int(args.seg_refine)).cpu().numpy()

    with sub("graph"):
        seg_part = denoise_seg_label(seg_part, cano_pc, min_num=20)
        if not is_kinematic and len(np.unique(seg_part)) > 1:
            seg_part = merging_wrapper(seg_part, trans_list, cano_pc,
                                       args.merge_thr, n_it=args.merge_it)
        if is_kinematic:
            joint_connection = np.asarray([list(e) for e in state.edges])
        elif len(np.unique(seg_part)) > 1:
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
    if is_kinematic:
        from reart_tpu_torch.ik import ik

        with sub("ik"):
            results["retarget_err"] = ik(sample, "kinematic", params,
                                         state=state, tau=tau)
    else:
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

    if not args.evaluate:
        with sub("energy"):
            results.update(M.energy(
                pred_pc, pc_list, trans_list, joint_connection, seg_part,
                complete_pred_pc_list=complete_pred_t, include_group=True))

        with sub("save"):
            ckpt.save_result(
                os.path.join(save_dir, "result.pkl"), seg_part, trans_list,
                cano_idx, joint_connection_list,
                {k: v for k, v in sample.items() if k not in IK_KEYS})
            ckpt.save_checkpoint(os.path.join(save_dir, "model.ckpt.pkl"),
                                 params, tau, cano_idx, state=state)

    lines = [f"{k}: {v:.3f}" for k, v in results.items()]
    with open(os.path.join(save_dir, "result.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if not quiet:
        print("\n".join(lines), flush=True)
    return results


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _load_model(args, cano_pc, pose_len: int, dev):
    """(params, state, tau) at the start of the run: a fresh BaseModel, the
    kinematic model built from --base_result_path, or either model from
    the pickle checkpoint --resume names (state is None for a base model)."""
    from reart_tpu_torch import checkpoint as ckpt
    from reart_tpu_torch.models.base_model import BaseModel

    payload = None
    if args.resume:
        with open(args.resume[0], "rb") as f:
            if f.read(2) == b"PK":  # torch.save's zip container
                raise NotImplementedError(
                    f"--resume {args.resume[0]}: torch-format checkpoints "
                    f"are ported in slice 5; resume from a model.ckpt.pkl")
        payload = ckpt.load_checkpoint(args.resume[0])
    if args.model == "base":
        if payload is not None:
            return (ckpt.base_model_from_checkpoint(payload, device=dev),
                    None, payload["tau"])
        params = BaseModel(
            args.num_parts, pose_len, device=dev,
            generator=torch.Generator().manual_seed(args.manual_seed))
        return params, None, args.end_tau
    if payload is not None:
        params, state = ckpt.kinematic_model_from_checkpoint(payload,
                                                             device=dev)
        return params, state, payload.get("tau", args.end_tau)
    if args.base_result_path is None:
        raise ValueError("--model kinematic needs --base_result_path (the "
                         "relaxation run's result.pkl) or --resume")
    params, state = build_kinematic_from_result(
        args, "robot", cano_pc, ckpt.load_result(args.base_result_path),
        device=dev)
    return params, state, args.end_tau


def run_sample(args, domain: str, sample, save_dir: str, device=None,
               noise=None):
    """Everything after dataset loading: flow anchors, the model, the fit,
    the final forward and `finalize`. `sample` is the dataset's dict with
    its poses (`dataset_sample`, or one made in memory,
    reart_tpu_torch/data/synth.py). `noise(it)` -> (N, P) Gumbel draw of
    iteration `it` of the base fit; by default drawn on the device from
    --manual_seed. The fit leaves its resume file (`fit_state.pkl`) in
    `save_dir` while it runs. Returns finalize's results."""
    from reart_tpu_torch.models.base_model import base_forward, gumbel_noise
    from reart_tpu_torch.models.kinematic import kinematic_forward
    from reart_tpu_torch.train import fit_base, fit_kinematic

    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    pc_list = torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                              device=dev)
    flow_ctx = setup_flow(args, sample, dev)
    cfg = fit_config(args)
    params, state, tau = _load_model(args, cano_pc, pc_list.shape[0], dev)
    shape = (cano_pc.shape[0], args.num_parts)

    if not args.evaluate:
        fit_kw = dict(flow_ctx=flow_ctx, device=dev, checkpoint_dir=save_dir,
                      log_every=None if args.silence else args.snapshot_gap)
        with phase_timer("fit", verbose=not args.silence):
            if state is None:
                if noise is None:
                    gen = torch.Generator(device=dev).manual_seed(
                        args.manual_seed)

                    def noise(_it):
                        return gumbel_noise(shape, gen, dev)

                params, hist = fit_base(params, cfg, cano_pc, pc_list,
                                        noise=noise, **fit_kw)
            else:
                params, hist = fit_kinematic(params, state, cfg, pc_list,
                                             **fit_kw)
            final_loss = float(hist["total_loss"][-1])
        if not args.silence:
            print(f"fit done: final total_loss {final_loss:.3f}", flush=True)
        tau = args.end_tau

    # final forward at tau 1: the labels are the argmax of the logits and
    # the poses do not depend on the draw, so the noise is zero
    with torch.no_grad():
        if state is None:
            _, seg_part, trans_list = base_forward(
                params, cano_pc, torch.zeros(shape, device=dev), tau=1.0)
        else:
            _, seg_part, trans_list = kinematic_forward(params, state,
                                                        cano_pc)

    with phase_timer("finalize", verbose=not args.silence):
        return finalize(args, domain, sample, seg_part, trans_list, params,
                        state, save_dir, tau, device=dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.manual_seed)
    device = resolve_device(args.device)

    sample = dataset_sample(load_dataset(args))
    seq_name = args.seq_path.rstrip("/").split("/")[-1]
    results = run_sample(args, args.domain, sample,
                         os.path.join(args.save_root, seq_name), device)
    if not args.silence:
        print(f"[phases] {phase_report()}")
    return results

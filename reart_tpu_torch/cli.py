"""Command line of the port: `python -m reart_tpu_torch {robot,sapien,real}
[flags]` and `python -m reart_tpu_torch corr [flags]` (reart_tpu/cli.py).

`corr` trains the correspondence backbone (PointNet++ MSG) on synthetic
rigid-part deformations of a sequence's own frames (`--data_domain robot`,
`sapien` or `real`) and saves a checkpoint for `--corr_model_path`.

Each domain runs two stages. `--model base` (relaxation): load the
sequence, build the flow anchors, fit the base model, then `finalize`: the
segmentation E-step, the graph stage (denoise, merge, MST, relabel), the
metrics, the selection energy and the result files (result.txt,
result.pkl, model.ckpt.pkl). `--model kinematic --base_result_path
<result.pkl>` (projection): build the kinematic tree and its screws from
the relaxation result, fit the kinematic model with the same loss stack,
then `finalize` on the fixed tree. `--resume` starts either stage from a
model.ckpt.pkl, `--evaluate` skips the fit. Flags and per-domain defaults
are the JAX package's.

  * robot: flow from the correspondence model's SMNN matches on clouds
    normalised by `--normalize_file` (`--flow_provider corr`) or from the
    GT clouds (`gt`); the assignment loss replaces recon after assign_iter;
    revolute joints; TED against the GT graph; the retargeting error of the
    kinematic model by inverse kinematics.
  * sapien (an mbs-sapien scene, `--sapien_idx`): flow from `--flow_file`
    or the external msync nets (`--flow_provider msync`), or the
    correspondence model (`corr`, clouds in the unit ball); recon always
    on; poses aligned to the root part for merging, the MST and the joints,
    prismatic joints and a root trajectory; the full-flow error between
    every pair of views and per- and multi-scan RI; at `--downsample 1` a
    4096^2 LAP, which takes the banded solve on the card.
  * real (a directory of mesh scans, no GT): flow from the correspondence
    model on clouds normalised by the canonical mesh; recon always on;
    prismatic joints allowed; the Chamfer error and the energy.

Everything runs on the CUDA device unless `--device cpu` asks for the plain
PyTorch versions. Tensors stay on that device; the combinatorial graph
logic is numpy on the host. Not here yet, each raising NotImplementedError
that names slice 5: `--tree_search` other than 0 or 1, `--batch_seq`,
`--auto_cano`, `--snapshot_metrics` / `--snapshot_graph`, `--save_vis`
and torch-format (zip) checkpoints. The gif/html artifacts are not written.
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
    for domain in ("robot", "sapien", "real"):
        _common_args(sub.add_parser(domain), domain)
    _corr_args(sub.add_parser(
        "corr", help="train the correspondence backbone on a sequence's "
                     "own frames"))
    return parser


def _corr_args(p: argparse.ArgumentParser):
    """`corr`: train PointNet2Msg2 features on synthetic rigid-part
    deformations of a sequence's own frames (train/corr.py), producing a
    checkpoint for --flow_provider corr / --corr_model_path."""
    p.add_argument("--device", default=None, type=str,
                   help="torch device; the CUDA device when not given, "
                        "'cpu' runs the plain PyTorch versions")
    p.add_argument("--manual_seed", default=2, type=int)
    p.add_argument("--data_domain", default="robot",
                   choices=["robot", "real", "sapien"],
                   help="which dataset loader and normalisation to use")
    p.add_argument("--seq_path", default=["data/robot/nao"], type=str,
                   nargs="+", help="one or more sequences (category-level "
                                   "training pools their frames)")
    p.add_argument("--num_points", default=4096, type=int)
    p.add_argument("--cano_idx", default=0, type=int)
    p.add_argument("--normalize_file",
                   default="data/category_normalize_scale.pkl", type=str)
    p.add_argument("--sapien_base_folder", default="data/mbs-sapien",
                   type=str)
    p.add_argument("--sapien_idx", default=[212], type=int, nargs="+")
    p.add_argument("--save_path", default="corr_model.pkl", type=str)
    p.add_argument("--save_torch", default=None, type=str,
                   help="also export the torch-format checkpoint (the "
                        "released model's state_dict keys)")
    p.add_argument("--steps", default=2000, type=int)
    p.add_argument("--batch", default=4, type=int)
    p.add_argument("--train_points", default=1024, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--temperature", default=0.07, type=float)
    p.add_argument("--max_angle", default=0.6, type=float)
    p.add_argument("--k_parts", default=8, type=int)
    p.add_argument("--dispatch_chunk", default=50, type=int,
                   help="steps between progress lines (and, times 10, "
                        "between checkpoint rewrites)")
    p.add_argument("--resample", default=1, type=int, choices=[0, 1],
                   help="train on independently subsampled src/tgt clouds "
                        "with radius-gated NN positives; 0 restores the "
                        "identity-correspondence recipe")
    p.add_argument("--pos_radius", default=0.02, type=float,
                   help="resampled recipe: max distance (normalised units) "
                        "from a point's true transformed position to its "
                        "nearest tgt point for the pair to be a positive")
    p.add_argument("--neg_radius", default=0.05, type=float,
                   help="resampled recipe: tgt points inside this radius of "
                        "the true position are left out of the negatives")
    p.add_argument("--bf16", action="store_true",
                   help="backbone matrix products in bfloat16 (autocast; "
                        "float32 weights, optimizer and BatchNorm moments)")
    p.add_argument("--train_checkpoint", default=None, type=str,
                   help="mid-run checkpoint file: training resumes from it "
                        "if it exists and rewrites it as it goes")
    p.add_argument("--self_finetune_steps", default=0, type=int,
                   help="after training, fine-tune on the sequence's own "
                        "consecutive frame pairs with mined SMNN "
                        "pseudo-labels; 0 disables")
    p.add_argument("--self_finetune_th", default=0.9, type=float,
                   help="SMNN ratio threshold for pseudo-label mining")
    p.add_argument("--self_finetune_rounds", default=3, type=int,
                   help="re-mine pseudo-labels this many times")
    p.add_argument("--self_finetune_real_frac", default=0.5, type=float,
                   help="share of a fine-tune batch drawn from real pairs")
    p.add_argument("--self_finetune_refine_k", default=0, type=int,
                   help="local-rigid-refine each mining round's targets "
                        "over this many matched neighbours; 0 keeps the "
                        "raw discrete targets")


def _common_args(p: argparse.ArgumentParser, domain: str):
    """The flags of a domain's run, with the JAX package's per-domain
    defaults."""
    robot = domain == "robot"
    p.add_argument("--device", default=None, type=str,
                   help="torch device; the CUDA device when not given, "
                        "'cpu' runs the plain PyTorch versions")
    p.add_argument("--manual_seed", default=2, type=int)
    p.add_argument("--resume", type=str, nargs="+", metavar="PATH",
                   help="start from this model.ckpt.pkl (either model)")
    p.add_argument("--evaluate", action="store_true",
                   help="no fit, no energy, no result.pkl / model.ckpt.pkl")
    p.add_argument("--snapshot_gap", default=100 if robot else 10, type=int,
                   help="iterations between the fit's progress lines")
    p.add_argument("--cano_idx", default=0, type=int)
    p.add_argument("--num_points", default=4096, type=int)
    p.add_argument("--seq_path", default={
        "robot": "data/robot/nao", "sapien": "", "real": "data/real/toy",
    }[domain], type=str)
    p.add_argument("--start_tau", default=5.0 if robot else 1.0, type=float)
    p.add_argument("--end_tau", default=1.0, type=float)
    p.add_argument("--seg_lr", default=1e-3, type=float)
    p.add_argument("--trans_lr", default=1e-2, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--n_iter", default=15000 if robot else 2000, type=int)
    p.add_argument("--assign_iter", default=5000 if robot else 1000,
                   type=int)
    p.add_argument("--num_parts", default=20 if robot else 10, type=int)
    p.add_argument("--model", default="base", choices=["base", "kinematic"])
    p.add_argument("--base_result_path", default=None, type=str,
                   help="the relaxation run's result.pkl, where the "
                        "kinematic stage starts")
    p.add_argument("--use_flow_loss", action="store_true")
    p.add_argument("--use_robust_loss", action="store_true")
    p.add_argument("--use_assign_loss", action="store_true")
    p.add_argument("--downsample", default=4 if domain != "sapien" else 1,
                   type=int)
    p.add_argument("--assign_gap", default=5, type=int)
    p.add_argument("--assign_sweeps", default=100, type=int,
                   help="auction sweep bound per epsilon phase")
    p.add_argument("--assign_band", default=-1, type=int,
                   help="column-window width of the banded LAP for "
                        "assignment problems past 1024^2 on the card; -1 = "
                        "auto (n//4 clamped to [512, 1024]), 0 = dense path")
    p.add_argument("--assign_band_guard", default=0.05, type=float,
                   help="auto band: solve the first assignment problem "
                        "banded and dense and fall back to dense when the "
                        "banded matched cost is worse by more than this "
                        "fraction (0 disables)")
    p.add_argument("--assign_band_reprobe", default=1000, type=int,
                   help="re-run the guard's probe every this many "
                        "assignment-phase iterations (0 = only at the phase "
                        "start)")
    p.add_argument("--lambda_assign", default=3e-1, type=float)
    p.add_argument("--lambda_flow", default=1.0, type=float)
    p.add_argument("--lambda_joint", default=100.0 if robot else 1e-1,
                   type=float)
    p.add_argument("--cano_dist_thr", default=1e-2, type=float)
    p.add_argument("--merge_thr", default=3e-2, type=float)
    p.add_argument("--merge_it", default=2 if robot else 3, type=int)
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
    for flag in ("--auto_cano", "--snapshot_metrics", "--snapshot_graph",
                 "--save_vis"):
        p.add_argument(flag, action="store_true",
                       help="ported in slice 5: raises")
    if robot:
        p.add_argument("--normalize_file",
                       default="data/category_normalize_scale.pkl", type=str,
                       help="pickle {sequence name: {centroid, scale}}: the "
                            "cloud normalisation of the corr model")
    p.add_argument("--match_th", default=0.9, type=float,
                   help="SMNN ratio-test threshold of the corr-model "
                        "matching")
    p.add_argument("--match_disp_gate", default=0.0, type=float,
                   help="if > 0, drop matches whose displacement exceeds "
                        "median + this * MAD per frame pair")
    p.add_argument("--match_refine_k", default=0, type=int,
                   help="if > 0, replace each match's discrete target with "
                        "the prediction of a trimmed local rigid fit over "
                        "its k nearest matched anchors")
    p.add_argument("--match_chain_r", default=0.0, type=float,
                   help="if > 0, cycle-consistent chaining over frame "
                        "triples with this closure radius (normalised "
                        "units)")
    p.add_argument("--corr_model_path",
                   default="pretrained/corr_model.pth.tar", type=str)
    if domain == "sapien":
        p.add_argument("--sapien_base_folder", default="data/mbs-sapien",
                       type=str)
        p.add_argument("--sapien_idx", default=212, type=int)
        p.add_argument("--flow_provider", default="msync",
                       choices=["msync", "corr"],
                       help="flow supervision source: --flow_file or the "
                            "external msync nets, or the correspondence "
                            "model (e.g. one `corr --data_domain sapien` "
                            "trained)")
        p.add_argument("--batch_seq", default=None, type=str,
                       help="ported in slice 5: raises")
        p.add_argument("--flow_file", default=None, type=str,
                       help="precomputed flow .npz: flow (T-1, N, 3), conf "
                            "(T-1, N); anchors where conf > 0.5")
        p.add_argument("--flow_model_config_path", type=str,
                       default="msync/config/articulated-full.yaml",
                       help="msync config, used without --flow_file")
        p.add_argument("--flow_model_path", type=str,
                       default="msync/ckpt/articulated-full/best.pth.tar",
                       help="msync FlowNet/ConfNet checkpoint")
    else:
        p.add_argument("--flow_provider", default="corr",
                       choices=["corr", "gt"],
                       help="flow supervision source: the frozen corr model "
                            "or GT correspondences (robot datasets carry "
                            "per-point GT; elsewhere gt means corr)")


def fit_config(args, domain: str | None = None):
    from reart_tpu_torch.train import FitConfig

    domain = domain or args.domain
    return FitConfig(
        n_iter=args.n_iter,
        use_assign_loss=args.use_assign_loss,
        use_flow_loss=args.use_flow_loss,
        use_robust_loss=args.use_robust_loss,
        # robot: the assignment loss replaces recon; elsewhere recon stays
        always_recon=domain != "robot",
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

def load_dataset(args, domain: str | None = None):
    domain = domain or args.domain
    if domain == "sapien":
        from reart_tpu_torch.data.sapien import SapienDataset

        return SapienDataset(args.sapien_base_folder, args.cano_idx)
    if domain == "real":
        from reart_tpu_torch.data.real import RealSequence

        return RealSequence(args.seq_path, args.num_points, args.cano_idx)
    from reart_tpu_torch.data.robot import RobotSequence

    return RobotSequence(args.seq_path, args.num_points, args.cano_idx)


# what inverse kinematics reads off the dataset object in the JAX package;
# here it rides in the sample and stays out of result.pkl
IK_KEYS = ("pose_list", "cano_idx", "novel_pose_list")
# every key that rides beside the dataset's sample: also the real
# dataset's (centroid, scale) from its canonical mesh
SIDE_KEYS = IK_KEYS + ("normalize",)


def dataset_sample(dataset, idx: int = 0) -> dict:
    """Sample `idx` of the dataset with what the run reads off the dataset
    object beside it: a robot sequence's poses, a real sequence's
    normalisation."""
    from reart_tpu_torch.data.real import RealSequence
    from reart_tpu_torch.data.robot import RobotSequence

    sample = dict(dataset[idx])
    if isinstance(dataset, RobotSequence):
        sample.update(pose_list=dataset.pose_list, cano_idx=dataset.cano_idx,
                      novel_pose_list=dataset.novel_pose_list)
    elif isinstance(dataset, RealSequence):
        sample["normalize"] = (dataset.centroid, float(dataset.scale))
    return sample


def corr_normalization(args, domain: str, sample: dict | None = None,
                       seq_path: str | None = None):
    """(centroid, scale) of the clouds the correspondence extractor sees:
    one convention for training (run_train_corr) and inference
    (setup_flow). robot: the entry of --normalize_file under the
    sequence's directory name; real: the canonical mesh's (the sample's
    `normalize`); sapien: the unit ball of the sample's clouds."""
    if domain == "robot":
        from reart_tpu_torch.data.common import load_normalize_dict

        cat = (seq_path or args.seq_path).rstrip("/").split("/")[-1]
        info = load_normalize_dict(args.normalize_file)[cat]
        return info["centroid"], float(info["scale"])
    if domain == "real":
        centroid, scale = sample["normalize"]
        return centroid, float(scale)
    flat = np.asarray(sample["complete_pc_list"], np.float32).reshape(-1, 3)
    centroid = flat.mean(0)
    radius = float(np.linalg.norm(flat - centroid, axis=-1).max())
    return centroid, 1.0 / max(radius, 1e-6)


def setup_flow(args, sample, device=None, domain: str | None = None):
    """The FlowContext of the fit, or None without --use_flow_loss."""
    if not args.use_flow_loss:
        return None
    from reart_tpu_torch.train import FlowContext

    domain = domain or args.domain
    dev = resolve_device(device)
    complete = sample["complete_pc_list"]
    if domain == "sapien" and args.flow_provider != "corr":
        # precomputed (or msync) flows anchor every source point whose
        # confidence passes 0.5 with its predicted flow
        from reart_tpu_torch.sapien_eval import (
            compute_flow_msync,
            load_precomputed_flow,
        )

        if args.flow_file is not None:
            flow, conf = load_precomputed_flow(args.flow_file)
        else:
            flow, conf = compute_flow_msync(
                complete, args.flow_model_config_path, args.flow_model_path)
        keep = [conf[t] > 0.5 for t in range(flow.shape[0])]
        return FlowContext.from_lists(
            [complete[t][k] for t, k in enumerate(keep)],
            [flow[t][k] for t, k in enumerate(keep)], device=dev)
    if domain == "robot" and args.flow_provider == "gt":
        # GT-correspondence flow anchors (per-point GT poses in the dataset)
        gt = sample["complete_gt_pc_list"]
        return FlowContext.from_lists(
            [gt[i] for i in range(gt.shape[0] - 1)],
            [gt[i + 1] - gt[i] for i in range(gt.shape[0] - 1)], device=dev)

    # the frozen corr model and SMNN matching
    from reart_tpu_torch.flow import build_flow_context
    from reart_tpu_torch.models.pointnet2 import load_corr_model

    model = load_corr_model(args.corr_model_path, device=dev)
    centroid, scale = corr_normalization(args, domain, sample)
    return build_flow_context(
        complete, model, centroid=centroid, scale=scale,
        matching="smnn", th=args.match_th, disp_gate=args.match_disp_gate,
        rigid_refine_k=args.match_refine_k, chain_r=args.match_chain_r,
        device=dev)


# ---------------------------------------------------------------------------
# the corr trainer
# ---------------------------------------------------------------------------

def _corr_training_frames(args):
    """The normalised training frames of one or more sequences (the corr
    model is category-level, so `corr` pools the frames of every
    --seq_path, or of every --sapien_idx), each sequence normalised as
    setup_flow will normalise it at fit time. Returns (frames (F, N, 3),
    frames per sequence)."""
    import copy

    from reart_tpu_torch.flow import normalize_pc_list

    domain = args.data_domain
    if domain == "sapien":
        dataset = load_dataset(args, "sapien")
        samples = [(dataset[idx], None) for idx in args.sapien_idx]
    else:
        samples = []
        for sp in args.seq_path:
            sub = copy.copy(args)
            sub.seq_path = sp
            samples.append((dataset_sample(load_dataset(sub, domain)), sp))
    blocks = []
    for sample, sp in samples:
        complete = np.asarray(sample["complete_pc_list"], np.float32)
        centroid, scale = corr_normalization(args, domain, sample, sp)
        blocks.append(normalize_pc_list(
            complete, np.asarray(centroid, np.float32), np.float32(scale)))
    n_min = min(b.shape[1] for b in blocks)
    rng = np.random.RandomState(args.manual_seed)
    blocks = [b if b.shape[1] == n_min
              else b[:, rng.choice(b.shape[1], n_min, replace=False)]
              for b in blocks]
    return np.concatenate(blocks, axis=0), [b.shape[0] for b in blocks]


def run_train_corr(args, device=None):
    """`corr`: train the correspondence backbone on the sequences' own
    frames (train/corr.py), report its matching on a held-out synthetic
    pair and on the real consecutive frames, and save a --corr_model_path
    checkpoint. Returns the numbers it prints."""
    import time

    from reart_tpu_torch.flow import compute_corr_masks
    from reart_tpu_torch.models.pointnet2 import (
        save_corr_model,
        save_corr_model_torch,
    )
    from reart_tpu_torch.train.corr import (
        CorrTrainConfig,
        draw_pairs,
        finetune_real_pairs,
        match_precision,
        synth_pair,
        train_corr,
    )

    dev = resolve_device(device)
    frames, block_sizes = _corr_training_frames(args)
    cfg = CorrTrainConfig(
        steps=args.steps, batch=args.batch,
        n_points=min(args.train_points, frames.shape[1]),
        k_parts=args.k_parts, max_angle=args.max_angle,
        temperature=args.temperature, lr=args.lr,
        dispatch_chunk=args.dispatch_chunk,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        resample=bool(args.resample), pos_radius=args.pos_radius,
        neg_radius=args.neg_radius)
    print(f"training corr backbone: {frames.shape[0]} frames x "
          f"{frames.shape[1]} pts, {cfg.steps} steps x batch {cfg.batch} "
          f"@ {cfg.n_points} pts", flush=True)
    t0 = time.perf_counter()
    model, losses = train_corr(
        args.manual_seed, frames, cfg, device=dev,
        checkpoint_path=args.train_checkpoint,
        log_fn=lambda s, l: print(f"  step {s}/{cfg.steps} loss {l:.3f}",
                                  flush=True))
    train_seconds = time.perf_counter() - t0  # log_fn's read-backs wait

    if args.self_finetune_steps > 0:
        print(f"self-finetune on real consecutive pairs: "
              f"{args.self_finetune_steps} steps, "
              f"{args.self_finetune_rounds} mining rounds "
              f"(th {args.self_finetune_th}, real_frac "
              f"{args.self_finetune_real_frac})", flush=True)
        model, ft_losses = finetune_real_pairs(
            args.manual_seed + 777, model, frames, cfg,
            steps=args.self_finetune_steps, mine_th=args.self_finetune_th,
            rounds=args.self_finetune_rounds,
            real_frac=args.self_finetune_real_frac,
            refine_k=args.self_finetune_refine_k, device=dev,
            log_fn=lambda r, m: print(
                f"  mining round {r}: {m:.3f} of points pseudo-labeled",
                flush=True))
        losses = np.concatenate([losses, ft_losses])

    # a held-out synthetic pair through the inference path (running
    # statistics + SMNN); correct means within pos_radius of gt_pos, which
    # holds for the identity and the resampled recipe alike
    frames_t = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    held_out = draw_pairs(torch.Generator(device=dev).manual_seed(10_007),
                          frames.shape[0], frames.shape[1], cfg, batch=1)
    src, tgt, gt_pos, s = synth_pair(held_out, frames_t, cfg)
    prec, rate = match_precision(model, src[0], tgt[0], gt_pos=gt_pos[0],
                                 pos_radius=cfg.pos_radius * float(s[0]))
    print(f"final loss {losses[-1]:.3f}; held-out synthetic pair: "
          f"SMNN precision {prec:.3f}, match rate {rate:.3f}", flush=True)

    # the matching on the real consecutive frames, which the fit will
    # consume. Pooled sequences are one array: a pair that straddles a
    # sequence boundary is two unrelated clouds and is left out.
    _, valid = compute_corr_masks(frames_t, model)
    valid = valid.cpu().numpy()
    boundaries = set(np.cumsum(block_sizes)[:-1] - 1)  # pair t = (t, t+1)
    keep = [t for t in range(valid.shape[0]) if t not in boundaries]
    real_rate = float(valid[keep].mean()) if keep else float("nan")
    print(f"real frame pairs: SMNN match rate {real_rate:.3f} "
          f"({len(keep)} consecutive pairs)", flush=True)

    save_corr_model(args.save_path, model)
    if args.save_torch:
        save_corr_model_torch(args.save_torch, model)
        print(f"saved torch-format checkpoint {args.save_torch}")
    print(f"saved {args.save_path} (use: {args.data_domain} --flow_provider "
          f"corr --corr_model_path {args.save_path})", flush=True)
    return {"loss": float(losses[-1]), "first_loss": float(losses[0]),
            "losses": np.asarray(losses), "precision": prec, "match_rate": rate,
            "real_match_rate": real_rate, "train_seconds": train_seconds,
            "save_path": args.save_path}


# ---------------------------------------------------------------------------
# kinematic model construction
# ---------------------------------------------------------------------------

def _root_aligned(seg_part, trans_list):
    """Poses relative to the root part, the part with the most points:
    what the sapien and real runs merge, span and type joints on."""
    from reart_tpu_torch.sapien_eval import compute_align_trans

    root_part = int(np.bincount(np.asarray(seg_part)).argmax())
    return compute_align_trans(trans_list, trans_list[:, root_part])


def kinematic_from_tree(args, domain: str, cano_pc, seg_part, trans_list,
                        joint_connection, pad_depth=None, device=None):
    """Labels, poses and a tree -> (KinematicModel, KinematicState): the
    relabelling, the child-to-parent DAG and the screws of its edges. The
    robot domain builds a revolute-only model; the others type each joint
    (revolute or prismatic) on the poses aligned to the root part, the part
    with the most points, and give the model that part's trajectory."""
    from reart_tpu_torch.graph import build_graph, extract_kinematic
    from reart_tpu_torch.models.kinematic import (
        KinematicModel,
        make_kinematic_state,
    )

    dev = resolve_device(device)
    trans_list = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    new_seg, new_trans, new_conn = extract_kinematic(
        seg_part, trans_list, joint_connection)
    if domain == "robot":
        edges, root, axis, moment, theta, _ = build_graph(
            new_conn, new_trans, revolute_only=True)
        state = make_kinematic_state(new_seg, cano_pc, edges, root,
                                     pad_depth=pad_depth, device=dev)
        params = KinematicModel(new_trans.shape[0], state.num_edges,
                                axis_list=axis, moment_list=moment,
                                theta_list=theta, device=dev)
        return params, state
    root_part = int(np.bincount(np.asarray(new_seg)).argmax())
    root_trans = new_trans[:, root_part]
    (edges, root, axis, moment, theta, distance, _,
     joint_types) = build_graph(new_conn, _root_aligned(new_seg, new_trans),
                                revolute_only=False, root_part=root_part,
                                return_joint_type=True)
    state = make_kinematic_state(new_seg, cano_pc, edges, root,
                                 joint_types=joint_types, has_root_trans=True,
                                 pad_depth=pad_depth, device=dev)
    params = KinematicModel(new_trans.shape[0], state.num_edges,
                            axis_list=axis, moment_list=moment,
                            theta_list=theta, distance_list=distance,
                            root_trans=root_trans, device=dev)
    return params, state


def build_kinematic_from_result(args, domain: str, cano_pc, result: dict,
                                device=None):
    """The relaxation result -> (KinematicModel, KinematicState). A tree
    stored in the result is used as stored; else the parts are merged and
    the MST is built here (on root-aligned poses off the robot domain)."""
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

    def aligned(seg):
        return (trans_list if domain == "robot"
                else _root_aligned(seg, trans_list))

    stored = np.asarray(result.get("joint_connection", ()), dtype=np.int64)
    if stored.size:
        joint_connection = stored
    else:
        seg_part = merging_wrapper(seg_part, aligned(seg_part), cano_pc,
                                   args.merge_thr)
        joint_connection = mst_wrapper(
            seg_part, aligned(seg_part), cano_pc, num_fps=20,
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

    sample: the dataset's dict of numpy arrays with what rides beside it
    (`dataset_sample`: a robot sequence's IK_KEYS for the retargeting
    error; `gt_edges`, where present, stands in for the sequence's
    graph.gpickle); seg_part (N,) int labels and trans_list (T-1, P, 4, 4)
    of the final forward, tensors or arrays; params: the fitted BaseModel,
    or the KinematicModel with its `state`. A kinematic model keeps its
    labels and its tree (no seg refinement, no merge, no MST). Off the robot
    domain, merging and the MST read poses aligned to the root part, the
    errors are in the data's units, sapien adds the full-flow error and the
    per- and multi-scan RI, and there is no retargeting, no TED and no group
    term in the energy. With --evaluate there is no energy and only
    result.txt is written. Runs on `device` (the card when None). Returns
    the dict of numbers that result.txt lists."""
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
    robot = domain == "robot"

    def sub(name):
        return phase_timer(f"finalize/{name}", verbose=not quiet)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def aligned(trans):
        return trans if robot else _root_aligned(seg_part, trans)

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
            seg_part = merging_wrapper(seg_part, aligned(trans_list), cano_pc,
                                       args.merge_thr, n_it=args.merge_it)
        if is_kinematic:
            joint_connection = np.asarray([list(e) for e in state.edges])
        elif len(np.unique(seg_part)) > 1:
            joint_connection = mst_wrapper(
                seg_part, aligned(trans_list), cano_pc, num_fps=20,
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
    unit = 100.0 if robot else 1.0  # robot errors in cm
    with sub("metrics"):
        if "gt_flow_list" in sample:
            if robot:
                pred_flow = complete_pred[1:] - complete_pred[:-1]
                epe, acc1, acc2, angle = M.eval_flow(
                    pred_flow, sample["gt_flow_list"], 0.005, 0.01)
                results.update(flow_epe=epe * 100.0, flow_acc5=acc1,
                               flow_acc10=acc2, flow_angle=angle)
            results["seg_ri"] = M.eval_seg(sample["gt_cano_part"], seg_part)
            mse = np.sqrt(((complete_pred - sample["complete_gt_pc_list"])
                           ** 2).sum(-1)).mean(1).mean()
            results["recon_err"] = float(mse) * unit
        results["cd_err"] = unit * M.compute_chamfer_list(
            pred_pc, pc_list, reduction="mean")

    if domain == "sapien" and "gt_full_flow" in sample:
        from reart_tpu_torch.sapien_eval import (
            compute_full_flow,
            eval_full_flow,
            seg_propagation_list,
        )

        with sub("sapien_eval"):
            seg_list = seg_propagation_list(pc_list, pred_pc, seg_part)
            eye = torch.eye(4, device=dev).expand(1, trans_list.shape[1], 4,
                                                  4)
            complete_trans = torch.cat(
                [trans_list[:cano_idx], eye, trans_list[cano_idx:]], 0)
            complete_seg = np.concatenate(
                [seg_list[:cano_idx], seg_part[None], seg_list[cano_idx:]], 0)
            full_flow = compute_full_flow(sample["complete_pc_list"],
                                          complete_seg, complete_trans,
                                          device=dev)
            results["full_flow_epe"] = 100.0 * eval_full_flow(
                full_flow, sample["gt_full_flow"])
            gt_parts = sample["complete_gt_part_list"]
            results["per_scan_ri"] = float(np.mean(
                [M.eval_seg(g, p) for g, p in zip(gt_parts, complete_seg)]))
            results["multi_scan_ri"] = M.eval_seg(gt_parts.reshape(-1),
                                                  complete_seg.reshape(-1))

    if robot:
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
                complete_pred_pc_list=complete_pred_t, include_group=robot))

        with sub("save"):
            ckpt.save_result(
                os.path.join(save_dir, "result.pkl"), seg_part, trans_list,
                cano_idx, joint_connection_list,
                {k: v for k, v in sample.items() if k not in SIDE_KEYS})
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
        args, args.domain, cano_pc, ckpt.load_result(args.base_result_path),
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

    _not_ported_flags(args)
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    pc_list = torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                              device=dev)
    flow_ctx = setup_flow(args, sample, dev, domain)
    cfg = fit_config(args, domain)
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


def _not_ported_flags(args) -> None:
    """Raise for a flag whose feature is ported in slice 5."""
    on = [f"--{k}" for k in ("auto_cano", "snapshot_metrics",
                             "snapshot_graph", "save_vis", "batch_seq")
          if getattr(args, k, None)]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: ported in slice 5 (canonical-frame "
            f"selection, mid-fit snapshots, artifacts, batched sequences)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.manual_seed)
    device = resolve_device(args.device)
    if args.domain == "corr":
        return run_train_corr(args, device)

    _not_ported_flags(args)
    sapien = args.domain == "sapien"
    idx = args.sapien_idx if sapien else 0
    sample = dataset_sample(load_dataset(args), idx)
    seq_name = str(idx) if sapien else args.seq_path.rstrip("/").split("/")[-1]
    results = run_sample(args, args.domain, sample,
                         os.path.join(args.save_root, seq_name), device)
    if not args.silence:
        print(f"[phases] {phase_report()}")
    return results

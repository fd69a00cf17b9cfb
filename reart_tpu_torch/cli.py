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

The projection stage's tree comes from a sweep (`tree_search_build`): the
MST and its cheapest edge-swap neighbours, each short-fitted and scored by
its energy plus a fabricated-displacement veto, or by held-out frames
(`--tree_select holdout`); by default (`--tree_search -1`) only when the MST
is locally ambiguous. `--auto_cano` picks the canonical frame first by a
short relaxation fit per frame (selection.py).

`sapien --batch_seq i,j,k` fits the relaxation stage of several sequences
as one rows fit (parallel/rows.py), then finalizes each into
`<save_root>/<idx>/`. `--snapshot_metrics` adds a metric row of the live
fit every `--snapshot_gap` iterations to result.txt (`--snapshot_graph`
also the graph stage and the energy), `--trace_dir` writes a torch.profiler
trace of the fit (of the training, on `corr`), and `--resume` takes the
reference's torch-format (zip) checkpoints too. Beside the trace
(`<host>_<pid>.<ms>.pt.trace.json.gz`) `--trace_dir` writes `spans.json`
(profiling.py): the program's spans (`fit.iteration`, `fit.lap.solve`,
`corr.step`, `bn`, ...) with their ids, parents, threads and the `ts` /
`dur` of their annotations in the trace, the counters (`fit.iterations`,
`lap.solves.<route>`, `lap.sweeps`, `lap.rows_at_bound`, `corr.steps`)
and the kernel wrappers' launches over the traced region.

Every run writes the JAX package's artifacts beside its result files:
`input.gif` of the observed sequence before the fit; after it
`recon.gif`, `gt.gif` (where the sample has GT), `seg.html` and
`structure.html`, and on a robot's projection run `novel_<k>.html` of each
retargeted pose (viz.py: numpy and PIL only). `--save_vis` is accepted and
changes nothing, as in the JAX package.

Everything runs on the CUDA device unless `--device cpu` asks for the plain
PyTorch versions. Tensors stay on that device; the combinatorial graph
logic and the artifacts are numpy on the host.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os

import numpy as np
import torch

from reart_tpu_torch import device_of, resolve_device, to_numpy
from reart_tpu_torch.profiling import device_trace, phase_report, phase_timer


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
    p.add_argument("--trace_dir", default=None, type=str,
                   help="write a torch.profiler trace of the training here "
                        "(Chrome trace; the card's kernels on a CUDA run) "
                        "and spans.json beside it")
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
                   help="kinematic stage: short-fit the greedy MST and its "
                        "K-1 cheapest edge-swap spanning-tree neighbours "
                        "and keep the best-scored tree; -1 = auto "
                        "[default]: K=8, but only the swaps whose local "
                        "cost delta is within --tree_search_margin of the "
                        "median edge cost (the stored tree always joins); "
                        "0/1 = off, the MST or the stored tree as it is")
    p.add_argument("--tree_search_iter", default=100, type=int,
                   help="per-candidate short-fit iterations")
    p.add_argument("--tree_search_margin", default=0.5, type=float,
                   help="auto mode ambiguity gate: sweep only candidates "
                        "whose swap delta <= margin * median finite "
                        "inter-part edge cost")
    p.add_argument("--tree_select", default="energy",
                   choices=["energy", "holdout"],
                   help="tree-search ranking: 'energy' = fit energy + "
                        "fabricated-displacement veto; 'holdout' = fit "
                        "each candidate on a frame subset, freeze its "
                        "screws and score reconstruction on the held-out "
                        "frames")
    p.add_argument("--auto_cano", action="store_true",
                   help="select the canonical frame by a short-fit energy "
                        "sweep over every frame before the relaxation fit")
    p.add_argument("--auto_cano_iters", default=None, type=int,
                   help="selection-fit iterations (default max(100, "
                        "n_iter // 10))")
    p.add_argument("--seg_refine", default=2, type=int,
                   help="motion-consistency segmentation E-step iterations "
                        "at the end of the base stage (0 = off)")
    p.add_argument("--silence", action="store_true",
                   help="suppress per-phase prints")
    # the JAX package's command-line surface: accepted, no effect here
    p.add_argument("--use_nproc", action="store_true",
                   help="no-op (reference: multiprocessing Hungarian pool)")
    p.add_argument("--use_cuda", default=1, type=int, help="no-op")
    p.add_argument("--snapshot_metrics", action="store_true",
                   help="evaluate flow/seg/recon metrics on the live fit "
                        "every --snapshot_gap iterations (the reference's "
                        "mid-fit snapshot block), on a copy of the "
                        "parameters in a worker thread; rows land in "
                        "result.txt")
    p.add_argument("--snapshot_graph", action="store_true",
                   help="with --snapshot_metrics (implied), also the graph "
                        "stage (denoise, merge, MST) and the selection "
                        "energy of each snapshot")
    p.add_argument("--save_vis", action="store_true",
                   help="accepted for the reference's command lines; the "
                        "artifacts are always written")
    p.add_argument("--trace_dir", default=None, type=str,
                   help="write a torch.profiler trace of the fit here "
                        "(Chrome trace; the card's kernels on a CUDA run)")
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
                       help="comma-separated sequence indices: fit their "
                            "relaxation stages as one batch (base model, "
                            "train only; '{idx}' in --flow_file is "
                            "formatted per sequence)")
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
    trace = (device_trace(args.trace_dir, cuda=dev.type == "cuda")
             if args.trace_dir else contextlib.nullcontext())
    with trace:
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
                steps=args.self_finetune_steps,
                mine_th=args.self_finetune_th,
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
                                pc_list=None, cfg=None, flow_ctx=None,
                                device=None):
    """The relaxation result -> (KinematicModel, KinematicState). Without a
    tree stored in the result the parts are merged first. With
    --tree_search -1 or K > 1, the observed clouds `pc_list` (T-1, N, 3),
    the fit config `cfg` and more than two parts, the tree comes from
    `tree_search_build` (the stored tree one of its candidates) and the
    model from the winner's short fit; else the stored tree is used as
    stored, or the MST is built here (on root-aligned poses off the robot
    domain)."""
    from reart_tpu_torch.graph import merging_wrapper, mst_wrapper

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
    stored = stored if stored.size else None
    if stored is None:  # a stored tree comes with merged parts
        seg_part = merging_wrapper(seg_part, aligned(seg_part), cano_pc,
                                   args.merge_thr)

    ts = args.tree_search
    if ((ts > 1 or ts < 0) and pc_list is not None
            and len(np.unique(seg_part)) > 2):  # more than one spanning tree
        return tree_search_build(
            args, domain, cano_pc, seg_part, trans_list,
            torch.as_tensor(pc_list, dtype=torch.float32, device=dev), cfg,
            flow_ctx, stored_tree=stored, device=dev)

    if stored is not None:
        joint_connection = stored
    else:
        joint_connection = mst_wrapper(
            seg_part, aligned(seg_part), cano_pc, num_fps=20,
            cano_dist_thr=args.cano_dist_thr,
            joint_cost_weight=args.lambda_joint)
    return kinematic_from_tree(args, domain, cano_pc, seg_part, trans_list,
                               joint_connection, device=dev)


def _axis_excess(fitted, state, cano_pc, seg, return_detail: bool = False):
    """Mean normalised distance beyond the object's radius of each fitted
    revolute axis from its child part's centroid: 0.0 when every axis
    passes within the object's bounding radius. Prismatic edges are exempt
    (their axis is a direction). float64 numpy on the host; `fitted` is
    the KinematicModel (or anything with its axis_list, moment_list and
    theta_list), `state` the KinematicState (its prismatic_mask and edges).

    With return_detail also one record per scored revolute edge:
    (edge_index, child, excess, theta_amp), theta_amp the fitted angle's
    range over the frames, the canonical frame's implicit 0 included. The
    product excess * theta_amp is the displacement a far axis fabricates:
    what separates a translation typed as a rotation about a far axis from
    the harmless ill-conditioned axis of a barely moving joint."""
    axis = to_numpy(fitted.axis_list).astype(np.float64)
    moment = to_numpy(fitted.moment_list).astype(np.float64)
    theta = to_numpy(fitted.theta_list).astype(np.float64)
    pris = (np.zeros(len(axis), bool) if state.prismatic_mask is None
            else to_numpy(state.prismatic_mask).astype(bool))
    pts = to_numpy(cano_pc).astype(np.float64)
    center = pts.mean(0)
    r_obj = float(np.linalg.norm(pts - center, axis=-1).max())
    seg = to_numpy(seg)
    exc, detail = [], []
    for e, (child, _parent) in enumerate(np.asarray(state.edges)):
        if pris[e]:
            continue
        l_vec = axis[e]
        nl = float(np.linalg.norm(l_vec))
        if nl < 1e-8:
            continue
        l_unit = l_vec / nl
        p0 = np.cross(l_unit, moment[e] / nl)  # the axis point nearest 0
        mask = seg == child
        c = pts[mask].mean(0) if mask.any() else center
        d = float(np.linalg.norm(np.cross(l_unit, c - p0)))
        e_exc = max(0.0, d - r_obj) / max(r_obj, 1e-9)
        exc.append(e_exc)
        detail.append((e, int(child), e_exc,
                       float(np.ptp(np.append(theta[:, e], 0.0)))))
    mean = float(np.mean(exc)) if exc else 0.0
    return (mean, detail) if return_detail else mean


def tree_search_build(args, domain: str, cano_pc, seg_part, trans_list,
                      pc_list, cfg, flow_ctx, stored_tree=None, device=None):
    """Energy-scored kinematic-tree selection (--tree_search).

    The candidates are the greedy MST and its K-1 cheapest 1-edge-swap
    spanning-tree neighbours (graph.tree_candidates; K = --tree_search, 8
    in auto mode), on root-aligned poses off the robot domain. In auto
    mode (-1) a swap stays only if its local cost delta is at most
    --tree_search_margin x the median finite inter-part edge cost. A stored
    tree that is not among them is put first. With one candidate this is
    the plain build. Otherwise each candidate is built at one path depth
    (P-1), short-fitted for --tree_search_iter iterations with the run's
    flow, and scored: the selection energy of its prediction plus the
    largest fabricated displacement of its axes (_axis_excess), or under
    --tree_select holdout the held-out-frame score alone
    (selection.holdout_score). The first of equal scores wins; the winner
    is rebuilt at its own depth and returned with its short fit's
    parameters, where the full fit starts."""
    from reart_tpu_torch import metrics as M
    from reart_tpu_torch.graph import mst_wrapper, tree_candidates
    from reart_tpu_torch.models.kinematic import kinematic_forward
    from reart_tpu_torch.selection import holdout_score
    from reart_tpu_torch.train import fit_kinematic

    dev = resolve_device(device)
    graph_trans = (trans_list if domain == "robot"
                   else _root_aligned(seg_part, trans_list))
    _, cost, uni = mst_wrapper(
        seg_part, graph_trans, cano_pc, num_fps=20,
        cano_dist_thr=args.cano_dist_thr,
        joint_cost_weight=args.lambda_joint, return_cost=True)
    ts = args.tree_search
    k = ts if ts > 1 else 8  # -1 = auto mode sweeps K=8
    cands, deltas = tree_candidates(cost, uni, k=k, return_deltas=True)
    if ts < 0:  # auto: gate on the MST's local ambiguity
        off = cost[~np.eye(cost.shape[0], dtype=bool)]
        finite = off[np.isfinite(off)]
        typical = float(np.median(finite)) if finite.size else 0.0
        margin = args.tree_search_margin
        keep = [i for i, d in enumerate(deltas) if d <= margin * typical]
        if len(keep) < len(cands):
            print(f"tree_search auto: {len(cands) - len(keep)}/"
                  f"{len(cands) - 1} swaps above the ambiguity margin "
                  f"({margin:g} x median edge cost {typical:.4f}) — "
                  f"sweeping {len(keep)} candidate(s)", flush=True)
        cands = [cands[i] for i in keep]
        deltas = [deltas[i] for i in keep]
    if stored_tree is not None and not any(
            np.array_equal(np.sort(c, axis=1), np.sort(stored_tree, axis=1))
            for c in cands):
        cands = [stored_tree] + cands[: max(k - 1, 1)]
        deltas = [float("nan")] + deltas[: max(k - 1, 1)]

    if len(cands) == 1:  # the MST is locally unambiguous: no sweep
        return kinematic_from_tree(args, domain, cano_pc, seg_part,
                                   trans_list, cands[0], device=dev)

    pad_depth = max(len(np.unique(seg_part)) - 1, 1)
    short_cfg = dataclasses.replace(cfg, n_iter=args.tree_search_iter)
    best = None
    with phase_timer("tree_search", verbose=not args.silence):
        for ci, cand in enumerate(cands):
            params_i, state_i = kinematic_from_tree(
                args, domain, cano_pc, seg_part, trans_list, cand,
                pad_depth=pad_depth, device=dev)
            holdout = None
            if args.tree_select == "holdout":
                # from the candidate's initial model, which the short fit
                # below trains in place
                holdout = holdout_score(params_i, state_i, short_cfg,
                                        cano_pc, pc_list)
            fitted, _ = fit_kinematic(params_i, state_i, short_cfg, pc_list,
                                      flow_ctx=flow_ctx, device=dev)
            with torch.no_grad():
                pred_pc, seg_i, trans_i = kinematic_forward(fitted, state_i,
                                                            cano_pc)
            complete_pred = torch.cat(
                [pred_pc[: args.cano_idx], cano_pc[None],
                 pred_pc[args.cano_idx:]], 0)
            conn = np.asarray([list(e) for e in state_i.edges])
            energy = M.energy(pred_pc, pc_list, trans_i, conn,
                              seg_i.cpu().numpy(),
                              complete_pred_pc_list=complete_pred,
                              include_group=domain == "robot")
            # a candidate can undercut the true tree's energy by typing a
            # relative translation as a revolute joint about a far axis;
            # the largest fabricated displacement over its edges vetoes it
            _, exc_detail = _axis_excess(fitted, state_i, cano_pc, seg_i,
                                         return_detail=True)
            fabricated = max((e_exc * th_amp for _, _, e_exc, th_amp
                              in exc_detail), default=0.0)
            score = (holdout if holdout is not None
                     else energy["total_err"] + fabricated)
            print(f"tree_search candidate {ci}: total_err "
                  f"{energy['total_err']:.4f}"
                  + (f" fabricated {fabricated:.3f}" if fabricated else "")
                  + (f" holdout {holdout:.5f}" if holdout is not None
                     else "")
                  + f" local_delta {deltas[ci]:.4f} edges {conn.tolist()}",
                  flush=True)
            if best is None or score < best[0]:
                best = (score, ci, fitted, cand, energy["total_err"])

    _, ci, fitted, cand, err = best
    print(f"tree_search: selected candidate {ci} (total_err {err:.4f})",
          flush=True)
    # the winner at its own path depth (the parameters do not depend on
    # it); the full fit starts from its short fit
    _, state = kinematic_from_tree(args, domain, cano_pc, seg_part,
                                   trans_list, cand, device=dev)
    return fitted, state


# ---------------------------------------------------------------------------
# mid-fit snapshots (the reference's snapshot block every snapshot_gap
# iterations: the raw-argmax labels' metrics, and with --snapshot_graph the
# graph stage and the energy)
# ---------------------------------------------------------------------------

def snapshot_metrics_row(domain: str, sample, cano_idx: int, seg_part,
                         trans_list, device=None) -> dict:
    """One mid-fit metric row of the current forward's labels (N,) and
    poses (T-1, P, 4, 4): flow EPE / accuracies / angle (robot), RI, the
    reconstruction error and the Chamfer error, in finalize's units. Runs
    on the device of trans_list (for arrays: `device`, the card when
    None)."""
    from reart_tpu_torch import metrics as M
    from reart_tpu_torch.models.base_model import compute_pc_transform

    dev = device_of(trans_list, device=device)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    trans = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    seg = to_numpy(seg_part)
    pred = compute_pc_transform(cano_pc, trans,
                                torch.as_tensor(seg, device=dev))
    complete_pred = torch.cat([pred[:cano_idx], cano_pc[None],
                               pred[cano_idx:]], 0).cpu().numpy()
    robot = domain == "robot"
    unit = 100.0 if robot else 1.0
    row = {}
    if robot and "gt_flow_list" in sample:
        epe, acc1, acc2, angle = M.eval_flow(
            complete_pred[1:] - complete_pred[:-1], sample["gt_flow_list"],
            0.005, 0.01)
        row.update(flow_epe=epe * 100.0, flow_acc5=acc1, flow_acc10=acc2,
                   flow_angle=angle)
    if "gt_cano_part" in sample:
        row["seg_ri"] = M.eval_seg(sample["gt_cano_part"], seg)
    if "complete_gt_pc_list" in sample:
        mse = np.sqrt(((complete_pred - sample["complete_gt_pc_list"]) ** 2
                       ).sum(-1)).mean(1).mean()
        row["recon_err"] = float(mse) * unit
    row["cd_err"] = M.compute_chamfer_list(
        pred, torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                              device=dev), reduction="mean") * unit
    return row


def snapshot_graph_row(args, domain: str, sample, seg_part,
                       trans_list, device=None) -> dict:
    """The snapshot's graph stage and energy: denoise, merge, the MST (on
    root-aligned poses off the robot domain) and the relabelled tree's
    selection energy. One row: part count, edge list, energy terms."""
    from reart_tpu_torch import metrics as M
    from reart_tpu_torch.graph import (
        denoise_seg_label,
        extract_kinematic,
        merging_wrapper,
        mst_wrapper,
    )
    from reart_tpu_torch.models.base_model import compute_pc_transform

    dev = device_of(trans_list, device=device)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    trans = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    cano_idx = args.cano_idx
    robot = domain == "robot"
    seg = to_numpy(seg_part)

    def aligned(tr):  # on the labels of the moment
        return tr if robot else _root_aligned(seg, tr)

    seg = denoise_seg_label(seg, cano_pc, min_num=20)
    if len(np.unique(seg)) > 1:
        seg = merging_wrapper(seg, aligned(trans), cano_pc, args.merge_thr,
                              n_it=args.merge_it)
    if len(np.unique(seg)) > 1:
        conn = np.asarray(mst_wrapper(
            seg, aligned(trans), cano_pc, num_fps=20,
            cano_dist_thr=args.cano_dist_thr,
            joint_cost_weight=args.lambda_joint))
    else:
        conn = np.zeros((0, 2), np.int64)
    if conn.shape[0] > 0:
        seg, trans, conn = extract_kinematic(seg, trans, conn)
    else:
        lab = int(np.unique(seg)[0])
        seg = np.zeros_like(seg)
        trans = trans[:, lab:lab + 1]
    pred = compute_pc_transform(cano_pc, trans,
                                torch.as_tensor(seg, device=dev))
    complete_pred = torch.cat([pred[:cano_idx], cano_pc[None],
                               pred[cano_idx:]], 0)
    e = M.energy(pred, torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                                       device=dev),
                 trans, conn, seg, complete_pred_pc_list=complete_pred,
                 include_group=robot)
    row = {"parts": len(np.unique(seg)), "edges": np.asarray(conn).tolist()}
    row.update({k: float(v) for k, v in e.items()})
    return row


class SnapshotEvaluator:
    """Mid-fit metric rows off the fit's path. `callback(done, model)` is
    engine.fit's snapshot_cb: it copies the model (parameters detached; the
    fit goes on training its own) and queues the copy; a worker thread on
    the run's device runs `forward_of(copy)` -> (labels, poses) and
    snapshot_metrics_row (with `graph_args`, --snapshot_graph: also
    snapshot_graph_row) and keeps `snapshot N | k: v | ...` rows for
    result.txt. The fit's parameters and history do not depend on it. A
    row that fails stops the rows, and `finish()` raises its error."""

    def __init__(self, domain, sample, cano_idx, forward_of, graph_args=None,
                 device=None):
        import queue
        import threading

        self.rows = []
        self._q = queue.Queue()
        self._error = None
        self._domain, self._sample = domain, sample
        self._cano_idx, self._forward_of = cano_idx, forward_of
        self._graph_args = graph_args
        self._dev = resolve_device(device)
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def callback(self, done, model):
        import copy

        clone = copy.deepcopy(model)
        for p in clone.parameters():
            p.grad = None
            p.requires_grad_(False)
        self._q.put((done, clone))

    @staticmethod
    def _fmt(v):
        return f"{v:.3f}" if isinstance(v, float) else str(v)

    def _row(self, done, model):
        seg, trans = self._forward_of(model)
        row = snapshot_metrics_row(self._domain, self._sample, self._cano_idx,
                                   seg, trans)
        if self._graph_args is not None:
            row.update(snapshot_graph_row(self._graph_args, self._domain,
                                          self._sample, seg, trans))
        msg = " | ".join(f"{k}: {self._fmt(v)}" for k, v in row.items())
        self.rows.append(f"snapshot {done} | {msg}")
        print(f"[snapshot {done}] {msg}", flush=True)

    def _work(self):
        import contextlib

        on_card = (torch.cuda.device(self._dev) if self._dev.type == "cuda"
                   else contextlib.nullcontext())
        with on_card, torch.no_grad():
            while True:
                item = self._q.get()
                if item is None:
                    return
                if self._error is None:
                    try:
                        self._row(*item)
                    except BaseException as e:  # raised again by finish()
                        self._error = e

    def finish(self) -> list:
        """Wait for the queued rows; returns them, or raises the error of
        the first row that failed."""
        self._q.put(None)
        self._t.join()
        if self._error is not None:
            raise self._error
        return self.rows


# ---------------------------------------------------------------------------
# final snapshot: graph extraction + metrics + result files
# ---------------------------------------------------------------------------

def finalize(args, domain: str, sample, seg_part, trans_list, params, state,
             save_dir: str, tau: float, device=None, snapshot_rows=None):
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
    term in the energy. With --evaluate there is no energy, no result.pkl
    and no checkpoint. `snapshot_rows` (SnapshotEvaluator.finish) follow
    the numbers in result.txt. The artifacts follow (stage "viz", with
    --evaluate too): recon.gif of the reconstruction, gt.gif where the
    sample has GT flow, seg.html and structure.html. Runs on `device` (the
    card when None). Returns the dict of numbers that result.txt lists."""
    from reart_tpu_torch import checkpoint as ckpt
    from reart_tpu_torch import metrics as M
    from reart_tpu_torch import viz
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
    has_gt = "gt_flow_list" in sample
    with sub("metrics"):
        if has_gt:
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
                                             state=state, tau=tau,
                                             save_dir=save_dir, save_vis=True)
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

    with sub("viz"):
        cano_np = cano_pc.cpu().numpy()
        viz.vis_pc_seq(complete_pred, pred_part=seg_part, name="reconstruct",
                       save_path=os.path.join(save_dir, "recon.gif"))
        if has_gt:
            viz.vis_pc_seq(sample["complete_gt_pc_list"],
                           pred_part=sample["gt_cano_part"], name="gt",
                           save_path=os.path.join(save_dir, "gt.gif"))
            viz.vis_pc(cano_np, seg_part, gt_part=sample["gt_cano_part"],
                       save_path=os.path.join(save_dir, "seg.html"))
        else:
            viz.vis_pc(cano_np, seg_part,
                       save_path=os.path.join(save_dir, "seg.html"))
        viz.vis_structure(cano_np, seg_part, joint_connection_list,
                          save_path=os.path.join(save_dir, "structure.html"))

    lines = [f"{k}: {v:.3f}" for k, v in results.items()]
    if snapshot_rows:
        lines.extend(["", "# mid-fit snapshots (--snapshot_metrics)"]
                     + list(snapshot_rows))
    with open(os.path.join(save_dir, "result.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if not quiet:
        print("\n".join(lines), flush=True)
    return results


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _load_model(args, cano_pc, pc_list, cfg, flow_ctx, dev):
    """(params, state, tau) at the start of the run: a fresh BaseModel, the
    kinematic model built from --base_result_path (with the tree search,
    which short-fits on pc_list with cfg and flow_ctx), or either model
    from the checkpoint --resume names, a model.ckpt.pkl or the
    reference's torch-format file (state is None for a base model)."""
    from reart_tpu_torch import checkpoint as ckpt
    from reart_tpu_torch.models.base_model import BaseModel

    payload = None
    if args.resume:
        path = args.resume[0]
        if ckpt.is_torch_checkpoint(path):  # the reference's torch.save
            if args.model == "base":
                params, tau, ck_cano = ckpt.load_torch_base(path, device=dev)
                state = None
            else:
                params, state, tau, ck_cano = ckpt.load_torch_kinematic(
                    path, device=dev)
            if ck_cano != args.cano_idx:
                raise ValueError(f"--resume {path}: checkpoint cano_idx "
                                 f"{ck_cano} is not --cano_idx "
                                 f"{args.cano_idx}")
            return params, state, tau
        payload = ckpt.load_checkpoint(path)
    if args.model == "base":
        if payload is not None:
            return (ckpt.base_model_from_checkpoint(payload, device=dev),
                    None, payload["tau"])
        params = BaseModel(
            args.num_parts, pc_list.shape[0], device=dev,
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
        pc_list=pc_list, cfg=cfg, flow_ctx=flow_ctx, device=dev)
    return params, state, args.end_tau


def run_sample(args, domain: str, sample, save_dir: str, device=None,
               noise=None):
    """Everything after dataset loading: flow anchors, the model, the fit,
    the final forward and `finalize`. `sample` is the dataset's dict with
    its poses (`dataset_sample`, or one made in memory,
    reart_tpu_torch/data/synth.py). `noise(it)` -> (N, P) Gumbel draw of
    iteration `it` of the base fit; by default drawn on the device from
    --manual_seed. The fit leaves its resume file (`fit_state.pkl`) in
    `save_dir` while it runs. The kinematic stage's tree search runs here;
    --auto_cano is `main`'s, which picks the canonical frame before it
    loads the sample, and so is input.gif (`write_input_gif`). Returns
    finalize's results."""
    from reart_tpu_torch.models.base_model import gumbel_noise
    from reart_tpu_torch.train import fit_base, fit_kinematic

    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    cano_pc = torch.as_tensor(sample["cano_pc"], dtype=torch.float32,
                              device=dev)
    pc_list = torch.as_tensor(sample["pc_list"], dtype=torch.float32,
                              device=dev)
    flow_ctx = setup_flow(args, sample, dev, domain)
    cfg = fit_config(args, domain)
    params, state, tau = _load_model(args, cano_pc, pc_list, cfg, flow_ctx,
                                     dev)
    shape = (cano_pc.shape[0], args.num_parts)

    snapshots = None
    if not args.evaluate:
        fit_kw = dict(flow_ctx=flow_ctx, device=dev, checkpoint_dir=save_dir,
                      log_every=None if args.silence else args.snapshot_gap)
        if args.snapshot_metrics or args.snapshot_graph:
            snapshots = SnapshotEvaluator(
                domain, sample, args.cano_idx,
                functools.partial(_final_forward, state=state,
                                  cano_pc=cano_pc, shape=shape),
                graph_args=args if args.snapshot_graph else None, device=dev)
            fit_kw.update(snapshot_cb=snapshots.callback,
                          snapshot_every=args.snapshot_gap)
        trace = (device_trace(args.trace_dir, cuda=dev.type == "cuda")
                 if args.trace_dir else contextlib.nullcontext())
        with trace, phase_timer("fit", verbose=not args.silence):
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

    with torch.no_grad():
        seg_part, trans_list = _final_forward(params, state, cano_pc, shape)
    rows = snapshots.finish() if snapshots is not None else None

    with phase_timer("finalize", verbose=not args.silence):
        return finalize(args, domain, sample, seg_part, trans_list, params,
                        state, save_dir, tau, device=dev, snapshot_rows=rows)


def _final_forward(params, state, cano_pc, shape):
    """(labels (N,), poses (T-1, P, 4, 4)) of a model: the relaxation
    forward at tau 1, where the labels are the logits' argmax and the poses
    do not depend on the draw (so the noise is zero), or the kinematic
    forward on its state."""
    from reart_tpu_torch.models.base_model import base_forward
    from reart_tpu_torch.models.kinematic import kinematic_forward

    if state is None:
        _, seg, trans = base_forward(
            params, cano_pc, torch.zeros(shape, device=cano_pc.device), 1.0)
    else:
        _, seg, trans = kinematic_forward(params, state, cano_pc)
    return seg, trans


def write_input_gif(sample, save_dir: str) -> None:
    """`<save_dir>/input.gif` of the sample's observed frames
    (`complete_pc_list`), which every run writes before its fit; creates
    save_dir."""
    from reart_tpu_torch import viz

    os.makedirs(save_dir, exist_ok=True)
    viz.vis_pc_seq(sample["complete_pc_list"], name="input",
                   save_path=os.path.join(save_dir, "input.gif"))


def _stack_flow_contexts(ctxs):
    """Per-sequence FlowContexts -> one with (B, T-1, M, 3) leaves, each
    padded to the common M with FAR points and zero flow (the padding of
    FlowContext.from_lists); None if any sequence has none."""
    from reart_tpu_torch.train import FlowContext
    from reart_tpu_torch.train.engine import FAR

    if any(c is None for c in ctxs):
        return None
    m = max(int(c.pc_ref.shape[1]) for c in ctxs)

    def pad(x, value):
        fill = x.new_full((x.shape[0], m - x.shape[1], 3), value)
        return torch.cat([x, fill], dim=1)

    return FlowContext(torch.stack([pad(c.pc_ref, FAR) for c in ctxs]),
                       torch.stack([pad(c.flow_ref, 0.0) for c in ctxs]))


def run_batch_seq(args, dataset, device=None):
    """`sapien --batch_seq i,j,k`: the relaxation stage of several sequences
    (one shape) as one rows fit on the device (parallel.fit_base_sequences,
    under phase "fit"), then each sequence's finalize into
    `<save_root>/<idx>/` (phase "finalize/<idx>", after the sequence's
    input.gif, phase "input_gif/<idx>"). Each sequence has its
    own flow anchors, `{idx}` in --flow_file formatted with its index. The
    rows fit has no band guard, no resume and no snapshots. Returns the
    finalize results, one a sequence."""
    import copy

    from reart_tpu_torch.parallel import fit_base_sequences

    if args.model != "base" or args.evaluate:
        raise ValueError("--batch_seq fits base-model relaxations (no "
                         "--model kinematic, no --evaluate)")
    if args.resume or args.snapshot_metrics or args.snapshot_graph:
        raise ValueError("--batch_seq takes no --resume and no snapshots")
    dev = resolve_device(device)
    idxs = [int(i) for i in args.batch_seq.split(",")]
    samples = [dataset_sample(dataset, i) for i in idxs]
    cano_b = np.stack([np.asarray(s["cano_pc"], np.float32)
                       for s in samples])
    pc_b = np.stack([np.asarray(s["pc_list"], np.float32) for s in samples])
    flow_b = None
    if args.use_flow_loss:
        ctxs = []
        for i, sample in zip(idxs, samples):
            a = args
            if args.flow_file and "{" in args.flow_file:
                a = copy.copy(args)
                a.flow_file = args.flow_file.format(idx=i)
            ctxs.append(setup_flow(a, sample, dev, "sapien"))
        flow_b = _stack_flow_contexts(ctxs)
    cfg = fit_config(args, "sapien")
    print(f"batch_seq: fitting {len(idxs)} sequences as one batch on {dev}",
          flush=True)
    with phase_timer("fit", verbose=not args.silence):
        fits = fit_base_sequences(cfg, cano_b, pc_b, args.cano_idx,
                                  args.num_parts, flow_b=flow_b,
                                  seed=args.manual_seed, device=dev)
    results = []
    for i, sample, (params, seg, trans) in zip(idxs, samples, fits):
        save_dir = os.path.join(args.save_root, str(i))
        with phase_timer(f"input_gif/{i}", verbose=not args.silence):
            write_input_gif(sample, save_dir)
        with phase_timer(f"finalize/{i}", verbose=not args.silence):
            results.append(finalize(args, "sapien", sample, seg, trans,
                                    params, None, save_dir, args.end_tau,
                                    device=dev))
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.manual_seed)
    device = resolve_device(args.device)
    if args.domain == "corr":
        return run_train_corr(args, device)

    sapien = args.domain == "sapien"
    if sapien and args.batch_seq:
        results = run_batch_seq(args, load_dataset(args), device)
        if not args.silence:
            print(f"[phases] {phase_report()}")
        return results
    idx = args.sapien_idx if sapien else 0
    sample = dataset_sample(load_dataset(args), idx)
    if args.auto_cano and args.model == "base" and not args.evaluate:
        from reart_tpu_torch.selection import select_canonical_frame

        sel_cfg = dataclasses.replace(
            fit_config(args),
            n_iter=args.auto_cano_iters or max(100, args.n_iter // 10),
            use_flow_loss=False)
        # the JAX condition for its batched sweep, a mesh of more than one
        # device; the rows share one card here
        batched = device.type == "cuda" and torch.cuda.device_count() > 1
        with phase_timer("auto_cano", verbose=not args.silence):
            best, energies = select_canonical_frame(
                sample["complete_pc_list"], sel_cfg, args.num_parts,
                include_group=args.domain == "robot", seed=args.manual_seed,
                batched=batched, device=device)
        print(f"auto_cano: selected frame {best} (energies "
              f"{[round(e['total_err'], 3) for e in energies.values()]})",
              flush=True)
        args.cano_idx = best
        sample = dataset_sample(load_dataset(args), idx)
    seq_name = str(idx) if sapien else args.seq_path.rstrip("/").split("/")[-1]
    save_dir = os.path.join(args.save_root, seq_name)
    with phase_timer("input_gif", verbose=not args.silence):
        write_input_gif(sample, save_dir)
    results = run_sample(args, args.domain, sample, save_dir, device)
    if not args.silence:
        print(f"[phases] {phase_report()}")
    return results

"""Sapien-domain helpers (reart_tpu/sapien_eval.py): root alignment, the
full flow between every ordered pair of views and its error, segmentation
propagation, and the flow providers of the sapien run.

The flow providers: `load_precomputed_flow` reads a `--flow_file` (.npz
with flow (T-1, N, 3) and optional conf (T-1, N)); `compute_flow_msync`
runs the external multibody-sync FlowNet/ConfNet, imported from the
directory that holds the config, where that repository and its checkpoint
are on disk (they are not part of this repository).
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of
from reart_tpu_torch.geometry import inverse_transformation
from reart_tpu_torch.models.base_model import compute_pc_transform
from reart_tpu_torch.ops.distance import knn_transfer_labels


def compute_align_trans(trans_list: torch.Tensor, root_trans: torch.Tensor):
    """Poses relative to the root part: the root's inverse trajectory times
    each part's. trans_list (T, P, 4, 4), root_trans (T, 4, 4)."""
    return inverse_transformation(root_trans)[:, None] @ trans_list


def compute_rel_trans(complete_trans_list: torch.Tensor, src_idx: int):
    """Canonical-to-view poses re-based onto view src_idx: view src's
    points to every view, (T, P, 4, 4)."""
    src = complete_trans_list[src_idx]  # (P, 4, 4)
    return complete_trans_list @ inverse_transformation(src)[None]


def compute_full_flow(complete_pc_list, complete_seg_list,
                      complete_trans_list, device=None):
    """(T*T, N, 3) flows between every ordered pair of views, row-major over
    (view i, view j): view i's points moved by their part's pose from view i
    to view j, less the points themselves. Arrays or tensors, on `device`
    (the card when None, or the tensors' device)."""
    dev = device_of(complete_pc_list, complete_trans_list, device=device)
    pcs = torch.as_tensor(complete_pc_list, dtype=torch.float32, device=dev)
    segs = torch.as_tensor(complete_seg_list, device=dev).long()
    trans = torch.as_tensor(complete_trans_list, dtype=torch.float32,
                            device=dev)
    flows = []
    for i in range(pcs.shape[0]):
        moved = compute_pc_transform(pcs[i], compute_rel_trans(trans, i),
                                     segs[i])  # (T, N, 3)
        flows.append(moved - moved[i][None])
    return torch.cat(flows, 0)


def eval_full_flow(full_flow, gt_full_flow) -> float:
    """Mean end-point error over all ordered pairs of distinct views."""
    full_flow = np.asarray(torch.as_tensor(full_flow).cpu())
    gt = np.asarray(gt_full_flow)
    n = int(np.sqrt(full_flow.shape[0]))
    epes = [float(np.linalg.norm(full_flow[j + i * n] - gt[j + i * n],
                                 axis=-1).mean())
            for i in range(n) for j in range(n) if i != j]
    return float(np.mean(epes))


def seg_propagation_list(query_pc_list, ref_pc_list, ref_seg, device=None):
    """1-NN label transfer per frame: the label of each query point's
    nearest point of the same frame's reference cloud (the 1-NN kernel on
    the card). Returns (T, N) int64 numpy."""
    dev = device_of(query_pc_list, ref_pc_list, device=device)
    q = torch.as_tensor(query_pc_list, dtype=torch.float32, device=dev)
    r = torch.as_tensor(ref_pc_list, dtype=torch.float32, device=dev)
    seg = torch.as_tensor(ref_seg, device=dev).long()
    return knn_transfer_labels(q, r, seg).cpu().numpy()


def load_precomputed_flow(path: str):
    """A `--flow_file`: .npz with `flow` (T-1, N, 3) and optional `conf`
    (T-1, N), ones when absent. Returns float32 numpy arrays."""
    data = np.load(path)
    flow = data["flow"].astype(np.float32)
    conf = (data["conf"].astype(np.float32) if "conf" in data
            else np.ones(flow.shape[:2], np.float32))
    return flow, conf


def compute_flow_msync(complete_pc_list, config_path: str, model_path: str,
                       save_path: str | None = None):
    """Consecutive-pair scene flow from the external msync FlowNet/ConfNet:
    the multibody-sync repository is imported from the directory above the
    one holding `msync/` of `config_path` (msync/config/<name>.yaml), its
    weights loaded from `model_path`, each frame pair run once on the CPU.
    With `save_path` the result is also written as a `--flow_file`.

    Returns (flow (T-1, N, 3), conf (T-1, N)) float32 numpy arrays."""
    import os
    import sys

    cfg_abs = os.path.abspath(config_path)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(cfg_abs)))
    inserted = repo_root not in sys.path
    if inserted:
        sys.path.insert(0, repo_root)
    try:
        try:
            import yaml
            from msync.models.conf_net import ConfNet, get_network_input
            from msync.models.flow_net import FlowNet
        except ImportError as e:
            # leave no half-imported msync behind for a later attempt
            for k in [k for k in sys.modules
                      if k == "msync" or k.startswith("msync.")]:
                del sys.modules[k]
            raise ImportError(
                "the msync flow provider needs the multibody-sync repository "
                f"on disk (looked under {repo_root}); put it there, or "
                "precompute flows and pass --flow_file, or use "
                f"--flow_provider corr. Underlying error: {e}") from e
        with open(cfg_abs) as f:
            cfg = yaml.safe_load(f)
        if cfg.get("type") != "full":
            raise ValueError(f"{config_path}: the msync config must be of "
                             f"type 'full', got {cfg.get('type')!r}")
        flow_net, conf_net = FlowNet(), ConfNet()
        state = torch.load(model_path, map_location="cpu")["model_state"]
        for name, mod in (("flow_net", flow_net), ("conf_net", conf_net)):
            mod.load_state_dict({k[len(name) + 1:]: v
                                 for k, v in state.items()
                                 if k.startswith(name + ".")})
            mod.eval()
    finally:
        # the path entry is only needed while importing
        if inserted and repo_root in sys.path:
            sys.path.remove(repo_root)

    pcs = torch.as_tensor(np.asarray(complete_pc_list), dtype=torch.float32)
    flows, confs = [], []
    with torch.no_grad():
        for t in range(pcs.shape[0] - 1):
            src, tgt = pcs[t:t + 1], pcs[t + 1:t + 2]
            flow = flow_net.forward(src, tgt, src, tgt)[0]
            flow = flow[0].transpose(-1, -2).squeeze(0)
            _, w = conf_net(get_network_input(src, tgt, flow))
            flows.append(flow.numpy())
            confs.append(torch.sigmoid(w).squeeze(0).numpy())
    flow = np.stack(flows).astype(np.float32)
    conf = np.stack(confs).astype(np.float32)
    if save_path:
        np.savez(save_path, flow=flow, conf=conf)
    return flow, conf

"""Checkpoints and the stage hand-off artifact (reart_tpu/checkpoint.py).

Both files are pickles of numpy values with the JAX package's schema, so
either package reads what the other writes:
  * model checkpoint: {state_dict, tau, cano_idx}, `state_dict` in the JAX
    parameter-tree layout (interop.base_params_to_numpy,
    interop.kinematic_params_to_numpy); a projection model's checkpoint
    also holds its KinematicState: seg_part, cano_pc, edge_index, edges,
    reverse_topo, path_edges, prismatic_mask, has_root_trans;
  * result.pkl: {pred_cano_part, pred_pose_list, cano_idx,
    joint_connection, **sample}, which the kinematic stage starts from.

The torch-format checkpoints (`save_torch_*` / `load_torch_*`) are the
reference's own `torch.save` dicts: a BaseModel's {state_dict
{proposal_6d, proposal_t, seg_head.model.{0,2}.*} (Conv1d weights (C_out,
C_in, 1)), tau, cano_idx}; a KinematicModel's {state_dict {axis_list,
moment_list, theta_list[, distance_list, root_6d, root_t]}, tau, cano_idx,
seg_part, cano_pc, edge_index {"child_parent": idx}, paths_to_base,
reverse_topo[, joint_type_list]}. `--resume` takes either format (a zip
file is a torch one).
"""

from __future__ import annotations

import os
import pickle
import types

import numpy as np
import torch

from reart_tpu_torch import to_numpy, tree_to_numpy
from reart_tpu_torch.interop import (
    base_params_from_jax,
    base_params_to_numpy,
    kinematic_model_from_numpy,
    kinematic_params_to_numpy,
    kinematic_state_from_numpy,
)
from reart_tpu_torch.models.base_model import BaseModel
from reart_tpu_torch.models.kinematic import (
    KinematicModel,
    KinematicState,
    make_kinematic_state,
)


def _dump(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def save_checkpoint(path: str, params, tau: float, cano_idx: int,
                    state: KinematicState | None = None,
                    extra: dict | None = None) -> None:
    """Model checkpoint. `params` is a BaseModel, a KinematicModel or a
    parameter tree in the JAX layout; `state` the KinematicState of a
    projection model."""
    if isinstance(params, BaseModel):
        params = base_params_to_numpy(params)
    elif isinstance(params, KinematicModel):
        params = kinematic_params_to_numpy(params)
    payload = {"state_dict": tree_to_numpy(params), "tau": float(tau),
               "cano_idx": int(cano_idx)}
    if state is not None:
        pris = state.prismatic_mask
        payload.update({
            "seg_part": to_numpy(state.seg_part).astype(np.int32),
            "cano_pc": to_numpy(state.cano_pc),
            "edge_index": state.edge_index,
            "edges": [list(e) for e in state.edges],
            "reverse_topo": list(state.reverse_topo),
            "path_edges": to_numpy(state.path_edges).astype(np.int32),
            "prismatic_mask": None if pris is None else to_numpy(pris),
            "has_root_trans": state.has_root_trans,
        })
    if extra:
        payload.update(extra)
    _dump(path, payload)


def load_checkpoint(path: str) -> dict:
    """The checkpoint's payload; `base_model_from_checkpoint` rebuilds the
    model from it."""
    with open(path, "rb") as f:
        return pickle.load(f)


def base_model_from_checkpoint(payload: dict, device=None) -> BaseModel:
    return base_params_from_jax(payload["state_dict"], device=device)


def restore_kinematic_state(payload: dict, device=None) -> KinematicState:
    """The KinematicState of a projection checkpoint's payload."""
    fields = types.SimpleNamespace(
        seg_part=payload["seg_part"], cano_pc=payload["cano_pc"],
        num_parts=int(np.max(payload["seg_part"])) + 1,
        path_edges=payload["path_edges"],
        prismatic_mask=payload.get("prismatic_mask"),
        edges=payload["edges"], reverse_topo=payload["reverse_topo"],
        has_root_trans=payload.get("has_root_trans", False))
    return kinematic_state_from_numpy(fields, device)


def kinematic_model_from_checkpoint(payload: dict, device=None):
    """(KinematicModel, KinematicState) of a projection checkpoint."""
    return (kinematic_model_from_numpy(payload["state_dict"], device),
            restore_kinematic_state(payload, device))


def save_result(path: str, pred_cano_part, pred_pose_list, cano_idx: int,
                joint_connection, sample: dict) -> None:
    """Stage hand-off artifact, reference schema."""
    save_dict = {
        "pred_cano_part": to_numpy(pred_cano_part),
        "pred_pose_list": to_numpy(pred_pose_list),
        "cano_idx": int(cano_idx),
        "joint_connection": [list(map(int, e)) for e in joint_connection],
    }
    save_dict.update(tree_to_numpy(sample))
    _dump(path, save_dict)


def load_result(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


# -- the reference's torch-format checkpoints --------------------------------

def is_torch_checkpoint(path: str) -> bool:
    """Whether `path` is a torch.save zip container (else a pickle)."""
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def _torch_load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_base(path: str, device=None):
    """A reference BaseModel checkpoint -> (BaseModel on `device` (the card
    when None), tau, cano_idx)."""
    ckpt = _torch_load(path)
    sd = {k: to_numpy(v) for k, v in ckpt["state_dict"].items()
          if isinstance(v, (torch.Tensor, np.ndarray))}
    tree = {
        "seg": [{"w": sd["seg_head.model.0.weight"][:, :, 0].T,
                 "b": sd["seg_head.model.0.bias"]},
                {"w": sd["seg_head.model.2.weight"][:, :, 0].T}],
        "proposal_6d": sd["proposal_6d"],
        "proposal_t": sd["proposal_t"],
    }
    return (base_params_from_jax(tree, device=device),
            float(ckpt.get("tau", 1.0)), int(ckpt.get("cano_idx", 0)))


def load_torch_kinematic(path: str, device=None):
    """A reference KinematicModel checkpoint -> (KinematicModel,
    KinematicState, tau, cano_idx) on `device` (the card when None). The
    edges come in edge_index order; the root is the one parent that is no
    child."""
    ckpt = _torch_load(path)
    sd = {k: to_numpy(v) for k, v in ckpt["state_dict"].items()}
    edges = [None] * len(ckpt["edge_index"])
    for name, idx in ckpt["edge_index"].items():
        c, p = name.split("_")
        edges[int(idx)] = (int(c), int(p))
    children = {c for c, _ in edges}
    root = next(p for _, p in edges if p not in children)
    state = make_kinematic_state(
        to_numpy(ckpt["seg_part"]), to_numpy(ckpt["cano_pc"]), edges, root,
        joint_types=ckpt.get("joint_type_list"),
        has_root_trans="root_6d" in sd, device=device)
    return (kinematic_model_from_numpy(sd, device), state,
            float(ckpt.get("tau", 1.0)), int(ckpt.get("cano_idx", 0)))


def save_torch_base(path: str, params, tau: float, cano_idx: int) -> None:
    """A BaseModel (or a JAX-layout parameter tree) as the reference's
    BaseModel checkpoint; the inverse of `load_torch_base`."""
    if isinstance(params, BaseModel):
        params = base_params_to_numpy(params)
    seg = params["seg"]

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    sd = {"proposal_6d": t(params["proposal_6d"]),
          "proposal_t": t(params["proposal_t"]),
          # (C_in, C_out) -> torch Conv1d (C_out, C_in, 1)
          "seg_head.model.0.weight": t(np.asarray(seg[0]["w"]).T[:, :, None]),
          "seg_head.model.0.bias": t(seg[0]["b"]),
          "seg_head.model.2.weight": t(np.asarray(seg[1]["w"]).T[:, :, None])}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": sd, "tau": float(tau),
                "cano_idx": int(cano_idx)}, path)


def save_torch_kinematic(path: str, params, state: KinematicState,
                         tau: float, cano_idx: int) -> None:
    """A KinematicModel (or its parameter dict) and its KinematicState as
    the reference's KinematicModel checkpoint; the inverse of
    `load_torch_kinematic`. paths_to_base is {part: [part, parent, ...,
    root]} over the child-to-parent edges."""
    if isinstance(params, KinematicModel):
        params = kinematic_params_to_numpy(params)
    sd = {k: torch.tensor(np.asarray(v), dtype=torch.float32)
          for k, v in params.items()}
    parent = {int(c): int(p) for c, p in state.edges}
    root = next(int(p) for _, p in state.edges if int(p) not in parent)
    paths_to_base = {}
    for n in range(state.num_parts):
        chain, cur = [n], n
        while cur != root:
            cur = parent[cur]
            chain.append(cur)
        paths_to_base[n] = chain
    payload = {
        "state_dict": sd, "tau": float(tau), "cano_idx": int(cano_idx),
        "seg_part": torch.as_tensor(to_numpy(state.seg_part),
                                    dtype=torch.int64),
        "cano_pc": torch.as_tensor(to_numpy(state.cano_pc),
                                   dtype=torch.float32),
        "edge_index": dict(state.edge_index),
        "paths_to_base": paths_to_base,
        "reverse_topo": [int(n) for n in state.reverse_topo],
    }
    if state.prismatic_mask is not None:
        payload["joint_type_list"] = [
            "prismatic" if m else "revolute"
            for m in to_numpy(state.prismatic_mask).astype(bool)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, path)

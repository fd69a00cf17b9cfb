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
from reart_tpu_torch.models.kinematic import KinematicModel, KinematicState


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

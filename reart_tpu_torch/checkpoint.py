"""Checkpoints and the stage hand-off artifact (reart_tpu/checkpoint.py).

Both files are pickles of numpy values with the JAX package's schema, so
either package reads what the other writes:
  * model checkpoint: {state_dict, tau, cano_idx}, `state_dict` in the JAX
    parameter-tree layout (interop.base_params_to_numpy);
  * result.pkl: {pred_cano_part, pred_pose_list, cano_idx,
    joint_connection, **sample}, which the kinematic stage starts from.
"""

from __future__ import annotations

import os
import pickle

import torch

from reart_tpu_torch import to_numpy
from reart_tpu_torch.interop import base_params_from_jax, base_params_to_numpy
from reart_tpu_torch.models.base_model import BaseModel


def _to_numpy(value):
    """Tensors to numpy arrays, through dicts, lists and tuples."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(v) for v in value)
    return value


def _dump(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def save_checkpoint(path: str, params, tau: float, cano_idx: int,
                    extra: dict | None = None) -> None:
    """Model checkpoint of the relaxation stage. `params` is a BaseModel or
    a parameter tree in the JAX layout."""
    if isinstance(params, BaseModel):
        params = base_params_to_numpy(params)
    payload = {"state_dict": _to_numpy(params), "tau": float(tau),
               "cano_idx": int(cano_idx)}
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


def save_result(path: str, pred_cano_part, pred_pose_list, cano_idx: int,
                joint_connection, sample: dict) -> None:
    """Stage hand-off artifact, reference schema."""
    save_dict = {
        "pred_cano_part": to_numpy(pred_cano_part),
        "pred_pose_list": to_numpy(pred_pose_list),
        "cano_idx": int(cano_idx),
        "joint_connection": [list(map(int, e)) for e in joint_connection],
    }
    save_dict.update(_to_numpy(sample))
    _dump(path, save_dict)


def load_result(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)

"""Parameter interop with the JAX package, through numpy only.

The JAX relaxation parameters are a pytree
{"seg": [{"w", "b"}, ..., {"w"}], "proposal_6d", "proposal_t"} with each
`w` stored (in, out); the port keeps torch's Linear layout (out, in). The
projection parameters are a flat dict {axis_list, moment_list, theta_list[,
distance_list, root_6d, root_t]}, the KinematicModel's parameter names.
The correspondence backbone's tree is {"sa1": [[layer, ...], ...], "sa2",
"sa3": [layer, ...], "fp3", "fp2", "fp1", "head": layer} with each layer
{"w" (in, out), "b", "bn_w", "bn_b", "bn_mean", "bn_var"}.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import resolve_device
from reart_tpu_torch.models.base_model import BaseModel
from reart_tpu_torch.models.kinematic import KinematicModel, KinematicState
from reart_tpu_torch.models.pointnet2 import (
    PointNet2Msg2,
    params_from_numpy,
    params_to_numpy,
)


def base_params_from_jax(tree, device=None) -> BaseModel:
    """A BaseModel holding the values of a JAX base-parameter pytree (numpy
    leaves, or anything np.asarray accepts)."""
    seg = tree["seg"]
    p6d = np.asarray(tree["proposal_6d"], np.float32)
    pose_len, num_parts = p6d.shape[:2]
    hidden = np.asarray(seg[0]["w"]).shape[1]
    if len(seg) != 2:
        raise ValueError(f"expected a 2-layer seg MLP, got {len(seg)} layers")
    model = BaseModel(num_parts, pose_len, hidden, device=device)
    state = {"proposal_6d": p6d,
             "proposal_t": np.asarray(tree["proposal_t"], np.float32)}
    for i, layer in enumerate(seg):
        state[f"seg.layers.{i}.weight"] = np.asarray(layer["w"], np.float32).T
        if "b" in layer:
            state[f"seg.layers.{i}.bias"] = np.asarray(layer["b"], np.float32)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


def base_params_to_numpy(model: BaseModel):
    """The JAX pytree layout of a BaseModel's parameters, as numpy."""
    seg = []
    for layer in model.seg.layers:
        d = {"w": layer.weight.detach().cpu().numpy().T.copy()}
        if layer.bias is not None:
            d["b"] = layer.bias.detach().cpu().numpy().copy()
        seg.append(d)
    return {"seg": seg,
            "proposal_6d": model.proposal_6d.detach().cpu().numpy().copy(),
            "proposal_t": model.proposal_t.detach().cpu().numpy().copy()}


def kinematic_model_from_numpy(tree, device=None) -> KinematicModel:
    """A KinematicModel holding the values of a projection parameter dict."""
    theta = np.asarray(tree["theta_list"], np.float32)
    model = KinematicModel(theta.shape[0], theta.shape[1],
                           load_distance="distance_list" in tree,
                           load_root_trans="root_6d" in tree, device=device)
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in tree.items()})
    return model


def kinematic_state_from_numpy(state, device=None) -> KinematicState:
    """The port's KinematicState from the fields of the JAX package's (any
    object with its attributes; arrays as numpy or anything np.asarray
    accepts), on `device` (the card when None)."""
    device = resolve_device(device)
    pris = state.prismatic_mask
    return KinematicState(
        seg_part=torch.tensor(np.asarray(state.seg_part),
                              dtype=torch.int64, device=device),
        cano_pc=torch.tensor(np.asarray(state.cano_pc),
                             dtype=torch.float32, device=device),
        num_parts=int(state.num_parts),
        path_edges=torch.tensor(np.asarray(state.path_edges),
                                dtype=torch.int64, device=device),
        prismatic_mask=None if pris is None else torch.tensor(
            np.asarray(pris, dtype=bool), device=device),
        edges=tuple((int(c), int(p)) for c, p in state.edges),
        reverse_topo=tuple(int(n) for n in state.reverse_topo),
        has_root_trans=bool(state.has_root_trans))


def kinematic_params_from_jax(tree, state, device=None):
    """The JAX projection parameters and KinematicState -> the port's
    (KinematicModel, KinematicState), so both compute the same thing."""
    return (kinematic_model_from_numpy(tree, device),
            kinematic_state_from_numpy(state, device))


def kinematic_params_to_numpy(model: KinematicModel) -> dict:
    """The JAX parameter dict of a KinematicModel, as numpy."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def pointnet2_params_from_jax(tree, device=None) -> PointNet2Msg2:
    """A PointNet2Msg2 on `device` (the card when None) holding the values
    of a JAX backbone parameter tree (numpy leaves, or anything np.asarray
    accepts)."""
    return params_from_numpy(tree, device)


def pointnet2_params_to_numpy(model: PointNet2Msg2) -> dict:
    """The JAX parameter tree of a PointNet2Msg2, as numpy."""
    return params_to_numpy(model)

"""Parameter interop with the JAX package, through numpy only.

The JAX relaxation parameters are a pytree
{"seg": [{"w", "b"}, ..., {"w"}], "proposal_6d", "proposal_t"} with each
`w` stored (in, out); the port keeps torch's Linear layout (out, in).
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch.models.base_model import BaseModel


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

"""Adam's update through torch's functional `torch.optim.adam.adam`, the
arithmetic torch.optim.Adam runs (its multi-tensor form on the card), so
that equal gradients give equal steps; called directly rather than through
an optimizer object's `step`, so that a fault planted in the program's
optimizer cannot reach the reference."""

from __future__ import annotations

import torch
from torch.optim.adam import adam

BETAS, EPS = (0.9, 0.999), 1e-8


def new_state(p: torch.Tensor, state: dict | None = None) -> dict:
    """Adam's state of one leaf: the given m, v and step, else zeros."""
    if state:
        return {"m": state["m"].clone(), "v": state["v"].clone(),
                "step": torch.tensor(float(state["step"]))}
    return {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
            "step": torch.tensor(0.0)}


@torch.no_grad()
def step(params: list, grads: list, states: list, lr: float) -> None:
    """One update of `params` in place (no weight decay)."""
    adam(params, grads, [s["m"] for s in states], [s["v"] for s in states],
         [], [s["step"] for s in states],
         foreach=params[0].device.type == "cuda", amsgrad=False,
         beta1=BETAS[0], beta2=BETAS[1], lr=lr, weight_decay=0.0, eps=EPS,
         maximize=False)

"""Per-point MLP (reart_tpu/models/blocks.py).

Per-point dense layers with ReLU between them, no norm, and no bias on the
last layer (the reference's 1x1-conv MLP). Weights follow torch's Conv1d /
Linear default init bounds: kaiming_uniform(a=sqrt(5)) gives
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights, and the bias uses the same
bound.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    """dims = (in, hidden..., out); x (..., in) -> (..., out)."""

    def __init__(self, dims, *, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=i < n - 1, device=device)
            for i in range(n))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw on the generator's device and copy, so one seed gives the
        same weights whatever device the module lives on."""
        src = generator.device if generator is not None else "cpu"
        for layer in self.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            for p in (layer.weight, layer.bias):
                if p is not None:
                    p.copy_(torch.empty(p.shape, device=src).uniform_(
                        -bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            # product first, bias after, as the JAX reference computes it
            x = F.linear(x, layer.weight)
            if layer.bias is not None:
                x = x + layer.bias
            if i < n - 1:
                x = F.relu(x)
        return x

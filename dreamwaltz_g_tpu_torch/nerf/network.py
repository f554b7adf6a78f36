"""NeRF decode heads.

Port of ``SigmaMLP`` from ``dreamwaltz_g_tpu/nerf/network.py``. Layer names
(``dense_0`` ...) are Flax's, so converted weights map one to one; Flax
``Dense`` kernels are (in, out) and land transposed in ``nn.Linear.weight``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (Flax's variance_scaling divisor)
_TRUNC_STD = 0.87962566103423978


def init_dense(layer: nn.Linear, generator: torch.Generator,
               std: Optional[float] = None) -> None:
    """Flax ``Dense`` initialisation: a truncated-normal LeCun kernel (or
    N(0, std^2) when ``std`` is given) and a zero bias."""
    with torch.no_grad():
        if std is None:
            s = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, std=s, a=-2 * s, b=2 * s,
                                  generator=generator)
        else:
            layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()


class SigmaMLP(nn.Module):
    """Encoder features -> (sigma, albedo...) head: ``num_layers`` dense
    layers with ReLU between them."""

    def __init__(self, in_features: int, hidden: int = 64,
                 num_layers: int = 3, out_channels: int = 4, device=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_features] + [hidden] * (num_layers - 1) + [out_channels]
        for i in range(num_layers):
            self.add_module(f"dense_{i}",
                            nn.Linear(dims[i], dims[i + 1], device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_layers):
            init_dense(getattr(self, f"dense_{i}"), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return getattr(self, f"dense_{self.num_layers - 1}")(x)

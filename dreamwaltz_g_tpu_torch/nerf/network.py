"""NeRF networks: the field (triplane + MLP heads), density activations and
priors, and the ray-direction background MLP.

Port of ``dreamwaltz_g_tpu/nerf/network.py``. Layer names (``dense_0`` ...)
are Flax's, so converted weights map one to one; Flax ``Dense`` kernels are
(in, out) and land transposed in ``nn.Linear.weight``.

``NeRFModel`` holds its own weights (the JAX package keeps them in a
``NeRFParams`` tree beside a static model): the triplane ``planes`` (and,
for ``dual_enc``, ``planes_sigma``), the ``sigma_mlp`` head (and, for
``dual_mlp`` / ``dual_enc``, the ``albedo_mlp``), the ``bg_mlp`` and, for
the ``scaling`` activation, ``sigma_scale``. Its methods ``encode``,
``density`` and ``background`` are the JAX methods without the ``params``
argument. The triplane is the only backbone ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .encoder import (
    TriplaneParams,
    enc_cfg_from_nerf,
    frequency_encode,
    triplane_encode,
)

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


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp whose backward clamps its input to [-15, 15]."""
    return _TruncExp.apply(x)


def density_activation(kind: str, x: torch.Tensor,
                       sigma_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """'exp' (``trunc_exp``), 'softplus', or 'scaling': softplus of x times
    a learnable exp(sigma_scale), shifted by -1."""
    if kind == "exp":
        return trunc_exp(x)
    if kind == "softplus":
        return torch.nn.functional.softplus(x)
    if kind == "scaling":
        s = torch.zeros((), device=x.device) if sigma_scale is None \
            else sigma_scale
        return torch.nn.functional.softplus(x * torch.exp(s) - 1.0)
    raise ValueError(f"unknown density activation {kind!r}")


def density_prior(kind: str, positions: torch.Tensor,
                  bound: float) -> torch.Tensor:
    """The density blob added to the raw sigma."""
    if kind == "none":
        return torch.zeros(positions.shape[:-1], device=positions.device)
    d2 = torch.sum(positions ** 2, dim=-1)
    if kind == "gaussian":
        return 5.0 * torch.exp(-d2 / (2 * (0.2 * bound) ** 2))
    if kind == "sqrt":
        return 10.0 * (1.0 - torch.sqrt(torch.sqrt(d2)) / (0.4 * bound))
    raise ValueError(f"unknown density prior {kind!r}")


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


class BackgroundMLP(SigmaMLP):
    """Ray direction -> background color logits: the frequency encoding of
    the direction (``degree`` octaves and the input) through a ReLU MLP."""

    def __init__(self, hidden: int = 64, num_layers: int = 2,
                 out_channels: int = 3, degree: int = 6, device=None):
        super().__init__(3 * (2 * degree + 1), hidden, num_layers,
                         out_channels, device=device)
        self.degree = degree

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        return super().forward(frequency_encode(dirs, degree=self.degree))


class NeRFModel(nn.Module):
    """The stage-1 field with its weights (module docstring)."""

    def __init__(self, cfg, with_background: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.enc_cfg = enc_cfg = enc_cfg_from_nerf(cfg)
        C = self.color_channels
        shape = (3, enc_cfg.resolution, enc_cfg.resolution,
                 enc_cfg.feature_dim)
        self.planes = nn.Parameter(torch.zeros(shape, device=device))
        D = enc_cfg.output_dim
        if self.structure == "shared_mlp":
            self.sigma_mlp = SigmaMLP(D, 64, 3, 1 + C, device=device)
            self.albedo_mlp = None
        elif self.structure in ("dual_mlp", "dual_enc"):
            self.sigma_mlp = SigmaMLP(D, 64, 3, 1, device=device)
            self.albedo_mlp = SigmaMLP(D, 64, 3, C, device=device)
        else:
            raise ValueError(f"unknown nerf structure {self.structure!r}")
        self.planes_sigma = nn.Parameter(torch.zeros(shape, device=device)) \
            if self.structure == "dual_enc" else None
        self.bg_mlp = BackgroundMLP(device=device) if with_background \
            else None
        self.sigma_scale = nn.Parameter(torch.zeros((), device=device)) \
            if cfg.density_activation == "scaling" else None

    @property
    def bound(self) -> float:
        return self.cfg.bound

    @property
    def structure(self) -> str:
        return getattr(self.cfg, "structure", "shared_mlp")

    @property
    def color_channels(self) -> int:
        return 4 if self.cfg.nerf_type == "latent" else 3

    @property
    def encoder(self) -> TriplaneParams:
        return TriplaneParams(planes=self.planes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``: planes
        N(0, 0.1^2), dense kernels truncated LeCun normal, biases and
        ``sigma_scale`` 0."""
        with torch.no_grad():
            for p in (self.planes, self.planes_sigma):
                if p is not None:
                    p.copy_(torch.randn(p.shape, generator=generator,
                                        device=p.device) * 0.1)
            for mlp in (self.sigma_mlp, self.bg_mlp, self.albedo_mlp):
                if mlp is not None:
                    mlp.reset_parameters(generator)
            if self.sigma_scale is not None:
                self.sigma_scale.zero_()

    def encode(self, positions: torch.Tensor) -> torch.Tensor:
        return triplane_encode(self.encoder, self.enc_cfg, positions,
                               self.bound)

    def density(self, positions: torch.Tensor):
        """(sigma (...,), albedo (..., C)) at (..., 3) world positions."""
        h = self.encode(positions)
        if self.albedo_mlp is None:       # shared_mlp: one head, both
            out = self.sigma_mlp(h)
            raw, alb = out[..., 0], out[..., 1:]
        elif self.structure == "dual_enc":
            h_sig = triplane_encode(TriplaneParams(self.planes_sigma),
                                    self.enc_cfg, positions, self.bound)
            raw = self.sigma_mlp(h_sig)[..., 0]
            alb = self.albedo_mlp(h)
        else:                             # dual_mlp: shared encoding
            raw = self.sigma_mlp(h)[..., 0]
            alb = self.albedo_mlp(h)
        raw = raw + density_prior(self.cfg.density_prior, positions,
                                  self.bound)
        sigma = density_activation(self.cfg.density_activation, raw,
                                   self.sigma_scale)
        return sigma, torch.sigmoid(alb)

    def background(self, dirs: torch.Tensor) -> torch.Tensor:
        if self.bg_mlp is None:
            raise ValueError("the model was built without a background MLP")
        return torch.sigmoid(self.bg_mlp(dirs))


def build_nerf(cfg, with_background: bool = True,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> NeRFModel:
    """The field ``cfg.structure`` selects (shared_mlp / dual_mlp /
    dual_enc), on ``device``, with weights drawn from ``generator`` (a
    generator seeded 0 on ``device`` when None)."""
    from .._device import resolve_device

    device = resolve_device(device)
    model = NeRFModel(cfg, with_background, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model.reset_parameters(generator)
    return model

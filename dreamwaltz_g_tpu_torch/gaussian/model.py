"""3D Gaussian parameters in fixed-capacity buffers.

Port of ``dreamwaltz_g_tpu/gaussian/model.py``: the parameter tensors are
allocated once at ``capacity`` and carry an ``alive`` mask, so clone, split
and prune are masked writes into their slots (``gaussian/densify.py``).
Activations: sigmoid opacity, exp scales, normalised quaternions, SH color
with separate DC and rest coefficients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.sh import eval_sh, rgb_to_sh, sh_to_rgb
from ..utils.transforms import quat_normalize


class GaussianParams(NamedTuple):
    """Learnable parameters (raw, pre-activation), padded to capacity."""

    means: torch.Tensor          # (C, 3)
    sh_dc: torch.Tensor          # (C, 1, 3)
    sh_rest: torch.Tensor        # (C, L^2 - 1, 3)
    opacity_logit: torch.Tensor  # (C, 1)
    log_scales: torch.Tensor     # (C, 3)
    quats: torch.Tensor          # (C, 4) unnormalised


class GaussianState(NamedTuple):
    """Parameters, the alive mask and the densification statistics."""

    params: GaussianParams
    alive: torch.Tensor        # (C,) bool
    grad_accum: torch.Tensor   # (C,) accumulated |dL/d means2d|
    grad_denom: torch.Tensor   # (C,) accumulation steps seen
    max_radii: torch.Tensor    # (C,) largest screen radius seen

    @property
    def capacity(self) -> int:
        return self.params.means.shape[0]


def logit32(p: float) -> float:
    """log(p / (1 - p)) taken in float32, as the JAX package takes it."""
    return float(torch.log(torch.tensor(p / (1.0 - p), dtype=torch.float32)))


def init_state(positions: torch.Tensor,
               colors: Optional[torch.Tensor] = None,
               capacity: Optional[int] = None, sh_levels: int = 4,
               init_opacity: float = 0.99,
               init_scale: Optional[torch.Tensor] = None,
               default_scale: float = 0.001) -> GaussianState:
    """The state of N points, its buffers padded to ``capacity`` (dead
    slots: opacity and scale logits -10). ``init_scale``: (N, 3) or (N,)
    linear scales, ``default_scale`` everywhere when None."""
    dev = positions.device
    N = positions.shape[0]
    C = capacity or N
    if C < N:
        raise ValueError(f"capacity {C} < {N} points")
    n_rest = sh_levels * sh_levels - 1

    def pad(a, fill=0.0):
        if C == N:
            return a
        return torch.cat([a, torch.full((C - N,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=dev)])

    if colors is None:
        colors = torch.full((N, 3), 0.5, device=dev)
    if init_scale is None:
        init_scale = torch.full((N, 3), default_scale, device=dev)
    elif init_scale.ndim == 1:
        init_scale = init_scale[:, None].expand(N, 3)
    f32 = torch.float32
    quats = torch.zeros((C, 4), dtype=f32, device=dev)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means=pad(positions.to(f32)),
        sh_dc=pad(rgb_to_sh(colors.to(f32))[:, None, :]),
        sh_rest=torch.zeros((C, n_rest, 3), dtype=f32, device=dev),
        opacity_logit=pad(torch.full((N, 1), logit32(init_opacity),
                                     dtype=f32, device=dev), fill=-10.0),
        log_scales=pad(torch.log(init_scale.to(f32)), fill=-10.0),
        quats=quats,
    )
    z = torch.zeros((C,), dtype=f32, device=dev)
    return GaussianState(params=params,
                         alive=torch.arange(C, device=dev) < N,
                         grad_accum=z, grad_denom=z.clone(),
                         max_radii=z.clone())


# -- activations -------------------------------------------------------------

def opacities(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity_logit[:, 0])


def scales(p: GaussianParams, max_scale: Optional[float] = None
           ) -> torch.Tensor:
    s = torch.exp(p.log_scales)
    if max_scale is not None:
        s = torch.clamp(s, max=max_scale)
    return s


def rotations(p: GaussianParams) -> torch.Tensor:
    return quat_normalize(p.quats)


def sh_coeffs(p: GaussianParams) -> torch.Tensor:
    """(C, n_sh, 3): the DC and rest coefficients stacked."""
    return torch.cat([p.sh_dc, p.sh_rest], dim=1)


def view_colors(p: GaussianParams, campos: torch.Tensor,
                sh_degree: int) -> torch.Tensor:
    """The SH toward the camera at ``campos``, + 0.5, clamped at 0:
    (C, 3)."""
    dirs = p.means - campos[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-8)
    sh = torch.swapaxes(sh_coeffs(p), 1, 2)  # (C, 3, n_sh)
    return torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)


def dc_colors(p: GaussianParams) -> torch.Tensor:
    return torch.clamp(sh_to_rgb(p.sh_dc[:, 0, :]), 0.0, 1.0)

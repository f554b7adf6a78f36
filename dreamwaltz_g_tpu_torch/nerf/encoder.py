"""Field encoders: the factorized triplane and the frequency encoding.

Port of the triplane branch of ``dreamwaltz_g_tpu/nerf/encoder.py``. The
multi-resolution hash/tiled grid (``GridEncoderConfig``) is not ported yet;
``encode_any`` and ``enc_cfg_from_nerf`` refuse it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TriplaneConfig(NamedTuple):
    """Axis-aligned factorized plane encoding (XY, XZ, YZ planes)."""

    resolution: int = 256
    feature_dim: int = 32
    reduce: str = "sum"       # {'sum', 'concat'}
    compute_dtype: str = "f32"

    @property
    def output_dim(self) -> int:
        return self.feature_dim * (3 if self.reduce == "concat" else 1)


class TriplaneParams(NamedTuple):
    planes: torch.Tensor  # (3, R, R, F) -- XY, XZ, YZ


def init_triplane(cfg: TriplaneConfig, generator: torch.Generator,
                  scale: float = 0.1) -> TriplaneParams:
    """N(0, scale^2) planes on the generator's device."""
    planes = torch.randn(
        (3, cfg.resolution, cfg.resolution, cfg.feature_dim),
        generator=generator, device=generator.device) * scale
    return TriplaneParams(planes=planes)


def triplane_encode(
    params: TriplaneParams,
    cfg: TriplaneConfig,
    positions: torch.Tensor,
    bound: float = 1.0,
) -> torch.Tensor:
    """Encode (..., 3) world positions in [-bound, bound] -> (..., D).

    Each point bilinearly samples the three planes; features are summed (or
    concatenated). Out-of-bound points yield zero features."""
    shape = positions.shape[:-1]
    x = positions.reshape(-1, 3)
    coords01 = (x / bound + 1.0) * 0.5
    in_bounds = torch.all((coords01 >= 0.0) & (coords01 <= 1.0), dim=-1)
    coords01 = torch.clamp(coords01, 0.0, 1.0)

    R = cfg.resolution
    planes = params.planes
    if cfg.compute_dtype == "bf16":
        planes = planes.to(torch.bfloat16)
    feats = []
    for p, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
        uv = coords01[:, (a, b)] * (R - 1)
        uv0 = torch.floor(uv)
        frac = uv - uv0
        i0 = uv0.long()
        i1 = torch.clamp(i0 + 1, max=R - 1)
        flat = planes[p].reshape(R * R, cfg.feature_dim)
        f00 = flat[i0[:, 0] * R + i0[:, 1]]
        f01 = flat[i0[:, 0] * R + i1[:, 1]]
        f10 = flat[i1[:, 0] * R + i0[:, 1]]
        f11 = flat[i1[:, 0] * R + i1[:, 1]]
        wu, wv = frac[:, :1], frac[:, 1:2]
        feats.append((1 - wu) * ((1 - wv) * f00 + wv * f01)
                     + wu * ((1 - wv) * f10 + wv * f11))
    out = sum(feats) if cfg.reduce == "sum" else torch.cat(feats, -1)
    out = torch.where(in_bounds[:, None], out, torch.zeros_like(out))
    return out.float().reshape(shape + (cfg.output_dim,))


def encode_any(params, cfg, positions: torch.Tensor, bound: float = 1.0,
               ) -> torch.Tensor:
    """Backbone dispatch; only the triplane is ported so far."""
    if isinstance(cfg, TriplaneConfig):
        return triplane_encode(params, cfg, positions, bound)
    raise NotImplementedError(
        f"{type(cfg).__name__} backbone is not ported; use TriplaneConfig")


def init_encoder_any(cfg, generator: torch.Generator):
    if isinstance(cfg, TriplaneConfig):
        return init_triplane(cfg, generator)
    raise NotImplementedError(
        f"{type(cfg).__name__} backbone is not ported; use TriplaneConfig")


def enc_cfg_from_nerf(nerf_cfg) -> TriplaneConfig:
    """The field encoder's config from a ``NeRFConfig`` (the one place the
    backbone setting maps to a layout). Only the triplane is ported."""
    if nerf_cfg.backbone != "triplane":
        raise NotImplementedError(
            f"{nerf_cfg.backbone!r} backbone is not ported; use 'triplane'")
    return TriplaneConfig(resolution=nerf_cfg.triplane_resolution,
                          feature_dim=nerf_cfg.triplane_dim,
                          compute_dtype=nerf_cfg.grid_dtype)


def frequency_encode(x: torch.Tensor, degree: int = 6,
                     include_input: bool = True) -> torch.Tensor:
    """Sin/cos positional encoding."""
    out = [x] if include_input else []
    for d in range(degree):
        s = x * (2.0 ** d)
        out.append(torch.sin(s))
        out.append(torch.cos(s))
    return torch.cat(out, dim=-1)

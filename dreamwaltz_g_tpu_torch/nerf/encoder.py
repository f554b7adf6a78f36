"""Field encoders: the multi-resolution hash / tiled grid, the factorized
triplane and the frequency encoding.

Port of ``dreamwaltz_g_tpu/nerf/encoder.py``. The grid (Instant-NGP, the
reference's ``--nerf.backbone hashgrid | tiledgrid``) keeps the JAX
package's index semantics to the element, so converted reference
checkpoints evaluate alike:

* per-level resolution ``ceil(base * pls**level)`` with
  ``pls = 2**(log2(desired / base) / (L - 1))``;
* table length ``min(2**log2_hashmap_size, (res + 1)**3)`` rounded up to a
  multiple of 8;
* sample position ``x01 * (base * pls**level - 1) + 0.5``;
* the linear index with strides (1, res + 1, (res + 1)^2) accumulated only
  while the stride fits the table, then ``% table`` ('tiled') or the
  xor-prime hash ('hash'). The JAX code works in uint32, so the products
  wrap at 2^32: here they are taken in int64 and masked to 32 bits before
  the xor and the modulo;
* out-of-range inputs give zero features.

The tables are one (L, T_max, F) padded stack; ``tables_from_flat`` /
``tables_to_flat`` convert the reference's flat (sum_T, F) layout. The
gather is a torch op (indexing), its backward torch's scatter-add: the
JAX package has no Pallas kernel for it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device

# Instant-NGP spatial-hash primes
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class GridEncoderConfig(NamedTuple):
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    desired_resolution: int = 2048
    log2_hashmap_size: int = 19
    gridtype: str = "tiled"     # {'tiled', 'hash'}
    compute_dtype: str = "f32"  # {'f32', 'bf16'}: the gathered tables' type

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                    / (self.num_levels - 1)))

    def level_scale(self, level: int) -> float:
        return self.base_resolution * self.per_level_scale ** level - 1.0

    def level_resolution(self, level: int) -> int:
        return int(np.ceil(self.base_resolution
                           * self.per_level_scale ** level))

    def level_table_size(self, level: int) -> int:
        r = self.level_resolution(level)
        n = min(2 ** self.log2_hashmap_size, (r + 1) ** 3)
        return int(np.ceil(n / 8) * 8)

    @property
    def max_table_size(self) -> int:
        return max(self.level_table_size(lv)
                   for lv in range(self.num_levels))

    @property
    def total_params(self) -> int:
        return sum(self.level_table_size(lv)
                   for lv in range(self.num_levels)) * self.level_dim


class GridEncoderParams(NamedTuple):
    tables: torch.Tensor  # (L, T_max, F)


def init_grid_encoder(cfg: GridEncoderConfig, generator: torch.Generator,
                      scale: float = 1e-4) -> GridEncoderParams:
    """U(-scale, scale) tables on the generator's device."""
    u = torch.rand((cfg.num_levels, cfg.max_table_size, cfg.level_dim),
                   generator=generator, device=generator.device)
    return GridEncoderParams(tables=u * (2 * scale) - scale)


def tables_from_flat(cfg: GridEncoderConfig, flat,
                     device="cuda") -> GridEncoderParams:
    """A reference checkpoint's flat (sum_T, F) embedding array as the
    padded (L, T_max, F) stack (zeros past each level's table)."""
    if not isinstance(cfg, GridEncoderConfig):
        raise ValueError(
            "reference checkpoints store hash-grid embedding tables; the "
            f"current field backbone is {type(cfg).__name__}. Load them "
            "with --nerf.backbone tiledgrid (the reference-parity field "
            "layout).")
    flat = np.asarray(flat, np.float32)
    out = np.zeros((cfg.num_levels, cfg.max_table_size, cfg.level_dim),
                   np.float32)
    off = 0
    for lv in range(cfg.num_levels):
        n = cfg.level_table_size(lv)
        out[lv, :n] = flat[off: off + n]
        off += n
    return GridEncoderParams(tables=torch.as_tensor(
        out, device=resolve_device(device)))


def tables_to_flat(cfg: GridEncoderConfig,
                   params: GridEncoderParams) -> np.ndarray:
    t = params.tables.detach().cpu().numpy()
    return np.concatenate([t[lv, : cfg.level_table_size(lv)]
                           for lv in range(cfg.num_levels)], axis=0)


def _level_indices(coords01: torch.Tensor, level_scale: float,
                   resolution: int, table_size: int, gridtype: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner table indices and trilinear weights for one level.

    coords01: (N, 3) in [0, 1]. Returns ((N, 8) int64, (N, 8) float): corner
    i's bit d flags an upper corner along dimension d."""
    pos = coords01 * level_scale + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    offs = torch.tensor([[(i >> d) & 1 for d in range(3)] for i in range(8)],
                        dtype=torch.int64, device=coords01.device)
    c = pos_grid.long()[:, None, :] + offs[None]  # (N, 8, 3)

    stride_mult = resolution + 1
    index = torch.zeros(c.shape[:2], dtype=torch.int64, device=c.device)
    stride = 1
    for d in range(3):
        if stride <= table_size:
            index = (index + c[..., d] * stride) & _U32
        stride *= stride_mult
    if gridtype == "hash" and stride > table_size:
        index = ((c[..., 0] * _PRIMES[0]) & _U32) \
            ^ ((c[..., 1] * _PRIMES[1]) & _U32) \
            ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    index = index % table_size

    w = torch.where(offs[None].bool(), frac[:, None, :],
                    1.0 - frac[:, None, :])
    return index, w[..., 0] * w[..., 1] * w[..., 2]


def grid_encode(params: GridEncoderParams, cfg: GridEncoderConfig,
                positions: torch.Tensor, bound: float = 1.0
                ) -> torch.Tensor:
    """Encode (..., 3) world positions in [-bound, bound] -> (..., L * F).
    Out-of-bound points give zero features; with ``compute_dtype`` 'bf16'
    the tables are cast before the gather."""
    shape = positions.shape[:-1]
    x = positions.reshape(-1, 3)
    coords01 = (x / bound + 1.0) * 0.5
    in_bounds = torch.all((coords01 >= 0.0) & (coords01 <= 1.0), dim=-1)
    coords01 = torch.clamp(coords01, 0.0, 1.0)

    tables = params.tables
    if cfg.compute_dtype == "bf16":
        tables = tables.to(torch.bfloat16)
    feats = []
    for level in range(cfg.num_levels):
        idx, w = _level_indices(
            coords01, cfg.level_scale(level), cfg.level_resolution(level),
            cfg.level_table_size(level), cfg.gridtype)
        emb = tables[level][idx]                    # (N, 8, F)
        feats.append(torch.sum(emb * w[..., None], dim=1))
    out = torch.cat(feats, dim=-1)
    out = torch.where(in_bounds[:, None], out, torch.zeros_like(out))
    return out.reshape(shape + (cfg.output_dim,))


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
    """Backbone dispatch: the hash / tiled grid or the triplane."""
    if isinstance(cfg, TriplaneConfig):
        return triplane_encode(params, cfg, positions, bound)
    return grid_encode(params, cfg, positions, bound)


def init_encoder_any(cfg, generator: torch.Generator):
    if isinstance(cfg, TriplaneConfig):
        return init_triplane(cfg, generator)
    return init_grid_encoder(cfg, generator)


def enc_cfg_from_nerf(nerf_cfg):
    """The field encoder's config from a ``NeRFConfig``: the one place the
    ``nerf.backbone`` setting maps to a layout, so stage 1 and stage 2
    agree on it."""
    if nerf_cfg.backbone == "triplane":
        return TriplaneConfig(resolution=nerf_cfg.triplane_resolution,
                              feature_dim=nerf_cfg.triplane_dim,
                              compute_dtype=nerf_cfg.grid_dtype)
    return GridEncoderConfig(
        num_levels=nerf_cfg.num_levels,
        level_dim=nerf_cfg.level_dim,
        base_resolution=nerf_cfg.base_resolution,
        desired_resolution=int(nerf_cfg.desired_resolution * nerf_cfg.bound),
        log2_hashmap_size=nerf_cfg.log2_hashmap_size,
        gridtype="tiled" if nerf_cfg.backbone == "tiledgrid" else "hash",
        compute_dtype=nerf_cfg.grid_dtype,
    )


def frequency_encode(x: torch.Tensor, degree: int = 6,
                     include_input: bool = True) -> torch.Tensor:
    """Sin/cos positional encoding."""
    out = [x] if include_input else []
    for d in range(degree):
        s = x * (2.0 ** d)
        out.append(torch.sin(s))
        out.append(torch.cos(s))
    return torch.cat(out, dim=-1)


def freq_output_dim(input_dim: int, degree: int = 6,
                    include_input: bool = True) -> int:
    """The width of ``frequency_encode``'s output."""
    return input_dim * (2 * degree + (1 if include_input else 0))

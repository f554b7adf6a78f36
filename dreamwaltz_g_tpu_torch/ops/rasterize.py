"""3D Gaussian Splatting rasterizer, eval path.

Port of the eval branch of ``dreamwaltz_g_tpu/ops/rasterize.py``:

1. **project**: EWA splatting -- camera-space transform, perspective
   Jacobian, 2D covariance + conic, radius, culling.
2. **bin**: every Gaussian emits up to D (tile, quantized depth) keys; one
   stable sort yields per-tile contiguous, depth-ordered segments of the
   sorted entry array (``bin_gaussians_sorted``).
3. **blend**: each tile composites its segment front to back
   (``ops/blend.py:blend_sorted``, a CUDA kernel on the card).

The differentiable (T, K)-table path of the training step is not ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import math

import torch

from ..utils.transforms import quat_to_matrix
from .blend import blend_sorted


class Gaussians2D(NamedTuple):
    """Screen-space Gaussians (index order = input order)."""

    means2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor     # (N, 3) inverse 2D covariance packed (a, b, c)
    depth: torch.Tensor     # (N,) camera-space z
    radius: torch.Tensor    # (N,) screen-space extent in pixels (0 = culled)
    opacity: torch.Tensor   # (N,)
    colors: torch.Tensor    # (N, CH)
    mask: torch.Tensor      # (N,) bool -- visible & alive


def covariance3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T from unit quaternions (N, 4) and scales (N, 3)."""
    M = quat_to_matrix(quats) * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmatrix: torch.Tensor,
    intrinsics: torch.Tensor,
    image_height: int,
    image_width: int,
    tanfov: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    z_near: float = 0.2,
    blur: float = 0.3,
) -> Gaussians2D:
    """EWA projection of 3D Gaussians to screen space.

    viewmatrix (4, 4) is world->camera; intrinsics (3, 3) has fx > 0,
    fy < 0; ``tanfov`` clamps the Jacobian to the frustum."""
    W = viewmatrix[:3, :3]
    t = means3d @ W.T + viewmatrix[:3, 3]
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]

    tz_safe = torch.clamp(tz, min=1e-6)
    u = fx * tx / tz_safe + cx
    v = fy * ty / tz_safe + cy
    means2d = torch.stack([u, v], dim=-1)

    if tanfov is None:
        tanfov = image_height / (2.0 * torch.abs(fy))
    lim = 1.3 * tanfov
    txz = torch.clamp(tx / tz_safe, -lim, lim)
    tyz = torch.clamp(ty / tz_safe, -lim, lim)

    # J rows: j0 = [fx/z, 0, -fx*txz/z], j1 = [0, fy/z, -fy*tyz/z];
    # JM = J @ W row by row, then cov2d = JM Sigma JM^T, unrolled
    j00 = fx / tz_safe
    j02 = -fx * txz / tz_safe
    j11 = fy / tz_safe
    j12 = -fy * tyz / tz_safe
    W0, W1, W2 = W[0], W[1], W[2]
    m0 = j00[:, None] * W0[None, :] + j02[:, None] * W2[None, :]   # (N, 3)
    m1 = j11[:, None] * W1[None, :] + j12[:, None] * W2[None, :]   # (N, 3)
    s0 = (m0[:, 0:1] * cov3d[:, 0, :] + m0[:, 1:2] * cov3d[:, 1, :]
          + m0[:, 2:3] * cov3d[:, 2, :])
    s1 = (m1[:, 0:1] * cov3d[:, 0, :] + m1[:, 1:2] * cov3d[:, 1, :]
          + m1[:, 2:3] * cov3d[:, 2, :])
    a = torch.sum(s0 * m0, dim=-1) + blur
    b = torch.sum(s0 * m1, dim=-1)
    c = torch.sum(s1 * m1, dim=-1) + blur
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    visible = (tz > z_near) & (det > 0)
    if alive is not None:
        visible = visible & alive
    visible = visible & (u + radius > 0) & (u - radius < image_width) \
        & (v + radius > 0) & (v - radius < image_height)
    radius = torch.where(visible, radius, torch.zeros_like(radius))

    return Gaussians2D(means2d=means2d, conic=conic, depth=tz, radius=radius,
                       opacity=opacities, colors=colors, mask=visible)


def _overflow_fraction(raw_counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """Fraction of tile entries dropped by the per-tile capacity cap
    (0.0 means every binned entry was blended)."""
    dropped = torch.sum(torch.clamp(raw_counts - capacity, min=0))
    total = torch.clamp(torch.sum(raw_counts), min=1)
    return dropped.float() / total.float()


def bin_gaussians_sorted(
    means2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    mask: torch.Tensor,
    image_height: int,
    image_width: int,
    tile_size: int = 32,
    capacity: int = 1024,
    max_tiles_per_gaussian: int = 8,
):
    """Sorted-segment binning. Returns ``(s_idx, seg_start, counts,
    overflow)``: tile t's depth-ordered entries are the Gaussians
    ``s_idx[seg_start[t] : seg_start[t] + counts[t]]``, counts capped at
    ``capacity``. All int32.

    The key is ``tile * 2^qbits + qdepth`` with depth quantized to qbits
    bits, so one sort gives contiguous depth-ordered tile segments; entries
    of no tile get tile T and sink to the end. The sort is stable, so ties
    keep Gaussian order."""
    dev = means2d.device
    N = means2d.shape[0]
    D = max_tiles_per_gaussian
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    T = Tx * Ty

    # <= 22 bits keeps the float->int conversion exact in f32
    qbits = min(22, 31 - int(math.ceil(math.log2(T + 2))))
    qmax = (1 << qbits) - 1
    inf = torch.tensor(float("inf"), device=dev)
    dmin = torch.min(torch.where(mask, depth, inf))
    dmax = torch.max(torch.where(mask, depth, -inf))
    qdepth = torch.clamp(
        ((depth - dmin) / torch.clamp(dmax - dmin, min=1e-9)
         * (qmax - 1)).to(torch.int32),
        0, qmax - 1)

    x, y = means2d[:, 0], means2d[:, 1]
    r = radius

    def tile_range(lo, n):
        return torch.clamp(torch.floor(lo / tile_size), 0, n - 1).to(torch.int32)

    txmin, txmax = tile_range(x - r, Tx), tile_range(x + r, Tx)
    tymin, tymax = tile_range(y - r, Ty), tile_range(y + r, Ty)
    sw = (txmax - txmin + 1)[:, None]
    sh = (tymax - tymin + 1)[:, None]

    d = torch.arange(D, dtype=torch.int32, device=dev)[None, :]   # (1, D)
    dx = d % sw
    dy = d // sw
    valid = mask[:, None] & (d < sw * sh) & (dy < sh) & (r[:, None] > 0)
    tile_id = (tymin[:, None] + dy) * Tx + (txmin[:, None] + dx)
    tile_id = torch.where(valid, tile_id, T)

    flat_tile = tile_id.reshape(-1)
    flat_q = qdepth[:, None].expand(N, D).reshape(-1)
    key = flat_tile * (qmax + 1) + torch.where(flat_tile < T, flat_q, qmax)
    s_key, perm = torch.sort(key, stable=True)
    s_idx = (perm // D).to(torch.int32)   # entry n*D + j belongs to Gaussian n

    bounds = torch.arange(T + 1, dtype=torch.int32, device=dev) * (qmax + 1)
    seg = torch.searchsorted(s_key, bounds, right=False).to(torch.int32)
    seg_start = seg[:T]
    raw = seg[1:] - seg_start
    counts = torch.clamp(raw, max=capacity)
    return s_idx, seg_start, counts, _overflow_fraction(raw, capacity)


class RasterOutput(NamedTuple):
    image: torch.Tensor   # (H, W, CH)
    alpha: torch.Tensor   # (H, W)
    depth: torch.Tensor   # (H, W) alpha-weighted expected depth
    radii: torch.Tensor   # (N,) screen radii (0 = culled)
    overflow: Any = None  # () fraction of binned entries dropped by the cap


def rasterize_projected(
    g: Gaussians2D,
    image_height: int,
    image_width: int,
    tile_size: int = 32,
    capacity: int = 1024,
    chunk: int = 128,
    max_tiles_per_gaussian: int = 8,
) -> RasterOutput:
    """Bin + blend already-projected Gaussians (the eval render, forward
    only). On the card the blend is the CUDA kernel; on the CPU its plain
    version."""
    CH = g.colors.shape[-1]
    s_idx, seg_start, counts, overflow = bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, image_height, image_width,
        tile_size, capacity, max_tiles_per_gaussian)
    N = g.colors.shape[0]
    values = torch.cat(
        [g.colors, g.depth[:, None],
         torch.ones((N, 1), dtype=g.colors.dtype, device=g.colors.device)],
        dim=-1)
    out = blend_sorted(
        s_idx, seg_start, counts, g.means2d, g.conic,
        g.opacity * g.mask.to(g.opacity.dtype), values,
        image_height, image_width, tile_size=tile_size, chunk=chunk,
        capacity=capacity)
    return RasterOutput(image=out[..., :CH], alpha=out[..., CH + 1],
                        depth=out[..., CH], radii=g.radius, overflow=overflow)


def rasterize_reference(
    g: Gaussians2D, image_height: int, image_width: int,
    alpha_clip: float = 0.999, min_alpha: float = 1.0 / 255.0,
) -> torch.Tensor:
    """O(N.H.W) per-pixel blending in exact front-to-back depth order
    (test oracle). Returns (H, W, CH + 2): [colors..., depth, alpha]."""
    dev = g.means2d.device
    inf = torch.tensor(float("inf"), device=dev)
    order = torch.argsort(torch.where(g.mask, g.depth, inf), stable=True)
    xy = g.means2d[order]
    con = g.conic[order]
    op = torch.where(g.mask, g.opacity, torch.zeros_like(g.opacity))[order]
    N, CH = g.colors.shape
    values = torch.cat([g.colors, g.depth[:, None],
                        torch.ones((N, 1), device=dev)], dim=-1)[order]
    # radius-culled splats do not contribute (parity with the tiled path)
    op = torch.where(g.radius[order] > 0, op, torch.zeros_like(op))

    yy, xx = torch.meshgrid(torch.arange(image_height, device=dev),
                            torch.arange(image_width, device=dev),
                            indexing="ij")
    px = xx.float() + 0.5
    py = yy.float() + 0.5
    log_t = torch.zeros((image_height, image_width), device=dev)
    acc = torch.zeros((image_height, image_width, CH + 2), device=dev)
    for i in range(N):
        dx = px - xy[i, 0]
        dy = py - xy[i, 1]
        q = con[i, 0] * dx * dx + 2 * con[i, 1] * dx * dy + con[i, 2] * dy * dy
        w = op[i] * torch.exp(-0.5 * q)
        w = torch.where((q >= 0) & (w >= min_alpha),
                        torch.clamp(w, max=alpha_clip), torch.zeros_like(w))
        acc = acc + (torch.exp(log_t) * w)[..., None] * values[i]
        log_t = log_t + torch.log1p(-w)
    return acc

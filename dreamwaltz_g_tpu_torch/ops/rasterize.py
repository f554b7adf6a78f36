"""3D Gaussian Splatting rasterizer.

Port of ``dreamwaltz_g_tpu/ops/rasterize.py``:

1. **project**: EWA splatting -- camera-space transform, perspective
   Jacobian, 2D covariance + conic, radius, culling.
2. **bin**: every Gaussian emits up to D (tile, quantized depth) keys; one
   stable sort yields per-tile contiguous, depth-ordered segments of the
   sorted entry array. The render reads them as segments
   (``bin_gaussians_sorted``), training as a (T, K) table
   (``bin_gaussians``).
3. **blend**: each tile composites its entries front to back. The render
   takes ``ops/blend.py:blend_sorted`` (B2); training the differentiable
   ``ops/blend_train.py:blend_tiles_train`` (B1 forward and backward); each
   is a CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import math

import torch
from torch.profiler import record_function

from ..utils.transforms import quat_to_matrix
from .blend import _tile_pixel_centres, _untile, blend_sorted
from .blend_train import blend_tiles_eval, blend_tiles_train


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


def _sorted_entries(means2d, radius, depth, mask, image_height, image_width,
                    tile_size, max_tiles_per_gaussian):
    """The binning sort shared by both tables. Every Gaussian emits up to D
    (tile, quantized depth) keys ``tile * 2^qbits + qdepth`` (depth quantized
    to qbits bits); entries of no tile get tile T and sink to the end. One
    stable sort yields per-tile contiguous, depth-ordered segments, ties in
    Gaussian order. Returns ``(s_key, s_idx, seg)``: the sorted keys, the
    Gaussian of each sorted entry (int32), and the T + 1 segment bounds."""
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
    return s_key, s_idx, seg


def bin_gaussians(
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
    """Depth-ordered tile index table (the training blend's input).

    Returns ``(tile_lists, tile_counts, overflow)``: tile_lists (T, K =
    capacity) int32 with sentinel N in empty slots, tile_counts (T,) int32
    (capped at ``capacity``), and the fraction of entries the cap dropped.
    Tile t's first ``capacity`` sorted entries are read straight out of its
    segment, as the JAX package does (a (T, K) gather, no scatter)."""
    N = means2d.shape[0]
    D = max_tiles_per_gaussian
    _, s_idx, seg = _sorted_entries(means2d, radius, depth, mask,
                                    image_height, image_width, tile_size, D)
    seg_start, seg_end = seg[:-1], seg[1:]
    src = seg_start[:, None] + torch.arange(capacity, dtype=torch.int32,
                                            device=means2d.device)[None, :]
    in_seg = src < seg_end[:, None]
    idx_at = s_idx[torch.clamp(src, max=N * D - 1).long()]
    tile_lists = torch.where(in_seg, idx_at, N).to(torch.int32)
    raw = seg_end - seg_start
    tile_counts = torch.clamp(raw, max=capacity).to(torch.int32)
    return tile_lists, tile_counts, _overflow_fraction(raw, capacity)


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
    ``capacity``. All int32. No (T, K) table is built."""
    _, s_idx, seg = _sorted_entries(means2d, radius, depth, mask,
                                    image_height, image_width, tile_size,
                                    max_tiles_per_gaussian)
    seg_start = seg[:-1]
    raw = seg[1:] - seg_start
    counts = torch.clamp(raw, max=capacity)
    return s_idx, seg_start, counts, _overflow_fraction(raw, capacity)


# ---------------------------------------------------------------------------
# Tile blending over the (T, K) table
# ---------------------------------------------------------------------------

def _tile_pixel_coords(image_height: int, image_width: int, tile_size: int,
                       device=None) -> torch.Tensor:
    """(T, P, 2) pixel centres, tiles row-major, pixels row-major."""
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    return _tile_pixel_centres(Tx, Ty, tile_size, device)


def blend_tiles(
    tile_lists: torch.Tensor,
    g: "Gaussians2D",
    image_height: int,
    image_width: int,
    tile_size: int = 32,
    chunk: int = 128,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
) -> torch.Tensor:
    """Front-to-back alpha blending over the (T, K) tile lists, in chunks of
    ``chunk`` entries with no early stop; plain PyTorch that autograd
    differentiates (the test oracle for the training blend's gradients).

    Returns (H, W, CH + 2): [colors..., accumulated depth, weights_sum].
    The JAX version rematerialises each chunk in its backward
    (``jax.checkpoint``); here autograd keeps every chunk's intermediates,
    which is fine at the sizes it is used at."""
    T, K = tile_lists.shape
    N, CH = g.colors.shape
    dev = g.colors.device
    C = min(chunk, K)
    n_chunks = -(-K // C)
    if K % C:   # pad lists to a chunk multiple with the sentinel
        tile_lists = torch.cat([tile_lists, torch.full(
            (T, n_chunks * C - K), N, dtype=tile_lists.dtype, device=dev)], 1)

    def pad1(a):   # sentinel N is a dead Gaussian
        return torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype,
                                         device=dev)])

    means2d = pad1(g.means2d)
    conic = pad1(g.conic)
    opacity = pad1(g.opacity * g.mask.to(g.opacity.dtype))
    values = pad1(torch.cat([g.colors, g.depth[:, None],
                             torch.ones((N, 1), dtype=g.colors.dtype,
                                        device=dev)], -1))
    CV = CH + 2
    pix = _tile_pixel_coords(image_height, image_width, tile_size, dev)
    P = pix.shape[1]

    idx_all = tile_lists.long()
    log_t = torch.zeros((T, P), device=dev)
    acc = torch.zeros((T, P, CV), device=dev)
    for k in range(n_chunks):
        idx = idx_all[:, k * C:(k + 1) * C]        # (T, C)
        xy, con, op, val = means2d[idx], conic[idx], opacity[idx], values[idx]
        dx = pix[:, :, None, 0] - xy[:, None, :, 0]   # (T, P, C)
        dy = pix[:, :, None, 1] - xy[:, None, :, 1]
        q = (con[:, None, :, 0] * dx * dx
             + 2.0 * con[:, None, :, 1] * dx * dy
             + con[:, None, :, 2] * dy * dy)
        w = op[:, None, :] * torch.exp(-0.5 * q)
        w = torch.where((q >= 0) & (w >= min_alpha),
                        torch.clamp(w, max=alpha_clip), torch.zeros_like(w))
        l = torch.log1p(-w)
        incl = torch.cumsum(l, dim=-1)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                         dim=-1) + log_t[..., None]
        contrib = torch.exp(excl) * w
        acc = acc + torch.bmm(contrib, val)
        log_t = log_t + incl[..., -1]
    return _untile(acc, CV, image_height, image_width, tile_size)


def _blend_dispatch(tile_lists, means2d, conic, opacity, colors, depth, mask,
                    image_height, image_width, tile_size, chunk,
                    tile_counts=None, mode="train"):
    """The table blend's kernels. ``mode='train'`` takes the differentiable
    pair (``blend_train.blend_tiles_train``: the B1 forward and backward
    kernels on the card); ``'eval'`` the forward-only kernel over the same
    table (``blend_train.blend_tiles_eval``, B3)."""
    N = colors.shape[0]
    values = torch.cat([colors, depth[:, None],
                        torch.ones((N, 1), dtype=colors.dtype,
                                   device=colors.device)], -1)
    op = opacity * mask.to(opacity.dtype)
    if tile_counts is None:
        tile_counts = torch.sum(tile_lists < N, dim=-1).to(torch.int32)
    kw = dict(tile_size=tile_size, chunk=chunk)
    if mode == "eval":
        return blend_tiles_eval(tile_lists, tile_counts, means2d, conic, op,
                                values, image_height, image_width, **kw)
    if mode == "train":
        return blend_tiles_train(tile_lists, tile_counts, means2d, conic, op,
                                 values, image_height, image_width, **kw)
    raise ValueError(f"mode must be 'train' or 'eval', got {mode!r}")


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
    mode: str = "train",
) -> RasterOutput:
    """Bin + blend already-projected Gaussians.

    ``mode='train'`` (the default, as in the JAX package) bins into the
    (T, K) table and blends through the differentiable training blend:
    gradients flow to every float field of ``g``; the binning is an index
    structure built from detached inputs. ``mode='eval'`` bins into sorted
    segments and blends forward only (the render path). On the card each
    blend is a CUDA kernel; on the CPU its plain version."""
    CH = g.colors.shape[-1]
    if mode == "eval":
        s_idx, seg_start, counts, overflow = bin_gaussians_sorted(
            g.means2d.detach(), g.radius.detach(), g.depth.detach(), g.mask,
            image_height, image_width, tile_size, capacity,
            max_tiles_per_gaussian)
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
    elif mode == "train":
        with record_function("rasterize.bin"):
            tile_lists, tile_counts, overflow = bin_gaussians(
                g.means2d.detach(), g.radius.detach(), g.depth.detach(),
                g.mask, image_height, image_width, tile_size, capacity,
                max_tiles_per_gaussian)
        with record_function("rasterize.blend"):
            out = _blend_dispatch(
                tile_lists, g.means2d, g.conic, g.opacity, g.colors, g.depth,
                g.mask, image_height, image_width, tile_size, chunk,
                tile_counts=tile_counts, mode="train")
    else:
        raise ValueError(f"mode must be 'train' or 'eval', got {mode!r}")
    return RasterOutput(image=out[..., :CH], alpha=out[..., CH + 1],
                        depth=out[..., CH], radii=g.radius, overflow=overflow)


def rasterize(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmatrix: torch.Tensor,
    intrinsics: torch.Tensor,
    image_height: int,
    image_width: int,
    alive: Optional[torch.Tensor] = None,
    tanfov: Optional[torch.Tensor] = None,
    tile_size: int = 32,
    capacity: int = 1024,
    chunk: int = 128,
    max_tiles_per_gaussian: int = 8,
    mode: str = "train",
) -> RasterOutput:
    """One-call rasterization from 3D Gaussian parameters: covariance ->
    project -> ``rasterize_projected`` (``mode`` as there; the JAX
    function's ``pallas_mode``)."""
    cov3d = covariance3d(quats, scales)
    g2d = project_gaussians(
        means3d, cov3d, opacities, colors, viewmatrix, intrinsics,
        image_height, image_width, tanfov=tanfov, alive=alive)
    return rasterize_projected(g2d, image_height, image_width, tile_size,
                               capacity, chunk, max_tiles_per_gaussian,
                               mode=mode)


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

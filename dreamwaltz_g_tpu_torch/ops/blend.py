"""Sorted-segment tile blend: the CUDA kernel's wrapper and its plain version.

Port of ``dreamwaltz_g_tpu/ops/pallas_blend.py:blend_sorted_pallas``. Tile
t composites the Gaussians ``s_idx[seg_start[t] : seg_start[t] + counts[t]]``
(depth-ordered by ``rasterize.bin_gaussians_sorted``) front to back over its
``tile_size**2`` pixels.

* ``blend_sorted`` launches ``csrc/blend_sorted.cu`` for CUDA tensors and
  takes the plain version for CPU tensors. It counts its kernel launches in
  ``blend_sorted.launches``.
* ``blend_sorted_reference`` is the TPU kernel's algorithm in float32
  PyTorch: per-chunk log-transmittance prefix over C-aligned chunks of the
  sorted rows, rows outside the tile's segment masked, and the tile stops at
  a chunk boundary once every pixel's log T is below ln(1e-4).
* ``footprint_boxes`` and ``patch_keep`` are the plain twins of the
  kernels' footprint cull (``csrc/blend_common.cuh``): each entry's box of
  the pixel centres where its weight can pass min_alpha, and which 8 x 4
  pixel patches of a tile it reaches.

The two differ by design: the kernel stops per pixel as soon as its T falls
below the threshold, the plain version per tile at chunk boundaries. What
the plain version adds after a pixel stopped is at most
``exp(LOG_T_EPS) * |value|`` (about 1e-4 of the value).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import kernels

#: ln(1e-4) as the TPU kernel writes it: a pixel is live while log T > this
LOG_T_EPS = -9.2
#: rows of a tile each block of the sorted blend and the table backward
#: covers (csrc/blend_common.cuh kBlockRows): 4 blocks a 32^2 tile
BLOCK_ROWS = 8
#: the cull's margins (csrc/blend_common.cuh): relative error of the
#: kernel's w, error of its q relative to kappa q, and the largest kappa
#: = (ca + cc)^2 / det that may be culled
CULL_EPS_W = 2.0 ** -20
CULL_GAMMA = 2.0 ** -21
CULL_KAPPA_MAX = 0.25 / CULL_GAMMA
#: pixels of a warp's patch: 8 wide, 4 tall
PATCH_W, PATCH_H = 8, 4


def pack_rows(means2d: torch.Tensor, conic: torch.Tensor,
              opacity: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(..., N + 1, 16) float32 rows [mx, my, ca, cb, cc, op, 0, 0,
    values..., 0...]; row N is all zero (the padding Gaussian). Leading
    dimensions (views) pass through."""
    *lead, N, CV = values.shape
    if CV > 8:
        raise ValueError(f"at most 8 value channels, got {CV}")
    f32 = torch.float32
    z = torch.zeros((*lead, N, 1), dtype=f32, device=means2d.device)
    packed = torch.cat(
        [means2d.to(f32), conic.to(f32), opacity[..., None].to(f32), z, z,
         values.to(f32)] + [z] * (8 - CV), dim=-1)
    return torch.cat([packed, torch.zeros((*lead, 1, 16), dtype=f32,
                                          device=means2d.device)], dim=-2)


def footprint_boxes(packed: torch.Tensor,
                    min_alpha: float = 1.0 / 255.0) -> torch.Tensor:
    """Each packed row's box ``[x_lo, x_hi, y_lo, y_hi]`` (float64) of the
    pixel centres where its weight can pass ``w >= min_alpha``: the ellipse
    q <= 2 ln(op / min_alpha) of a positive-definite conic, widened (with
    ``margin``) past the float32 rounding of q, exp and the products, as
    ``csrc/blend_common.cuh`` argues. The whole plane (never culled) for a
    conic with det <= 0 or ca <= 0, one too thin for the margin's bound, or
    a non-finite attribute; the empty box (inf, -inf, inf, -inf) where op
    (1 + eps) < min_alpha, op = 0 rows included. The kernels compute the same
    box and round it outward to float32."""
    a = packed.double()
    mx, my, ca, cb, cc, op = (a[..., i] for i in range(6))
    # the kernels compare against min_alpha as a float32
    ma = torch.tensor(min_alpha, dtype=torch.float32).double()
    det = ca * cc - cb * cb
    kappa = (ca + cc) ** 2 / det
    r = torch.clamp(2.0 * torch.log(op / ma) + 2.0 * CULL_EPS_W, min=0.0) \
        / (1.0 - 2.0 * CULL_GAMMA * kappa) * (1.0 + 2.0 ** -30)
    hx = torch.sqrt(r * cc / det)
    hy = torch.sqrt(r * ca / det)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], -1)
    bounded = (det > 0) & (ca > 0) & (kappa <= CULL_KAPPA_MAX) \
        & torch.isfinite(op) & torch.isfinite(box).all(-1)
    inf = float("inf")
    box = torch.where(bounded[..., None], box,
                      box.new_tensor([-inf, inf, -inf, inf]))
    return torch.where((op * (1.0 + CULL_EPS_W) < ma)[..., None],
                       box.new_tensor([inf, -inf, inf, -inf]), box)


def patch_keep(boxes: torch.Tensor, tile_size: int,
               tiles_x: int) -> torch.Tensor:
    """Which patches of its tile each entry reaches: ``boxes`` (..., T, E, 4)
    from ``footprint_boxes`` for tile t's entries -> (..., T, n_patches, E)
    bool, True where the box holds one of the patch's pixel centres (the
    kernels' warp-level cull keeps the pair)."""
    T = boxes.shape[-3]
    dev = boxes.device
    t = torch.arange(T, device=dev)
    pr, pc = torch.meshgrid(torch.arange(tile_size // PATCH_H, device=dev),
                            torch.arange(tile_size // PATCH_W, device=dev),
                            indexing="ij")
    x0 = ((t % tiles_x) * tile_size)[:, None] + (pc * PATCH_W).reshape(-1) \
        + 0.5                                              # (T, n_patches)
    y0 = ((t // tiles_x) * tile_size)[:, None] + (pr * PATCH_H).reshape(-1) \
        + 0.5
    b = boxes[..., None, :, :]                            # (..., T, 1, E, 4)
    x0, y0 = x0[..., None].double(), y0[..., None].double()
    return ((b[..., 1] >= x0) & (b[..., 0] <= x0 + PATCH_W - 1)
            & (b[..., 3] >= y0) & (b[..., 2] <= y0 + PATCH_H - 1))


def _untile(out: torch.Tensor, CV: int, image_height: int, image_width: int,
            tile_size: int) -> torch.Tensor:
    """(..., T, P, 8) per-tile pixels -> (..., H, W, CV) image."""
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    lead = out.shape[:-3]
    img = out[..., :CV].reshape(*lead, Ty, Tx, tile_size, tile_size, CV)
    img = img.transpose(-4, -3).reshape(*lead, Ty * tile_size,
                                        Tx * tile_size, CV)
    return img[..., :image_height, :image_width, :]


def _tile(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., H, W, CV) image -> (..., T, P, 8) per-tile pixels, zero-padded
    to whole tiles and 8 lanes (the inverse of ``_untile``)."""
    *lead, H, W, CV = img.shape
    Tx = -(-W // tile_size)
    Ty = -(-H // tile_size)
    img = torch.nn.functional.pad(
        img, (0, 8 - CV, 0, Tx * tile_size - W, 0, Ty * tile_size - H))
    img = img.reshape(*lead, Ty, tile_size, Tx, tile_size, 8)
    return img.transpose(-4, -3).reshape(*lead, Ty * Tx,
                                         tile_size * tile_size, 8)


def _tile_pixel_centres(Tx: int, Ty: int, tile_size: int,
                        device) -> torch.Tensor:
    """(T, P, 2) pixel centres, tiles row-major, pixels row-major."""
    ty, tx = torch.meshgrid(torch.arange(Ty, device=device),
                            torch.arange(Tx, device=device), indexing="ij")
    base = torch.stack([tx.reshape(-1), ty.reshape(-1)], -1) * tile_size
    py, px = torch.meshgrid(torch.arange(tile_size, device=device),
                            torch.arange(tile_size, device=device),
                            indexing="ij")
    local = torch.stack([px.reshape(-1), py.reshape(-1)], -1)
    return (base[:, None, :] + local[None, :, :]).float() + 0.5


def blend_sorted_reference(
    s_idx: torch.Tensor,
    seg_start: torch.Tensor,
    counts: torch.Tensor,
    means2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    values: torch.Tensor,
    image_height: int,
    image_width: int,
    tile_size: int = 32,
    chunk: int = 128,
    capacity: int = 1024,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Plain float32 version of the TPU kernel. Returns (H, W, CV).

    ``stats``, when given, receives ``pairs``: the (pixel, entry) pairs
    before each pixel's own log T falls below ``LOG_T_EPS`` -- the work a
    per-pixel early stop has to do on these inputs --, ``blended``, those
    of them whose weight passes the min_alpha test, and ``reached``, the
    (T, P) count of them for each pixel (a prefix of its tile's segment)."""
    dev = means2d.device
    N, CV = values.shape
    C = chunk
    P = tile_size * tile_size
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    T = Tx * Ty
    n_chunks_max = capacity // C + 1   # +1 covers the misaligned first chunk

    packed = pack_rows(means2d, conic, opacity, values)
    Ns = s_idx.shape[0]
    NB = -(-Ns // C) + 1               # +1 chunk: a segment may end in it
    s_pad = torch.full((NB * C,), N, dtype=torch.long, device=dev)
    s_pad[:Ns] = s_idx.long()

    seg_start = seg_start.long()
    counts = counts.long()
    blk0 = seg_start // C
    off = seg_start - blk0 * C
    nblk = torch.where(counts > 0, (off + counts + C - 1) // C,
                       torch.zeros_like(counts))

    pix = _tile_pixel_centres(Tx, Ty, tile_size, dev)   # (T, P, 2)
    px, py = pix[..., 0:1], pix[..., 1:2]                # (T, P, 1)
    lane = torch.arange(C, device=dev)
    log_t = torch.zeros((T, P), device=dev)
    acc = torch.zeros((T, P, 8), device=dev)
    pairs = blended = 0
    reached = torch.zeros((T, P), dtype=torch.long, device=dev)
    for j in range(n_chunks_max):
        rows = torch.clamp((blk0 + j)[:, None] * C + lane, max=NB * C - 1)
        a = packed[s_pad[rows]]                           # (T, C, 16)
        pos = lane[None, :] + j * C - off[:, None]
        live = (j < nblk) & (log_t.max(dim=1).values > LOG_T_EPS)
        use = ((pos >= 0) & (pos < counts[:, None]) & live[:, None])[:, None, :]

        dx = px - a[:, None, :, 0]                        # (T, P, C)
        dy = py - a[:, None, :, 1]
        q = a[:, None, :, 2] * dx * dx + 2.0 * a[:, None, :, 3] * dx * dy \
            + a[:, None, :, 4] * dy * dy
        w = a[:, None, :, 5] * torch.exp(-0.5 * q)
        w = torch.where(use & (q >= 0) & (w >= min_alpha),
                        torch.clamp(w, max=alpha_clip), torch.zeros_like(w))
        lg = torch.log1p(-w)
        incl = torch.cumsum(lg, dim=-1)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                         dim=-1) + log_t[..., None]
        contrib = torch.exp(excl) * w
        acc = acc + torch.bmm(contrib, a[..., 8:16])
        if stats is not None:
            before_stop = (excl > LOG_T_EPS) & use
            pairs += int(before_stop.sum())
            blended += int((before_stop & (w > 0)).sum())
            reached += before_stop.sum(-1)
        log_t = log_t + incl[..., -1]
    if stats is not None:
        stats["pairs"] = pairs
        stats["blended"] = blended
        stats["reached"] = reached
    return _untile(acc, CV, image_height, image_width, tile_size)


def blend_sorted(
    s_idx: torch.Tensor,
    seg_start: torch.Tensor,
    counts: torch.Tensor,
    means2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    values: torch.Tensor,
    image_height: int,
    image_width: int,
    tile_size: int = 32,
    chunk: int = 128,
    capacity: int = 1024,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
) -> torch.Tensor:
    """Sorted-segment blend. Returns (H, W, CV) with CV = values' channels.

    CPU tensors take ``blend_sorted_reference``; CUDA tensors launch the
    kernel (``chunk`` and ``capacity`` shape only the plain version's loop;
    the kernel reads each segment whole). Anything else raises."""
    devs = {t.device for t in (s_idx, seg_start, counts, means2d, conic,
                               opacity, values)}
    if len(devs) != 1:
        raise ValueError(f"blend_sorted inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return blend_sorted_reference(
            s_idx, seg_start, counts, means2d, conic, opacity, values,
            image_height, image_width, tile_size=tile_size, chunk=chunk,
            capacity=capacity, alpha_clip=alpha_clip, min_alpha=min_alpha)
    if dev.type != "cuda":
        raise ValueError(f"blend_sorted runs on cpu or cuda, not {dev}")

    N, CV = values.shape
    P = tile_size * tile_size
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    T = Tx * Ty
    if P > 1024 or P % 32:
        raise ValueError(f"tile_size {tile_size}: need a multiple of 32 "
                         "pixels per tile, at most 1024")
    for name, t, dtype, shape in (
            ("s_idx", s_idx, torch.int32, (s_idx.shape[0],)),
            ("seg_start", seg_start, torch.int32, (T,)),
            ("counts", counts, torch.int32, (T,)),
            ("means2d", means2d, None, (N, 2)),
            ("conic", conic, None, (N, 3)),
            ("opacity", opacity, None, (N,))):
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    packed = pack_rows(means2d, conic, opacity, values)
    s_idx, seg_start, counts = (x.contiguous() for x in (s_idx, seg_start,
                                                          counts))
    out = torch.empty((T, P, 8), dtype=torch.float32, device=dev)
    fn = kernels.load("blend_sorted").blend_sorted_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(packed.data_ptr(), s_idx.data_ptr(), seg_start.data_ptr(),
                counts.data_ptr(), out.data_ptr(), T, Tx, tile_size,
                alpha_clip, min_alpha, math.exp(LOG_T_EPS), stream)
    if rc != 0:
        raise RuntimeError(f"blend_sorted kernel launch failed: CUDA error {rc}")
    blend_sorted.launches += 1
    return _untile(out, CV, image_height, image_width, tile_size)


blend_sorted.launches = 0

"""NeRF -> point cloud export: the stage-1 -> stage-2 handoff.

Port of ``dreamwaltz_g_tpu/nerf/export.py``. The resolution^3 grid query
runs on the field's device under ``no_grad``, one z slab at a time in
chunks of ``chunk`` points; thresholding, the isolated-cell filter (26
shifted int8 adds) and the compaction run there too. The optional
subsample to ``max_points`` draws from ``np.random.default_rng(seed)``
on the host, as the JAX package does, so equal kept sets give equal
subsamples.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.point_cloud import BasicPointCloud

# latent -> RGB linear decode (the public SD-latent approximation used for
# latent NeRFs)
LATENT_TO_RGB = np.asarray([
    [0.298, 0.207, 0.208],
    [0.187, 0.286, 0.173],
    [-0.158, 0.189, 0.264],
    [-0.184, -0.271, -0.473],
], np.float32)


def filter_isolated_cells(mask: torch.Tensor,
                          min_neighbors: int) -> torch.Tensor:
    """Drop dense voxels of a (R0, R1, R2) bool mask with fewer than
    ``min_neighbors`` dense cells in their 3x3x3 neighbourhood (the cell
    itself excluded)."""
    if min_neighbors <= 0:
        return mask
    p = torch.nn.functional.pad(mask.to(torch.int8), (1, 1, 1, 1, 1, 1))
    r0, r1, r2 = mask.shape
    cnt = torch.zeros(mask.shape, dtype=torch.int8, device=mask.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                cnt += p[1 + dx:1 + dx + r0, 1 + dy:1 + dy + r1,
                         1 + dz:1 + dz + r2]
    return mask & (cnt >= min_neighbors)


@torch.no_grad()
def export_point_cloud(
    model,
    resolution: int = 400,
    density_thresh: float = 10.0,
    bound: Optional[float] = None,
    max_points: Optional[int] = None,
    bbox_min: Optional[np.ndarray] = None,
    bbox_max: Optional[np.ndarray] = None,
    chunk: int = 256 ** 2,
    seed: int = 0,
    min_neighbors: int = 0,
    stats: Optional[dict] = None,
) -> BasicPointCloud:
    """Query sigma / albedo of ``model`` (a ``NeRFModel``) at the centres
    of a resolution^3 grid over [-bound, bound]^3 and keep the cells above
    ``density_thresh``.

    ``min_neighbors`` > 0 drops dense cells with fewer dense 3x3x3
    neighbours (``filter_isolated_cells``); ``bbox_min`` / ``bbox_max``
    remove the points strictly inside that box; ``max_points`` subsamples
    without replacement. ``stats``, when given, receives ``dense_cells``
    (above the threshold) and ``kept_cells`` (after the filter)."""
    bound = bound or model.bound
    r = resolution
    dev = model.planes.device
    xs = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r \
        * 2 * bound - bound
    C = model.color_channels
    sigmas = torch.empty((r, r, r), device=dev)
    colors = torch.empty((r, r, r, C), device=dev)
    gx, gy = torch.meshgrid(xs, xs, indexing="ij")   # [ix, iy]
    for iz in range(r):
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           xs[iz].expand(r * r)], -1)
        s, a = zip(*(model.density(p) for p in torch.split(pts, chunk)))
        sigmas[:, :, iz] = torch.cat(s).reshape(r, r)
        colors[:, :, iz] = torch.cat(a).reshape(r, r, C)

    dense = sigmas > density_thresh
    mask = filter_isolated_cells(dense, min_neighbors)
    if stats is not None:
        stats["dense_cells"] = int(dense.sum())
        stats["kept_cells"] = int(mask.sum())
    ix, iy, iz = torch.nonzero(mask, as_tuple=True)
    pts = torch.stack([xs[ix], xs[iy], xs[iz]], -1).cpu().numpy()
    cols = colors[ix, iy, iz].cpu().numpy()
    if cols.shape[-1] == 4:  # latent NeRF -> approximate RGB
        cols = np.clip(cols @ LATENT_TO_RGB, 0.0, 1.0)

    if bbox_min is not None and bbox_max is not None:
        inside = np.all((pts > np.asarray(bbox_min))
                        & (pts < np.asarray(bbox_max)), axis=-1)
        pts, cols = pts[~inside], cols[~inside]

    if max_points is not None and pts.shape[0] > max_points:
        rng = np.random.default_rng(seed)
        sel = rng.choice(pts.shape[0], max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    return BasicPointCloud(points=pts.astype(np.float32),
                           colors=cols.astype(np.float32))


def remove_points_inside_bboxes(pc: BasicPointCloud,
                                bboxes) -> BasicPointCloud:
    """Drop points inside any axis-aligned bbox; each bbox is an iterable
    of corner points whose min / max span the box (the
    ``--render.nerf_exclusion_bboxes`` consumer)."""
    pts = np.asarray(pc.points)
    if isinstance(bboxes[0][0], (int, float)):
        bboxes = [bboxes]
    keep = np.ones(pts.shape[0], bool)
    for bbox in bboxes:
        corners = np.asarray(bbox, np.float32)
        mn, mx = corners.min(axis=0), corners.max(axis=0)
        keep &= ~np.all((pts >= mn) & (pts <= mx), axis=-1)

    def sel(a):
        return None if a is None else np.asarray(a)[keep]

    return BasicPointCloud(points=pts[keep], colors=sel(pc.colors),
                           normals=sel(pc.normals))

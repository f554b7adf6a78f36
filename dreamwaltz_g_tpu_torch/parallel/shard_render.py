"""The Gaussian-sharded render over the data axis.

Port of ``dreamwaltz_g_tpu/parallel/shard_render.py``: for clouds too large
for one card, each rank projects its ``N / D`` slice of the Gaussians, the
projected splats ride one ``all_gather``, and each rank bins and blends
its own row block of the image against the whole projected set through the
eval blend (on the card the sorted blend, B2, once a rank); the row blocks
are gathered back. The JAX package runs this as a ``shard_map`` over its
mesh's ``data`` axis; here the axis is a process group (``mesh.py``), and
every collective is a list ``all_gather``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops import rasterize as R
from .mesh import DataMesh, gather_batch


def _pad_axis0(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def row_block(g2d: "R.Gaussians2D", row0: int, Hd: int) -> "R.Gaussians2D":
    """The splats of the ``Hd`` rows from ``row0`` of a frame projected
    whole: shifted to the block's rows, those outside it dropped (mask
    off, radius 0). Projection culled against the whole frame, so without
    the drop every other block's splats would clamp into the border tile
    rows and take their capacity in depth order, evicting the block's
    own."""
    shift = torch.tensor([0.0, float(row0)], device=g2d.means2d.device)
    g2d = g2d._replace(means2d=g2d.means2d - shift)
    y = g2d.means2d[:, 1]
    ov = (y + g2d.radius > 0) & (y - g2d.radius < Hd)
    return g2d._replace(mask=g2d.mask & ov, radius=torch.where(
        ov, g2d.radius, torch.zeros_like(g2d.radius)))


def make_sharded_render(
    mesh: DataMesh,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 16,
) -> Callable:
    """Returns ``render(positions, quats, scales, opacities, colors, alive,
    extrinsic, intrinsics, tanfov, background) -> (image, alpha, depth)``:
    the whole cloud and the whole (H, W, 3) background in on every rank,
    the whole frame out on every rank (module docstring). Each rank's row
    block is ``Hd`` rows, ``ceil(H / D)`` rounded up to a whole tile, so
    the binning stays exact; the frame is rendered at ``D * Hd`` rows and
    cropped to ``H``."""
    D = mesh.world
    H, W = image_height, image_width
    Hd = -(-H // D)
    Hd = -(-Hd // tile_size) * tile_size
    H_pad = Hd * D
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="eval")

    @torch.no_grad()
    def render(positions, quats, scales, opacities, colors, alive,
               extrinsic, intrinsics, tanfov, background
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        N = positions.shape[0]
        Np = -(-N // D) * D
        n, r = Np // D, mesh.rank
        valid = torch.arange(Np, device=positions.device) < N
        alive_p = valid if alive is None \
            else _pad_axis0(alive, Np) & valid
        mine = slice(r * n, (r + 1) * n)
        p, q, s, o, c = (_pad_axis0(x, Np)[mine] for x in
                         (positions, quats, scales, opacities, colors))
        # this rank's slice, projected against the padded frame
        g2d = R.project_gaussians(p, R.covariance3d(q, s), o, c, extrinsic,
                                  intrinsics, H_pad, W, tanfov=tanfov,
                                  alive=alive_p[mine])
        # every rank's projected splats, in rank order
        g2d = R.Gaussians2D(*[gather_batch(x, mesh) for x in g2d])
        row0 = r * Hd
        out = R.rasterize_projected(row_block(g2d, row0, Hd), Hd, W,
                                    **raster)
        bg = _pad_axis0(background, H_pad)[row0:row0 + Hd]
        img = out.image + (1.0 - out.alpha)[..., None] * bg
        img, alpha, depth = (gather_batch(x, mesh)
                             for x in (img, out.alpha, out.depth))
        return img[:H], alpha[:H], depth[:H]

    return render

"""Ray casting and mesh depth / normal rendering.

Port of ``dreamwaltz_g_tpu/ops/raycast.py``, torch ops on the mesh's
device:

* ``cast_rays``: Moller-Trumbore ray / triangle intersection, brute force
  over (ray chunk x F) tiles, nearest hit t and primitive (or sub-geometry)
  id. The condition renderer's occlusion culling casts ~128 rays a view
  against the posed body.
* ``rasterize_mesh``: a tile-binned z-buffer for depth / normal / mask
  images (the depth and normal conditions): triangles binned to pixel
  tiles by their screen boxes (at most ``max_tiles_per_triangle`` tiles a
  triangle, ``capacity`` triangles a tile, as in the JAX package), then a
  depth min over each tile's barycentric-inside triangles with 1/z
  interpolated across the screen triangle.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def cast_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    vertices: torch.Tensor,
    faces,
    geometry_sizes: Optional[Tuple[int, ...]] = None,
    ray_chunk: int = 1024,
    eps: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of each (R, 3) ray against the (V, 3) / (F, 3) mesh.

    Returns (t_hit (R,), inf without a hit; id (R,) int32: the hit
    triangle, or with ``geometry_sizes`` (triangles a sub-geometry) the
    index of the sub-geometry it belongs to; -1 without a hit). ``t`` is in
    units of |d|."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    tri = vertices[faces]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    e1 = b - a
    e2 = c - a
    ts, prims = [], []
    for o, d in zip(torch.split(rays_o, ray_chunk),
                    torch.split(rays_d, ray_chunk)):
        pvec = torch.linalg.cross(d[:, None, :].expand(-1, e2.shape[0], 3),
                                  e2[None].expand(d.shape[0], -1, 3))
        det = torch.sum(e1[None] * pvec, -1)                     # (r, F)
        ok = det.abs() > eps
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                    torch.ones_like(det)),
                              torch.zeros_like(det))
        tvec = o[:, None, :] - a[None]
        u = torch.sum(tvec * pvec, -1) * inv_det
        qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
        v = torch.sum(d[:, None, :] * qvec, -1) * inv_det
        t = torch.sum(e2[None] * qvec, -1) * inv_det
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_best, prim = torch.min(t, dim=-1)
        prim = torch.where(torch.isfinite(t_best), prim,
                           torch.full_like(prim, -1))
        ts.append(t_best)
        prims.append(prim.to(torch.int32))
    t_hit, prim = torch.cat(ts), torch.cat(prims)
    if geometry_sizes is not None:
        bounds = torch.cumsum(torch.as_tensor(geometry_sizes,
                                              device=prim.device), 0)
        geom = torch.searchsorted(bounds, prim.long(), right=True)
        prim = torch.where(prim >= 0, geom.to(torch.int32), prim)
    return t_hit, prim


class MeshRender(NamedTuple):
    depth: torch.Tensor    # (H, W) camera-space z; inf where no coverage
    normal: torch.Tensor   # (H, W, 3) world-space face normal at the hit
    mask: torch.Tensor     # (H, W) bool coverage
    prim: torch.Tensor     # (H, W) int32 winning triangle (-1 = none)


def rasterize_mesh(
    vertices: torch.Tensor,
    faces,
    extrinsic: torch.Tensor,
    intrinsics: torch.Tensor,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_triangle: int = 32,
    z_near: float = 1e-4,
) -> MeshRender:
    """Z-buffer rasterization of a triangle mesh; intrinsics follow the
    repo's convention (fy < 0, a y-flip)."""
    dev = vertices.device
    faces = torch.as_tensor(faces, device=dev).long()
    cam = vertices @ extrinsic[:3, :3].T + extrinsic[:3, 3]     # (V, 3)
    z = cam[:, 2]
    z_safe = torch.clamp(z, min=z_near)
    u = intrinsics[0, 0] * cam[:, 0] / z_safe + intrinsics[0, 2]
    v = intrinsics[1, 1] * cam[:, 1] / z_safe + intrinsics[1, 2]
    pts2 = torch.stack([u, v], -1)                               # (V, 2)

    tv = pts2[faces]                                             # (F, 3, 2)
    tz = z[faces]                                                # (F, 3)
    front = torch.all(tz > z_near, dim=-1)

    F = faces.shape[0]
    D = max_tiles_per_triangle
    Tx = -(-image_width // tile_size)
    Ty = -(-image_height // tile_size)
    T = Tx * Ty
    xmin, xmax = tv[..., 0].min(-1).values, tv[..., 0].max(-1).values
    ymin, ymax = tv[..., 1].min(-1).values, tv[..., 1].max(-1).values
    visible = front & (xmax > 0) & (xmin < image_width) \
        & (ymax > 0) & (ymin < image_height)

    def tile_of(x, n):
        return torch.clamp(torch.floor(x / tile_size), 0, n - 1).long()

    txmin, txmax = tile_of(xmin, Tx), tile_of(xmax, Tx)
    tymin, tymax = tile_of(ymin, Ty), tile_of(ymax, Ty)
    sw = txmax - txmin + 1
    sh = tymax - tymin + 1
    d = torch.arange(D, device=dev)[None, :]
    dx = d % sw[:, None]
    dy = torch.div(d, sw[:, None], rounding_mode="floor")
    valid = visible[:, None] & (d < sw[:, None] * sh[:, None]) \
        & (dy < sh[:, None])
    tile_id = (tymin[:, None] + dy) * Tx + (txmin[:, None] + dx)
    tile_id = torch.where(valid, tile_id, torch.full_like(tile_id, T))

    flat_tile = tile_id.reshape(-1)
    flat_idx = torch.arange(F, device=dev)[:, None].expand(F, D).reshape(-1)
    s_tile, order = torch.sort(flat_tile, stable=True)
    s_idx = flat_idx[order]
    seg_start = torch.searchsorted(s_tile, torch.arange(T, device=dev))
    pos = torch.arange(F * D, device=dev) - seg_start[torch.clamp(s_tile, 0,
                                                                  T - 1)]
    in_range = (s_tile < T) & (pos < capacity)
    tile_lists = torch.full((T * capacity,), F, dtype=torch.long, device=dev)
    tile_lists[(s_tile * capacity + pos)[in_range]] = s_idx[in_range]
    tile_lists = tile_lists.reshape(T, capacity)

    # triangle attributes padded with a dead sentinel row
    tvp = torch.cat([tv, torch.full((1, 3, 2), -1e6, device=dev)], 0)
    invz = torch.where(tz > z_near, 1.0 / torch.clamp(tz, min=z_near),
                       torch.zeros_like(tz))
    invzp = torch.cat([invz, torch.zeros((1, 3), device=dev)], 0)

    P = tile_size * tile_size
    C = min(chunk, capacity)
    n_chunks = -(-capacity // C)
    if capacity % C:
        tile_lists = torch.nn.functional.pad(
            tile_lists, (0, n_chunks * C - capacity), value=F)
    ty_ids, tx_ids = torch.meshgrid(torch.arange(Ty, device=dev),
                                    torch.arange(Tx, device=dev),
                                    indexing="ij")
    base = torch.stack([tx_ids.reshape(-1) * tile_size,
                        ty_ids.reshape(-1) * tile_size], -1)
    py, px = torch.meshgrid(torch.arange(tile_size, device=dev),
                            torch.arange(tile_size, device=dev),
                            indexing="ij")
    local = torch.stack([px.reshape(-1), py.reshape(-1)], -1)
    pix = (base[:, None, :] + local[None]).float() + 0.5         # (T, P, 2)

    best_z = torch.full((T, P), float("inf"), device=dev)
    best_prim = torch.full((T, P), -1, dtype=torch.long, device=dev)
    for idx in tile_lists.reshape(T, n_chunks, C).unbind(1):     # (T, C)
        p0, p1, p2 = tvp[idx, 0], tvp[idx, 1], tvp[idx, 2]       # (T, C, 2)
        iz = invzp[idx]                                          # (T, C, 3)

        def edge(pa, pb):
            return ((pb[:, None, :, 0] - pa[:, None, :, 0])
                    * (pix[:, :, None, 1] - pa[:, None, :, 1])
                    - (pb[:, None, :, 1] - pa[:, None, :, 1])
                    * (pix[:, :, None, 0] - pa[:, None, :, 0]))

        w0, w1, w2 = edge(p1, p2), edge(p2, p0), edge(p0, p1)    # (T, P, C)
        area = w0 + w1 + w2
        nz = area.abs() > 1e-12
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))) & nz
        area_safe = torch.where(nz, area, torch.ones_like(area))
        interp = (w0 / area_safe * iz[:, None, :, 0]
                  + w1 / area_safe * iz[:, None, :, 1]
                  + w2 / area_safe * iz[:, None, :, 2])
        hit = inside & (interp > 1e-12)
        zpix = torch.where(hit, 1.0 / torch.clamp(interp, min=1e-12),
                           torch.full_like(interp, float("inf")))
        zmin, arg = torch.min(zpix, dim=-1)                      # (T, P)
        prim = torch.gather(idx, 1, arg)
        better = (zmin < best_z) & torch.isfinite(zmin)
        best_prim = torch.where(better, prim, best_prim)
        best_z = torch.minimum(best_z, zmin)

    def untile(a):
        img = a.reshape(Ty, Tx, tile_size, tile_size, *a.shape[2:])
        img = img.transpose(1, 2).reshape(Ty * tile_size, Tx * tile_size,
                                          *a.shape[2:])
        return img[:image_height, :image_width]

    depth = untile(best_z)
    prim_img = untile(best_prim)
    tri_w = vertices[faces]
    fn = torch.linalg.cross(tri_w[:, 1] - tri_w[:, 0],
                            tri_w[:, 2] - tri_w[:, 0])
    fn = fn / torch.clamp(torch.linalg.norm(fn, dim=-1, keepdim=True),
                          min=1e-12)
    fnp = torch.cat([fn, torch.zeros((1, 3), device=dev)], 0)
    normal = fnp[torch.where(prim_img < 0, torch.full_like(prim_img, F),
                             prim_img)]
    return MeshRender(depth=depth, normal=normal, mask=prim_img >= 0,
                      prim=prim_img.to(torch.int32))

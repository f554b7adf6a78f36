"""Isosurface extraction: marching tetrahedra over a regular tet grid.

Port of ``dreamwaltz_g_tpu/nerf/isosurface.py``. ``marching_tets`` is the
NeRF -> mesh export's core and the DMTet layer's: a fixed 2 triangle slots
a tet (zero-area, ``valid`` False, where the surface does not cut it),
differentiable through the edge interpolation. ``compact_mesh`` drops the
empty slots and welds the vertices on the host; ``export_mesh`` queries a
field's density on the grid and its albedo at the mesh's vertices in
chunks. The field's queries and the marching run inside the spans
``mesh.field_query`` and ``mesh.marching_tets`` (``utils/timing.py``).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.timing import span

# 6-tet decomposition of a cube (corner ids 0..7, bit k = axis k offset)
_CUBE_TETS = np.asarray([
    [0, 5, 1, 3],
    [0, 5, 3, 6],
    [0, 3, 2, 6],
    [0, 5, 6, 4],
    [5, 3, 6, 7],
    [0, 2, 6, 4],
], np.int64)

# tet edges (pairs of local vertex ids)
_TET_EDGES = np.asarray(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# the triangle table: for each of the 16 inside/outside cases, two
# triangles of edge ids (-1: no triangle)
_TRI_TABLE = np.asarray([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], np.int64)


class TriangleSoup(NamedTuple):
    vertices: torch.Tensor  # (M, 3, 3) triangle corners (empty slots: 0)
    valid: torch.Tensor     # (M,) bool


def marching_tets(verts: torch.Tensor, sdf: torch.Tensor,
                  tets: torch.Tensor) -> TriangleSoup:
    """Marching tetrahedra: ``verts`` (V, 3) grid positions, ``sdf`` (V,)
    signed values (> 0 inside), ``tets`` (Tt, 4) vertex ids -> 2 triangle
    slots a tet. Each cut edge's point is ``va + (vb - va) * t`` with
    ``t = sa / (sa - sb)`` clipped to [0, 1] (0.5 on a flat edge), in the
    JAX package's order of operations, so that the same inputs weld to the
    same vertices."""
    dev = verts.device
    tets = tets.to(dev, torch.long)
    tv = verts[tets]                                   # (Tt, 4, 3)
    ts = sdf[tets]                                     # (Tt, 4)
    occ = (ts > 0).long()
    case = occ[:, 0] + occ[:, 1] * 2 + occ[:, 2] * 4 + occ[:, 3] * 8

    e = torch.as_tensor(_TET_EDGES, device=dev)
    sa, sb = ts[:, e[:, 0]], ts[:, e[:, 1]]            # (Tt, 6)
    va, vb = tv[:, e[:, 0]], tv[:, e[:, 1]]            # (Tt, 6, 3)
    denom = sa - sb
    flat = torch.abs(denom) > 1e-10
    t = torch.where(flat, sa / torch.where(flat, denom,
                                           torch.ones_like(denom)),
                    torch.full_like(denom, 0.5))
    t = torch.clamp(t, 0.0, 1.0)
    edge_pts = va + (vb - va) * t[..., None]           # (Tt, 6, 3)

    table = torch.as_tensor(_TRI_TABLE, device=dev)[case]
    tri_edges = table.reshape(-1, 2, 3)                # (Tt, 2, 3)
    valid = tri_edges[..., 0] >= 0                     # (Tt, 2)
    safe = torch.clamp(tri_edges, min=0)
    Tt = tets.shape[0]
    rows = torch.arange(Tt, device=dev)[:, None, None]
    tris = edge_pts[rows, safe]                        # (Tt, 2, 3, 3)
    tris = torch.where(valid[..., None, None], tris,
                       torch.zeros((), dtype=tris.dtype, device=dev))
    return TriangleSoup(vertices=tris.reshape(-1, 3, 3),
                        valid=valid.reshape(-1))


def make_tet_grid(resolution: int, bound: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Regular tet grid over [-bound, bound]^3: (verts (G^3, 3) float32,
    tets (6 (G - 1)^3, 4) int32)."""
    G = resolution
    xs = np.linspace(-bound, bound, G, dtype=np.float32)
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    verts = np.stack([xx, yy, zz], -1).reshape(-1, 3)

    idx = np.arange(G ** 3).reshape(G, G, G)
    c = np.empty((G - 1, G - 1, G - 1, 8), np.int64)
    for k in range(8):
        dz, dy, dx = (k >> 2) & 1, (k >> 1) & 1, k & 1
        c[..., k] = idx[dz: G - 1 + dz, dy: G - 1 + dy, dx: G - 1 + dx]
    cubes = c.reshape(-1, 8)
    tets = cubes[:, _CUBE_TETS.reshape(-1)].reshape(-1, 4)
    return verts, tets.astype(np.int32)


def compact_mesh(soup: TriangleSoup, weld_decimals: int = 5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """On the host: drop the empty slots and weld vertices equal to
    ``weld_decimals`` decimals. Returns (vertices (V, 3) float32, faces
    (F, 3) int64)."""
    tris = soup.vertices.detach().cpu().numpy()[soup.valid.cpu().numpy()]
    if tris.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    flat = tris.reshape(-1, 3)
    key = np.round(flat, weld_decimals)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    # welding can fold a thin triangle onto an edge: drop repeated ids
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[ok]


def field_query(fn, pts: torch.Tensor, chunk: int = 128 ** 2
                ) -> torch.Tensor:
    """``fn`` over (N, 3) points in chunks of ``chunk`` rows, no gradient;
    the results concatenated. Timed as the span ``mesh.field_query``."""
    with span("mesh.field_query", pts.device), torch.no_grad():
        return torch.cat([fn(p) for p in torch.split(pts, chunk)])


def export_mesh(model, resolution: int = 128, density_thresh: float = 10.0,
                bound: Optional[float] = None, chunk: int = 128 ** 2):
    """A field (``nerf/network.py:NeRFModel``) -> (vertices, faces,
    vertex colors) through marching tets: the density on the grid's
    vertices minus ``density_thresh`` as the SDF, the soup moved to the
    host once and compacted there, then the albedo at the vertices (its
    first 3 channels). Queries run on the field's device in chunks of
    ``chunk`` points."""
    dev = model.planes.device
    bound = bound or model.bound
    verts_np, tets_np = make_tet_grid(resolution, bound)
    verts = torch.as_tensor(verts_np, device=dev)
    sdf = field_query(lambda p: model.density(p)[0], verts, chunk) \
        - density_thresh
    with span("mesh.marching_tets", dev):
        soup = marching_tets(verts, sdf,
                             torch.as_tensor(tets_np, device=dev))
        soup = TriangleSoup(*[x.cpu() for x in soup])
    v, f = compact_mesh(soup)
    if v.shape[0] == 0:
        return v, f, np.zeros((0, 3), np.float32)
    colors = field_query(lambda p: model.density(p)[1],
                         torch.as_tensor(v, device=dev), chunk)
    return v, f, colors.cpu().numpy()[:, :3]


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> str:
    """A minimal OBJ writer, with per-vertex colors (the xyzrgb
    extension) when given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for i, v in enumerate(vertices):
            if colors is not None:
                c = colors[i]
                fh.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    return path

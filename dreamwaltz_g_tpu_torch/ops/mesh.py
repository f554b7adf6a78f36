"""Point-mesh geometry: KNN, nearest-triangle queries, surface sampling
and vertex normals.

Port of ``dreamwaltz_g_tpu/ops/mesh.py``: setup-time ops of avatar
initialisation and of stage 1's sigma guidance, the queries as chunked
brute force over dense (chunk x F) distance tiles, and the per-triangle
frames of the mesh-bound Gaussians (``triangle_frames``).

Every sum of face values at the vertices (the three kinds of vertex
normals) is ``sum_at_vertices``: a gather through a table built once on
the host (``corner_table``) and a sum in a fixed order. An ``index_add``
adds with atomics on the card, in no fixed order, so the same mesh could
give normals that differ in the last bits from call to call.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each (M, 3) query among (N, 3) points.
    Returns (squared dists (M, k), idx (M, k)), ascending."""
    ds, idxs = [], []
    for qc in torch.split(query, chunk):
        d2 = torch.sum((qc[:, None, :] - points[None, :, :]) ** 2, dim=-1)
        neg, idx = torch.topk(-d2, k, dim=-1)
        ds.append(-neg)
        idxs.append(idx)
    return torch.cat(ds), torch.cat(idxs)


def _point_triangle_sq_dist(p: torch.Tensor, a, b, c):
    """Squared distance + barycentric coords of the closest point on triangle
    (a, b, c) for points p (vectorized Ericson region test).

    Shapes: p (..., 3); a/b/c broadcastable (..., 3).
    Returns (d2 (...,), bary (..., 3))."""
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-20
    denom = torch.clamp(va + vb + vc, min=eps)
    v_in = vb / denom
    w_in = vc / denom

    v_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=eps), 0.0, 1.0)
    w_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=eps), 0.0, 1.0)
    w_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=eps),
                       0.0, 1.0)

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (~in_vert_a) & (~in_vert_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (~in_vert_a) & (~in_vert_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (~in_vert_b) & (~in_vert_c) & (va <= 0) & ((d4 - d3) >= 0) \
        & ((d5 - d6) >= 0)

    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    v = torch.where(in_vert_a, zero,
        torch.where(in_vert_b, one,
        torch.where(in_vert_c, zero,
        torch.where(in_edge_ab, v_ab,
        torch.where(in_edge_ac, zero,
        torch.where(in_edge_bc, 1.0 - w_bc, v_in))))))  # noqa: E128
    w = torch.where(in_vert_a, zero,
        torch.where(in_vert_b, zero,
        torch.where(in_vert_c, one,
        torch.where(in_edge_ab, zero,
        torch.where(in_edge_ac, w_ac,
        torch.where(in_edge_bc, w_bc, w_in))))))  # noqa: E128

    closest = a + v[..., None] * ab + w[..., None] * ac
    dist2 = torch.sum((p - closest) ** 2, -1)
    bary = torch.stack([1.0 - v - w, v, w], dim=-1)
    return dist2, bary


class NearestTriangles(NamedTuple):
    """Per-point nearest-triangle attachment."""

    triangle_indices: torch.Tensor   # (N,) int64
    sq_dists: torch.Tensor           # (N,)
    barycentric: torch.Tensor        # (N, 3)
    vertex_indices: torch.Tensor     # (N,) min-barycentric vertex of that triangle


def find_nearest_triangles(
    points: torch.Tensor,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    point_chunk: int = 1024,
) -> NearestTriangles:
    """Chunked brute-force nearest triangle + barycentric coordinates."""
    tri = vertices[faces]  # (F, 3, 3)
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    d2s, idxs, barys = [], [], []
    for pc in torch.split(points, point_chunk):
        d2, bary = _point_triangle_sq_dist(pc[:, None, :], a, b, c)
        best = torch.argmin(d2, dim=-1)
        rows = torch.arange(pc.shape[0], device=pc.device)
        d2s.append(d2[rows, best])
        idxs.append(best)
        barys.append(bary[rows, best])
    d2s, idxs, barys = torch.cat(d2s), torch.cat(idxs), torch.cat(barys)
    # the reference picks the vertex with the MINIMUM barycentric weight
    # (kept for parity: these ids gather the per-vertex offset terms)
    nearest = torch.argmin(barys, dim=-1)
    vertex_indices = faces[idxs].gather(1, nearest[:, None])[:, 0]
    return NearestTriangles(triangle_indices=idxs, sq_dists=d2s,
                            barycentric=barys, vertex_indices=vertex_indices)


def interpolate_vertex_attributes(
    nearest: NearestTriangles, faces: torch.Tensor, attributes: torch.Tensor,
) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes (V, D) at the
    attachment points -> (N, D)."""
    tri_attr = attributes[faces[nearest.triangle_indices]]  # (N, 3, D)
    return torch.einsum("nk,nkd->nd", nearest.barycentric, tri_attr)


def sample_faces(area: torch.Tensor, n: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``n`` face ids drawn in proportion to ``area`` (F,): the inverse of
    the areas' running sum, taken in face order in float64 on the host, at
    ``n`` uniforms from ``generator`` on the areas' device. The same areas
    and draws give the same faces from call to call. ``torch.multinomial``
    with replacement does not on the card: on an H100 it drew another face
    for the same areas and generator state in 2 of 300 calls of 5,000
    draws over the SMPL-X-sized body's 20,950 faces, which parted stage
    1's sigma guidance and its gradients."""
    cdf = torch.as_tensor(np.cumsum(area.detach().cpu().double().numpy()),
                          device=area.device)
    u = torch.rand((n,), generator=generator, device=area.device,
                   dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True),
                       max=cdf.numel() - 1)


def sample_mesh_surface(vertices: torch.Tensor, faces, n: int,
                        generator: Optional[torch.Generator] = None,
                        fidx: Optional[torch.Tensor] = None,
                        u: Optional[torch.Tensor] = None,
                        return_bary: bool = False):
    """Area-weighted uniform surface samples: (points (n, 3), face_idx
    (n,)), plus the (n, 3) barycentric weights when ``return_bary``. The
    faces (``fidx``, drawn in proportion to area) and the (n, 2) uniform
    draws ``u`` are handed in, or drawn from ``generator``."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    tri = vertices[faces]
    if fidx is None or u is None:
        if generator is None:
            raise ValueError("pass fidx= and u=, or generator=")
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        area = 0.5 * torch.linalg.norm(torch.cross(e1, e2, dim=-1), dim=-1)
        fidx = sample_faces(torch.clamp(area, min=1e-20), n, generator)
        u = torch.rand((n, 2), generator=generator, device=vertices.device)
    fidx = torch.as_tensor(fidx, device=vertices.device).long()
    u = torch.as_tensor(u, device=vertices.device, dtype=vertices.dtype)
    su = torch.sqrt(u[:, 0:1])
    bary = torch.cat([1 - su, su * (1 - u[:, 1:2]), su * u[:, 1:2]], -1)
    pts = torch.einsum("nk,nkd->nd", bary, tri[fidx])
    if return_bary:
        return pts, fidx, bary
    return pts, fidx


def corner_table(faces, n_vertices: int) -> np.ndarray:
    """The (face, corner)s at each vertex, in a fixed order: an
    (n_vertices, K) int64 table of flat ids ``3 f + c`` (``faces[f, c]`` is
    the vertex), ascending along each row, K the most corners at one
    vertex, rows padded with ``3 F``, which ``sum_at_vertices`` reads as a
    zero row. Built on the host with numpy; ``faces`` (F, 3)."""
    faces = np.asarray(faces, np.int64)
    flat = faces.reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_vertices):
        raise ValueError(f"faces name vertices outside 0..{n_vertices - 1}")
    counts = np.bincount(flat, minlength=n_vertices)
    order = np.argsort(flat, kind="stable")     # by vertex, then flat id
    slot = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
    table = np.full((n_vertices, max(int(counts.max(initial=0)), 1)),
                    flat.size, np.int64)
    table[flat[order], slot] = order
    return table


# corner tables by (vertex count, faces' bytes), for face arrays that come
# without one (the SMPL-X faces of stage 1's sigma guidance and of the
# seeding); a mesh part keeps its own (``system.avatar``)
_TABLES: Dict[tuple, np.ndarray] = {}
_CACHED = 32


def cached_corner_table(faces, n_vertices: int) -> np.ndarray:
    """``corner_table(faces, n_vertices)``, built once for each face array
    and vertex count (the faces on the host, or a tensor copied there)."""
    faces = np.ascontiguousarray(
        faces.detach().cpu().numpy() if torch.is_tensor(faces) else faces,
        np.int64)
    key = (n_vertices, faces.shape, faces.tobytes())
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= _CACHED:
            _TABLES.pop(next(iter(_TABLES)))
        table = _TABLES[key] = corner_table(faces, n_vertices)
    return table


def sum_at_vertices(face_values: torch.Tensor, table: np.ndarray
                    ) -> torch.Tensor:
    """(V, C): for each vertex the sum of ``face_values`` (F, C) over its
    (face, corner)s in ``table``'s order (``corner_table``), as a gather
    and a sum over the padded axis, the pad reading a zero row. No atomics:
    the same inputs give the same bits from call to call on any device.
    The gather's gradient is ``index_put_(accumulate=True)``, which on the
    card sorts the indices stably and adds in that order; the pad row's
    run of entries is walked in series there."""
    faces = torch.as_tensor(table // 3, device=face_values.device)
    padded = torch.cat([face_values,
                        face_values.new_zeros((1,) + face_values.shape[1:])])
    return padded[faces].sum(1)


def face_normals_at_vertices(vertices: torch.Tensor, faces,
                             unit: bool = False, table=None) -> torch.Tensor:
    """(V, 3) sum of the faces' normals at each vertex
    (``sum_at_vertices``): the cross products (area-weighted) or, with
    ``unit``, each normalised first (norm clamped at 1e-12). ``table``:
    the faces' ``corner_table`` where the caller keeps it (else cached
    here)."""
    if table is None:
        table = cached_corner_table(faces, vertices.shape[0])
    faces = torch.as_tensor(faces, device=vertices.device).long()
    tri = vertices[faces]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    if unit:
        fn = fn / torch.clamp(torch.linalg.norm(fn, dim=-1, keepdim=True),
                              min=1e-12)
    return sum_at_vertices(fn, table)


def vertex_normals(vertices: torch.Tensor, faces) -> torch.Tensor:
    """Per-vertex unit normals: the mean of the adjacent faces' unit
    normals (trimesh's ``vertex_normals``), summed in a fixed order."""
    vn = face_normals_at_vertices(vertices, faces, unit=True)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True),
                            min=1e-12)


def triangle_frames(vertices: torch.Tensor, faces):
    """Per-triangle orthonormal frame and edge sizes, the basis of the
    mesh-bound Gaussians' scales and orientations. Returns (R (F, 3, 3),
    columns (e1_hat, e2_perp_hat, normal); sizes (F, 3): |e1|, the height
    of e2 off e1, and their mean); norms clamped at 1e-12."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    tri = vertices[faces]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e1, e2)

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-12)

    n_hat, x_hat = unit(n), unit(e1)
    y_hat = torch.linalg.cross(n_hat, x_hat)
    R = torch.stack([x_hat, y_hat, n_hat], dim=-1)
    s1 = torch.linalg.norm(e1, dim=-1)
    s2 = torch.abs(torch.sum(e2 * y_hat, dim=-1))
    sizes = torch.stack([s1, s2, 0.5 * (s1 + s2)], dim=-1)
    return R, sizes

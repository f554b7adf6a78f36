"""NeRF -> textured mesh export.

Port of ``dreamwaltz_g_tpu/nerf/mesh_export.py``: numpy on the host for the
connectivity work, around the field's density and albedo queries on its
device (``isosurface.field_query``, in chunks):

* ``clean_mesh``        -- close-vertex merge, duplicate / null-face
                          removal, small-component prune, unreferenced
                          vertices dropped;
* ``decimate_mesh``     -- quadric-error edge collapse (``heapq``);
* ``unwrap_uv``         -- charts grown by normal similarity, each projected
                          on its mean-normal plane, shelf-packed in [0, 1]^2;
* ``bake_albedo``       -- surface positions rasterized into UV space, the
                          field's albedo queried a texel, the chart borders
                          dilated;
* ``export_textured_mesh`` -- the chain, writing ``mesh.obj`` /
                          ``mesh.mtl`` / ``albedo.png``.
"""
from __future__ import annotations

import heapq
import os
import os.path as osp
from typing import Tuple

import numpy as np


def _latent_to_rgb(albedo: np.ndarray) -> np.ndarray:
    """4-channel latent albedo -> approximate RGB."""
    if albedo.shape[-1] == 3:
        return albedo
    from .export import LATENT_TO_RGB

    return np.clip(np.asarray(albedo) @ LATENT_TO_RGB, 0.0, 1.0)


# ---------------------------------------------------------------------------
# clean
# ---------------------------------------------------------------------------

def clean_mesh(verts: np.ndarray, faces: np.ndarray,
               merge_pct: float = 0.01, min_faces: int = 8,
               min_diag_pct: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """Merge vertices closer than ``merge_pct`` % of the bounding box's
    diagonal, drop null and duplicate faces, then every connected
    component with fewer than ``min_faces`` faces or a diagonal under
    ``min_diag_pct`` % of the box's, then the unreferenced vertices."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return verts.astype(np.float32), faces

    # merge close vertices: quantize to a grid of merge_pct% of bbox diag
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0))) or 1.0
    cell = diag * merge_pct / 100.0
    if cell > 0:
        key = np.round(verts / cell).astype(np.int64)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        verts = verts[first]
        faces = inverse[faces]

    # remove null/duplicate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]
    srt = np.sort(faces, axis=1)
    _, keep = np.unique(srt, axis=0, return_index=True)
    faces = faces[np.sort(keep)]

    # connected components over shared vertices (union-find on face-vertex)
    parent = np.arange(len(verts))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for f in faces:
        a, b, c = find(f[0]), find(f[1]), find(f[2])
        parent[b] = a
        parent[c] = a
    roots = np.asarray([find(v) for v in range(len(verts))])
    face_root = roots[faces[:, 0]]
    keep_faces = np.ones(len(faces), bool)
    for r in np.unique(face_root):
        sel = face_root == r
        comp_verts = verts[np.unique(faces[sel])]
        comp_diag = float(np.linalg.norm(
            comp_verts.max(0) - comp_verts.min(0)))
        if sel.sum() < min_faces or comp_diag < diag * min_diag_pct / 100.0:
            keep_faces[sel] = False
    faces = faces[keep_faces]

    # drop unreferenced vertices
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used].astype(np.float32), remap[faces]


# ---------------------------------------------------------------------------
# decimate (QEM edge collapse)
# ---------------------------------------------------------------------------

def _vertex_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    d = -np.sum(n * v0, axis=1, keepdims=True)
    p = np.concatenate([n, d], axis=1)                   # (F, 4) plane
    Kf = p[:, :, None] * p[:, None, :]                   # (F, 4, 4)
    Q = np.zeros((len(verts), 4, 4))
    for k in range(3):
        np.add.at(Q, faces[:, k], Kf)
    return Q


def decimate_mesh(verts: np.ndarray, faces: np.ndarray, target: int,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge collapse to ~``target`` faces. Candidate positions are
    the two endpoints and the midpoint (an optimal placement can spike on
    flat meshes)."""
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces, np.int64).copy()
    if len(faces) <= target:
        return verts.astype(np.float32), faces
    Q = _vertex_quadrics(verts, faces)
    parent = np.arange(len(verts))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def edge_cost(a, b):
        Qe = Q[a] + Q[b]
        best, bx = np.inf, None
        for x in (verts[a], verts[b], 0.5 * (verts[a] + verts[b])):
            h = np.append(x, 1.0)
            c = float(h @ Qe @ h)
            if c < best:
                best, bx = c, x
        return best, bx

    edges = np.unique(np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1),
        axis=0)
    version = np.zeros(len(verts), np.int64)
    heap = []
    for a, b in edges:
        c, _ = edge_cost(a, b)
        heapq.heappush(heap, (c, int(a), int(b), 0, 0))

    n_faces = len(faces)
    live = np.ones(len(faces), bool)
    vert_faces = [[] for _ in range(len(verts))]
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces[v].append(fi)

    while heap and n_faces > target:
        c, a, b, va, vb = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb or version[ra] != va or version[rb] != vb:
            # stale entry: recompute if the edge still exists
            if ra != rb:
                c2, _ = edge_cost(ra, rb)
                heapq.heappush(heap, (c2, int(ra), int(rb),
                                      int(version[ra]), int(version[rb])))
            continue
        _, x = edge_cost(ra, rb)
        # collapse rb -> ra
        verts[ra] = x
        Q[ra] = Q[ra] + Q[rb]
        parent[rb] = ra
        version[ra] += 1
        fl = vert_faces[ra] + vert_faces[rb]
        vert_faces[ra] = []
        for fi in fl:
            if not live[fi]:
                continue
            f = [find(v) for v in faces[fi]]
            if f[0] == f[1] or f[1] == f[2] or f[0] == f[2]:
                live[fi] = False
                n_faces -= 1
            else:
                faces[fi] = f
                vert_faces[ra].append(fi)

    faces = np.asarray([[find(v) for v in f] for f in faces[live]])
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used].astype(np.float32), remap[faces]


# ---------------------------------------------------------------------------
# UV unwrap (charts + shelf packing)
# ---------------------------------------------------------------------------

def unwrap_uv(verts: np.ndarray, faces: np.ndarray,
              angle_thresh_deg: float = 65.0, pad: float = 0.01,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Chart the mesh by normal-similarity region growing, project each
    chart to its mean-normal plane, shelf-pack chart boxes into [0,1]².

    Returns (vt (T, 2) uv coords, ft (F, 3) per-face uv indices)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    F = len(faces)
    if F == 0:
        return np.zeros((0, 2), np.float32), faces.copy()

    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)

    # face adjacency via shared (sorted) edges
    e = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]],
                          faces[:, [2, 0]]], axis=1).reshape(-1, 2), axis=1)
    order = np.lexsort((e[:, 1], e[:, 0]))
    es = e[order]
    fid = order // 3
    adj = [[] for _ in range(F)]
    i = 0
    while i < len(es) - 1:
        if (es[i] == es[i + 1]).all():
            adj[fid[i]].append(fid[i + 1])
            adj[fid[i + 1]].append(fid[i])
            i += 2
        else:
            i += 1

    cos_t = np.cos(np.deg2rad(angle_thresh_deg))
    chart = -np.ones(F, np.int64)
    charts = []
    for seed in range(F):
        if chart[seed] >= 0:
            continue
        cid = len(charts)
        seed_n = fn[seed]
        stack, members = [seed], []
        chart[seed] = cid
        while stack:
            f = stack.pop()
            members.append(f)
            for g in adj[f]:
                if chart[g] < 0 and float(fn[g] @ seed_n) > cos_t:
                    chart[g] = cid
                    stack.append(g)
        charts.append(members)

    # project each chart; per-chart vertex duplication
    vt_list, ft = [], np.zeros((F, 3), np.int64)
    boxes = []
    for cid, members in enumerate(charts):
        n = fn[members].mean(0)
        if np.linalg.norm(n) < 1e-9:   # degenerate chart (zero-area faces)
            n = np.asarray([0.0, 0.0, 1.0])
        n = n / np.linalg.norm(n)
        u = np.cross(n, [0.0, 0.0, 1.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(n, [0.0, 1.0, 0.0])
        u = u / max(np.linalg.norm(u), 1e-12)
        w = np.cross(n, u)
        vids = np.unique(faces[members])
        local = {v: i for i, v in enumerate(vids)}
        p2 = np.stack([verts[vids] @ u, verts[vids] @ w], axis=1)
        p2 -= p2.min(0)
        base = sum(len(x) for x in vt_list)
        vt_list.append(p2)
        for f in members:
            ft[f] = [base + local[v] for v in faces[f]]
        boxes.append(p2.max(0) if len(p2) else np.zeros(2))

    vt = np.concatenate(vt_list, axis=0) if vt_list else np.zeros((0, 2))

    # shelf packing: sort by height, fill rows of a square of side ~sqrt(area)
    sizes = np.asarray(boxes) + pad
    order = np.argsort(-sizes[:, 1])
    side = float(np.sqrt(np.sum(np.prod(sizes, axis=1)))) * 1.2 + 1e-9
    offsets = np.zeros((len(charts), 2))
    x = y = row_h = 0.0
    for ci in order:
        wch, hch = sizes[ci]
        if x + wch > side and x > 0:
            x, y = 0.0, y + row_h
            row_h = 0.0
        offsets[ci] = (x, y)
        x += wch
        row_h = max(row_h, hch)
    total_h = y + row_h
    scale = 1.0 / max(side, total_h)

    base = 0
    for ci, members in enumerate(charts):
        nloc = len(np.unique(faces[members]))
        vt[base: base + nloc] = (vt[base: base + nloc]
                                 + offsets[ci] + pad / 2) * scale
        base += nloc
    return vt.astype(np.float32), ft


# ---------------------------------------------------------------------------
# albedo bake
# ---------------------------------------------------------------------------

def rasterize_uv_attribute(attr: np.ndarray, faces: np.ndarray,
                           vt: np.ndarray, ft: np.ndarray,
                           texture_size: int,
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric-interpolate a per-vertex attribute (V, D) into UV space.
    Returns ((T, T, D) map, (T, T) coverage mask)."""
    T = texture_size
    attr = np.asarray(attr, np.float64)
    out = np.zeros((T, T, attr.shape[-1]), np.float64)
    mask = np.zeros((T, T), bool)

    uv_px = np.asarray(vt, np.float64) * (T - 1)
    for f, tf in zip(np.asarray(faces), np.asarray(ft)):
        tri = uv_px[tf]                       # (3, 2)
        lo = np.clip(np.floor(tri.min(0)).astype(int), 0, T - 1)
        hi = np.clip(np.ceil(tri.max(0)).astype(int) + 1, 0, T)
        if (hi <= lo).any():
            continue
        xs = np.arange(lo[0], hi[0])
        ys = np.arange(lo[1], hi[1])
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        p = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64)
        a, b, c = tri
        det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
        if abs(det) < 1e-12:
            continue
        l1 = ((p[:, 0] - a[0]) * (c[1] - a[1])
              - (c[0] - a[0]) * (p[:, 1] - a[1])) / det
        l2 = ((b[0] - a[0]) * (p[:, 1] - a[1])
              - (p[:, 0] - a[0]) * (b[1] - a[1])) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
        if not inside.any():
            continue
        pv = (l0[inside, None] * attr[f[0]] + l1[inside, None] * attr[f[1]]
              + l2[inside, None] * attr[f[2]])
        ix = p[inside, 0].astype(int)
        iy = p[inside, 1].astype(int)
        # texel layout is row = v, col = u (the OBJ's 'vt u v' in image
        # row order)
        out[iy, ix] = pv
        mask[iy, ix] = True
    return out, mask


def inpaint_texture(tex: np.ndarray, mask: np.ndarray,
                    iters: int = 3) -> np.ndarray:
    """Dilate chart borders: empty texels take the mean of filled
    8-neighbors, ``iters`` times."""
    T = tex.shape[0]
    tex = np.asarray(tex, np.float32).copy()
    mask = mask.copy()
    for _ in range(iters):
        filled = mask.astype(np.float32)
        acc = np.zeros_like(tex)
        cnt = np.zeros((T, T), np.float32)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                sx = slice(max(dx, 0), T + min(dx, 0))
                sy = slice(max(dy, 0), T + min(dy, 0))
                tx = slice(max(-dx, 0), T + min(-dx, 0))
                ty = slice(max(-dy, 0), T + min(-dy, 0))
                acc[tx, ty] += tex[sx, sy] * filled[sx, sy, None]
                cnt[tx, ty] += filled[sx, sy]
        grow = (~mask) & (cnt > 0)
        tex[grow] = acc[grow] / cnt[grow, None]
        mask = mask | grow
    return tex


def bake_albedo(model, verts: np.ndarray, faces: np.ndarray,
                vt: np.ndarray, ft: np.ndarray, texture_size: int = 1024,
                chunk: int = 128 ** 2, inpaint_iters: int = 3,
                ) -> np.ndarray:
    """Rasterize surface positions into UV space, query the field's albedo
    a covered texel (on its device, ``chunk`` points a pass), dilate the
    chart borders. Returns the (T, T, 3) float32 texture in [0, 1]."""
    import torch

    from .isosurface import field_query

    T = texture_size
    xyz, mask = rasterize_uv_attribute(verts, faces, vt, ft, T)

    tex = np.zeros((T, T, 3), np.float32)
    pts = xyz[mask]
    if len(pts):
        cols = field_query(lambda p: model.density(p)[1], torch.as_tensor(
            pts, dtype=torch.float32, device=model.device), chunk)
        tex[mask] = _latent_to_rgb(cols.cpu().numpy())[:, :3]

    return inpaint_texture(tex, mask, iters=inpaint_iters)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def export_textured_mesh(
    model, path: str,
    resolution: int = 128,
    density_thresh: float = 10.0,
    decimate_target: int = -1,
    texture_size: int = 1024,
    name: str = "",
) -> str:
    """A field -> cleaned (and, with ``decimate_target`` > 0, decimated)
    mesh + UV atlas + baked albedo texture, written as ``{name}mesh.obj``
    / ``{name}mesh.mtl`` / ``{name}albedo.png`` under ``path``. Returns
    the OBJ's path; an empty isosurface raises."""
    from .isosurface import export_mesh

    v, f, _ = export_mesh(model, resolution=resolution,
                          density_thresh=density_thresh)
    if len(f) == 0:
        raise ValueError("empty isosurface — check density_thresh")
    v, f = clean_mesh(v, f)
    if decimate_target > 0 and len(f) > decimate_target:
        v, f = decimate_mesh(v, f, decimate_target)
    vt, ft = unwrap_uv(v, f)
    tex = bake_albedo(model, v, f, vt, ft, texture_size=texture_size)

    os.makedirs(path, exist_ok=True)
    from ..utils.media import save_image

    save_image(osp.join(path, f"{name}albedo.png"), tex)
    obj = osp.join(path, f"{name}mesh.obj")
    with open(obj, "w") as fp:
        fp.write(f"mtllib {name}mesh.mtl\n")
        for p in v:
            fp.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in vt:
            fp.write(f"vt {t[0]} {1 - t[1]}\n")
        fp.write("usemtl mat0\n")
        for fi in range(len(f)):
            fp.write("f {}/{} {}/{} {}/{}\n".format(
                f[fi, 0] + 1, ft[fi, 0] + 1, f[fi, 1] + 1, ft[fi, 1] + 1,
                f[fi, 2] + 1, ft[fi, 2] + 1))
    with open(osp.join(path, f"{name}mesh.mtl"), "w") as fp:
        fp.write("newmtl mat0\n")
        fp.write("Ka 1.000000 1.000000 1.000000\n")
        fp.write("Kd 1.000000 1.000000 1.000000\n")
        fp.write("Ks 0.000000 0.000000 0.000000\n")
        fp.write("Tr 1.000000\nillum 1\nNs 0.000000\n")
        fp.write(f"map_Kd {name}albedo.png\n")
    return obj

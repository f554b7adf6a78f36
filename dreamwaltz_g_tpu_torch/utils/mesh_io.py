"""Textured triangle-mesh container, OBJ io, and a raycast renderer.

Port of ``dreamwaltz_g_tpu/utils/mesh_io.py`` (reference: utils/mesh.py:12-808
-- the Mesh class (load_obj/write, auto_size/auto_normal/auto_uv,
compute_tangents), the nvdiffrast MeshRenderer, and
vertex_colors_to_albedo_image). It is numpy on the host, apart from
``render_mesh``, whose rays and Moller-Trumbore ray cast
(``ops/raycast.cast_rays``) run on the card unless the caller asks for the
CPU; its texture and shading are sampled on the host.
"""
from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def safe_normalize(x: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    """(reference: utils/mesh.py:26-27)"""
    return x / np.sqrt(np.maximum(np.sum(x * x, axis=-1, keepdims=True), eps))


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray,
                           ) -> np.ndarray:
    """Area-weighted vertex normals (reference: compute_normal,
    utils/mesh.py:34-96)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)          # area-weighted
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return safe_normalize(vn)


def convert_vertex_indices_to_face_indices(vertex_indices,
                                           faces: np.ndarray) -> np.ndarray:
    """Faces whose three vertices all belong to the vertex set
    (reference: utils/mesh.py:791-808)."""
    sel = np.zeros(int(np.max(faces)) + 1, bool)
    sel[np.asarray(list(vertex_indices))] = True
    return np.where(sel[faces].all(axis=1))[0]


@dataclass
class Mesh:
    """(reference: Mesh, utils/mesh.py:279-574)"""

    v: Optional[np.ndarray] = None   # (V, 3)
    f: Optional[np.ndarray] = None   # (F, 3) int
    vn: Optional[np.ndarray] = None  # (V, 3)
    fn: Optional[np.ndarray] = None  # (F, 3) int
    vt: Optional[np.ndarray] = None  # (T, 2)
    ft: Optional[np.ndarray] = None  # (F, 3) int
    albedo: Optional[np.ndarray] = None          # (H, W, 3) in [0, 1]
    tangents: Optional[np.ndarray] = None        # (T, 3) per-uv-vertex

    # -- io ----------------------------------------------------------------

    @classmethod
    def load_obj(cls, path: str, albedo_path: Optional[str] = None) -> "Mesh":
        """v/vt/vn + 'f v/vt/vn' faces + mtl map_Kd albedo
        (reference: Mesh.load_obj, utils/mesh.py:309-421)."""
        vs, vts, vns = [], [], []
        fv, ftc, fnn = [], [], []
        mtl_path = None
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split()
                if not parts:
                    continue
                tag = parts[0]
                if tag == "mtllib":
                    mtl_path = osp.join(osp.dirname(path), parts[1])
                elif tag == "v":
                    vs.append([float(x) for x in parts[1:4]])
                elif tag == "vt":
                    vts.append([float(parts[1]), float(parts[2])])
                elif tag == "vn":
                    vns.append([float(x) for x in parts[1:4]])
                elif tag == "f":
                    corners = [p.split("/") for p in parts[1:4]]
                    fv.append([int(c[0]) - 1 for c in corners])
                    if all(len(c) > 1 and c[1] for c in corners):
                        ftc.append([int(c[1]) - 1 for c in corners])
                    if all(len(c) > 2 and c[2] for c in corners):
                        fnn.append([int(c[2]) - 1 for c in corners])
        m = cls(
            v=np.asarray(vs, np.float32),
            f=np.asarray(fv, np.int64),
            vt=np.asarray(vts, np.float32) if vts else None,
            ft=np.asarray(ftc, np.int64) if ftc else None,
            vn=np.asarray(vns, np.float32) if vns else None,
            fn=np.asarray(fnn, np.int64) if fnn else None,
        )
        if m.vt is not None:
            m.vt[:, 1] = 1.0 - m.vt[:, 1]   # OBJ stores flipped v
        # albedo from mtl map_Kd or explicit path
        if albedo_path is None and mtl_path and osp.isfile(mtl_path):
            for line in open(mtl_path):
                if line.strip().startswith("map_Kd"):
                    albedo_path = osp.join(osp.dirname(path),
                                           line.split()[-1])
        if albedo_path and osp.isfile(albedo_path):
            m.albedo = cls.load_albedo(albedo_path)
        return m

    @staticmethod
    def load_albedo(albedo_path: str) -> np.ndarray:
        """(reference: Mesh.load_albedo, utils/mesh.py:423-428)"""
        from PIL import Image

        img = np.asarray(Image.open(albedo_path).convert("RGB"))
        return img.astype(np.float32) / 255.0

    def write(self, path: str) -> str:
        """obj (+mtl +albedo.png when textured)
        (reference: Mesh.write, utils/mesh.py:516-559)."""
        os.makedirs(osp.dirname(path) or ".", exist_ok=True)
        base = osp.splitext(osp.basename(path))[0]
        with open(path, "w") as fp:
            if self.albedo is not None:
                fp.write(f"mtllib {base}.mtl\n")
            for p in self.v:
                fp.write(f"v {p[0]} {p[1]} {p[2]}\n")
            if self.vt is not None:
                for t in self.vt:
                    fp.write(f"vt {t[0]} {1.0 - t[1]}\n")
            if self.vn is not None:
                for n in self.vn:
                    fp.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            if self.albedo is not None:
                fp.write("usemtl mat0\n")
            for i, fv in enumerate(self.f):
                if self.ft is not None:
                    tf = self.ft[i]
                    fp.write("f {}/{} {}/{} {}/{}\n".format(
                        fv[0] + 1, tf[0] + 1, fv[1] + 1, tf[1] + 1,
                        fv[2] + 1, tf[2] + 1))
                else:
                    fp.write(f"f {fv[0] + 1} {fv[1] + 1} {fv[2] + 1}\n")
        if self.albedo is not None:
            from .media import save_image

            d = osp.dirname(path) or "."
            save_image(osp.join(d, f"{base}_albedo.png"), self.albedo)
            with open(osp.join(d, f"{base}.mtl"), "w") as fp:
                fp.write("newmtl mat0\nKd 1.0 1.0 1.0\n")
                fp.write(f"map_Kd {base}_albedo.png\n")
        return path

    # -- derived quantities ------------------------------------------------

    def aabb(self):
        """(reference: Mesh.aabb, utils/mesh.py:430-433)"""
        return self.v.min(0), self.v.max(0)

    def auto_size(self) -> "Mesh":
        """Rescale into [-0.5, 0.5]³ (reference: utils/mesh.py:435-439)."""
        lo, hi = self.aabb()
        scale = 1.0 / max(float((hi - lo).max()), 1e-12)
        self.v = (self.v - (lo + hi) / 2) * scale
        return self

    def auto_normal(self) -> "Mesh":
        """(reference: Mesh.auto_normal, utils/mesh.py:441-443)"""
        self.vn = compute_vertex_normals(self.v, self.f)
        self.fn = self.f.copy()
        return self

    def auto_uv(self) -> "Mesh":
        """Chart-based unwrap (the xatlas role, utils/mesh.py:445-473)."""
        from ..nerf.mesh_export import unwrap_uv

        self.vt, self.ft = unwrap_uv(self.v, self.f)
        return self

    def compute_tangents(self) -> "Mesh":
        """Per-uv-vertex tangents from the UV parameterization
        (reference: Mesh.compute_tangents, utils/mesh.py:475-514)."""
        assert self.vt is not None and self.ft is not None
        if self.vn is None:
            self.auto_normal()
        p0, p1, p2 = (self.v[self.f[:, k]] for k in range(3))
        t0, t1, t2 = (self.vt[self.ft[:, k]] for k in range(3))
        e1, e2 = p1 - p0, p2 - p0
        d1, d2 = t1 - t0, t2 - t0
        denom = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        r = 1.0 / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        tang = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
        out = np.zeros((len(self.vt), 3))
        for k in range(3):
            np.add.at(out, self.ft[:, k], tang)
        self.tangents = safe_normalize(out).astype(np.float32)
        return self

    def set_albedo(self, albedo: np.ndarray) -> "Mesh":
        self.albedo = np.asarray(albedo, np.float32)
        return self

    def set_uv(self, vt, ft) -> "Mesh":
        self.vt, self.ft = np.asarray(vt, np.float32), np.asarray(ft)
        return self


def vertex_colors_to_albedo_image(mesh: Mesh, colors: np.ndarray,
                                  texture_size: int = 1024) -> np.ndarray:
    """Bake per-vertex colors into the mesh's UV atlas
    (reference: vertex_colors_to_albedo_image, utils/mesh.py:713-788)."""
    from ..nerf.mesh_export import inpaint_texture, rasterize_uv_attribute

    if mesh.vt is None:
        mesh.auto_uv()
    tex, mask = rasterize_uv_attribute(colors, mesh.f, mesh.vt, mesh.ft,
                                       texture_size)
    return inpaint_texture(tex.astype(np.float32), mask)


def render_mesh(mesh: Mesh, extrinsic, intrinsics, height: int, width: int,
                bg_color=(1.0, 1.0, 1.0), light_dir=(0.0, 1.0, 0.5),
                ambient: float = 0.4, device="cuda"):
    """Textured lambertian raycast render -> (H, W, 3) rgb, (H, W) alpha,
    (H, W) depth, numpy (the MeshRenderer role, utils/mesh.py:576-711: the
    Moller-Trumbore caster on ``device`` replaces nvdiffrast; barycentrics
    are recovered from the hit point for the texture lookup)."""
    import torch

    from .._device import resolve_device
    from ..data.camera import get_rays
    from ..ops.raycast import cast_rays

    dev = resolve_device(device)
    c2w = np.linalg.inv(np.asarray(extrinsic))

    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    with torch.no_grad():
        rays_o, rays_d = get_rays(on(c2w)[None], on(intrinsics)[None],
                                  height, width)
        t_hit, prim = cast_rays(rays_o[0], rays_d[0], on(mesh.v),
                                np.asarray(mesh.f))
    ro = rays_o[0].cpu().numpy()
    rd = rays_d[0].cpu().numpy()
    t_hit = t_hit.cpu().numpy()
    prim = prim.cpu().numpy()
    hit = np.isfinite(t_hit) & (prim >= 0)

    rgb = np.broadcast_to(np.asarray(bg_color, np.float32),
                          (height * width, 3)).copy()
    if hit.any():
        p = ro[hit] + rd[hit] * t_hit[hit, None]
        f = mesh.f[prim[hit]]
        a, b, c = mesh.v[f[:, 0]], mesh.v[f[:, 1]], mesh.v[f[:, 2]]
        # barycentrics by projecting onto the triangle plane basis
        e1, e2, ep = b - a, c - a, p - a
        d11 = np.sum(e1 * e1, -1)
        d12 = np.sum(e1 * e2, -1)
        d22 = np.sum(e2 * e2, -1)
        dp1 = np.sum(ep * e1, -1)
        dp2 = np.sum(ep * e2, -1)
        det = np.maximum(d11 * d22 - d12 * d12, 1e-20)
        w1 = np.clip((d22 * dp1 - d12 * dp2) / det, 0, 1)
        w2 = np.clip((d11 * dp2 - d12 * dp1) / det, 0, 1)
        w0 = np.clip(1.0 - w1 - w2, 0, 1)

        if mesh.albedo is not None and mesh.vt is not None:
            tf = mesh.ft[prim[hit]]
            uv = (w0[:, None] * mesh.vt[tf[:, 0]]
                  + w1[:, None] * mesh.vt[tf[:, 1]]
                  + w2[:, None] * mesh.vt[tf[:, 2]])
            Ht, Wt = mesh.albedo.shape[:2]
            ix = np.clip((uv[:, 0] * (Wt - 1)).astype(int), 0, Wt - 1)
            iy = np.clip((uv[:, 1] * (Ht - 1)).astype(int), 0, Ht - 1)
            base_col = mesh.albedo[iy, ix]
        else:
            base_col = np.full((hit.sum(), 3), 0.7, np.float32)

        if mesh.vn is None:
            mesh.auto_normal()
        n = safe_normalize(w0[:, None] * mesh.vn[f[:, 0]]
                           + w1[:, None] * mesh.vn[f[:, 1]]
                           + w2[:, None] * mesh.vn[f[:, 2]])
        ld = safe_normalize(np.asarray(light_dir, np.float32))
        lam = np.maximum(np.sum(n * ld, -1), 0.0)
        shade = ambient + (1.0 - ambient) * lam
        rgb[hit] = base_col * shade[:, None]

    depth = np.where(hit, t_hit, 0.0).reshape(height, width)
    return (rgb.reshape(height, width, 3),
            hit.reshape(height, width).astype(np.float32), depth)

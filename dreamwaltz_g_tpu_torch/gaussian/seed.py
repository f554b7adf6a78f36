"""Gaussian seeding when no stage-1 NeRF cloud exists.

Port of ``dreamwaltz_g_tpu/gaussian/seed.py``: positions sampled on the
SMPL-X surface or taken from its vertices, colors random / constant /
ones / normal-coded, and SuGaR-style KNN radii as scales. The draws come
from a ``torch.Generator``, or are handed in (``fidx`` / ``u`` for the
surface samples, ``colors`` for 'rand'), so tests can give both packages
the same draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.mesh import face_normals_at_vertices, knn, sample_mesh_surface


def seed_positions(kind: str, generator: Optional[torch.Generator],
                   vertices: torch.Tensor, faces, n_gaussians: int,
                   n_per_vertex: int = 1, fidx=None, u=None) -> torch.Tensor:
    """'mesh_surface': ``n_gaussians`` area-weighted surface samples;
    'mesh_vertex': each vertex repeated ``n_per_vertex`` times;
    'mesh_triangle' raises, as in the JAX package."""
    if kind == "mesh_surface":
        pts, _ = sample_mesh_surface(vertices, faces, n_gaussians,
                                     generator=generator, fidx=fidx, u=u)
        return pts
    if kind == "mesh_vertex":
        return torch.repeat_interleave(vertices, max(int(n_per_vertex), 1),
                                       dim=0)
    if kind == "mesh_triangle":
        raise NotImplementedError(
            "gaussian_point_init='mesh_triangle' is not implemented")
    raise ValueError(f"unknown gaussian_point_init {kind!r}")


def seed_colors(kind: str, generator: Optional[torch.Generator],
                positions: torch.Tensor,
                vertices: Optional[torch.Tensor] = None, faces=None,
                draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'rand' uniform (``draws`` (N, 3) or drawn), 'constant' 0.5,
    'ones' 1.0, 'normal' the mean normal-map code of the nearest vertex,
    broadcast to rgb."""
    n = positions.shape[0]
    dev = positions.device
    if kind == "rand":
        if draws is not None:
            return torch.as_tensor(draws, dtype=torch.float32, device=dev)
        return torch.rand((n, 3), generator=generator, device=dev)
    if kind == "constant":
        return torch.full((n, 3), 0.5, device=dev)
    if kind == "ones":
        return torch.ones((n, 3), device=dev)
    if kind == "normal":
        if vertices is None or faces is None:
            raise ValueError("gaussian_color_init='normal' needs the mesh")
        vn = _vertex_normals(vertices, faces)
        code = torch.mean((vn + 1.0) * 0.5, dim=-1, keepdim=True)  # (V, 1)
        _, idx = knn(positions, vertices, 1)
        return code[idx[:, 0]].expand(n, 3)
    raise ValueError(f"unknown gaussian_color_init {kind!r}")


def seed_scales_radius(positions: torch.Tensor, vertices: torch.Tensor,
                       radius_rate: float = 1.0, K: int = 3,
                       use_sqrt: bool = True,
                       use_mean: bool = False) -> torch.Tensor:
    """Per-point isotropic (N, 3) linear scales: the min (or mean) over the
    K nearest inter-vertex distances of the point's nearest vertex, times
    ``radius_rate``."""
    d2, _ = knn(vertices, vertices, K + 1)      # (V, K+1), self first
    d = d2[:, 1:]
    if use_sqrt:
        d = torch.sqrt(d)
    radii = d.mean(-1) if use_mean else d.min(-1).values
    radii = torch.clamp(radii, min=1e-7) * radius_rate   # (V,)
    _, idx = knn(positions, vertices, 1)
    return radii[idx[:, 0]][:, None].expand(positions.shape[0], 3)


def _vertex_normals(vertices: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted vertex normals (the JAX seeding's own, not
    ``ops.mesh.vertex_normals``' mean of unit face normals), summed in a
    fixed order."""
    vn = face_normals_at_vertices(vertices, faces)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True),
                            min=1e-20)

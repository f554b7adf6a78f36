"""DMTet: a learnable SDF and vertex deformation on a tetrahedral grid.

Port of ``dreamwaltz_g_tpu/nerf/dmtet.py``. ``marching_tets``
(``nerf/isosurface.py``) is differentiable through the edge
interpolation, so SDF and deformation gradients flow from any loss on the
extracted surface. The surface renders as one flat Gaussian a triangle
through the 3DGS rasterizer (``render_dmtet_splats``), which on the card
is the train blend's kernels (B1). The band of tets around the seeded
surface, the grid's unique edges and their neighbour table
(``edge_table``) are taken once, on the host, in numpy.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import rasterize as R
from ..utils.transforms import matrix_to_quat, safe_normalize
from .isosurface import TriangleSoup, make_tet_grid, marching_tets


class DMTetParams(NamedTuple):
    sdf: torch.Tensor     # (V,) learnable signed values (> 0 inside)
    deform: torch.Tensor  # (V, 3) learnable vertex offsets (pre-tanh)


class DMTetModel(NamedTuple):
    verts: torch.Tensor   # (V, 3) static grid vertices
    tets: torch.Tensor    # (Tt, 4) int64
    bound: float
    deform_scale: float   # the largest offset: deform_scale x grid spacing

    @staticmethod
    def create(resolution: int = 64, bound: float = 1.0,
               deform_scale: float = 0.45, device="cuda") -> "DMTetModel":
        device = resolve_device(device)
        v, t = make_tet_grid(resolution, bound)
        return DMTetModel(
            verts=torch.as_tensor(v, device=device),
            tets=torch.as_tensor(t, dtype=torch.long, device=device),
            bound=bound,
            deform_scale=deform_scale * 2 * bound / resolution)

    def _query_sigma(self, nerf, verts: torch.Tensor, chunk: int
                     ) -> torch.Tensor:
        with torch.no_grad():
            return torch.cat([nerf.density(p)[0]
                              for p in torch.split(verts, chunk)])

    def init_from_nerf(self, nerf, density_thresh: float = 10.0,
                       chunk: int = 128 ** 2, fit_scale: bool = False
                       ) -> Tuple["DMTetModel", DMTetParams]:
        """Seed the SDF from a field's density, ``clip(sigma -
        density_thresh, -1, 1)``. ``fit_scale``: first rescale the grid to
        the occupied region's extent + 0.1 and query again at the moved
        vertices. Returns (model, params); the model changes with
        ``fit_scale``."""
        model = self
        sigma = self._query_sigma(nerf, model.verts, chunk)
        if fit_scale:
            occupied = sigma > density_thresh
            zero = torch.zeros((), device=sigma.device)
            extent = torch.max(torch.where(occupied[:, None],
                                           torch.abs(model.verts), zero))
            scale = (extent + 1e-1) / model.bound
            scale = torch.where(torch.any(occupied), scale,
                                torch.ones_like(scale))
            model = model._replace(
                verts=model.verts * scale,
                deform_scale=float(model.deform_scale) * float(scale))
            sigma = self._query_sigma(nerf, model.verts, chunk)
        dparams = DMTetParams(
            sdf=torch.clamp(sigma - density_thresh, -1.0, 1.0),
            deform=torch.zeros_like(model.verts))
        return model, dparams

    def prune_to_surface_band(self, dparams: DMTetParams, dilate: int = 3
                              ) -> "DMTetModel":
        """Keep the tets within ``dilate`` rings (through shared vertices)
        of the tets the seeded surface cuts; on the host, once. A seed that
        cuts nothing keeps every tet."""
        sdf = dparams.sdf.detach().cpu().numpy()
        tets = self.tets.cpu().numpy()
        ts = sdf[tets]
        cut = (ts > 0).any(1) & (ts <= 0).any(1)
        keep = cut.copy()
        for _ in range(max(dilate, 0)):
            vmark = np.zeros(sdf.shape[0], bool)
            vmark[tets[keep].reshape(-1)] = True
            keep = keep | vmark[tets].any(1)
        if not keep.any():
            keep = np.ones_like(keep)
        return self._replace(tets=torch.as_tensor(tets[keep],
                                                  device=self.tets.device))

    def init_sphere(self, radius: float = 0.5) -> DMTetParams:
        sdf = radius - torch.linalg.norm(self.verts, dim=-1)
        return DMTetParams(sdf=sdf, deform=torch.zeros_like(self.verts))

    def deformed_verts(self, params: DMTetParams) -> torch.Tensor:
        return self.verts + torch.tanh(params.deform) * self.deform_scale

    def extract(self, params: DMTetParams) -> TriangleSoup:
        return marching_tets(self.deformed_verts(params), params.sdf,
                             self.tets)


def soup_face_normals(soup: TriangleSoup) -> torch.Tensor:
    """(M, 3) unit face normals of the triangles (0 where invalid)."""
    tris = soup.vertices
    n = safe_normalize(torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                          tris[:, 2] - tris[:, 0]))
    return torch.where(soup.valid[:, None], n, torch.zeros_like(n))


def shade_soup(soup: TriangleSoup, albedo: torch.Tensor, shading: str,
               light_d: torch.Tensor, ambient_ratio: float = 1.0
               ) -> torch.Tensor:
    """Per-triangle shading by the face normal: 'albedo', 'normal',
    'textureless' or 'lambertian'."""
    if shading == "albedo":
        return albedo
    n = soup_face_normals(soup)
    if shading == "normal":
        return (n + 1.0) * 0.5
    lam = ambient_ratio + (1.0 - ambient_ratio) * torch.clamp(
        torch.sum(n * light_d[None, :], dim=-1), min=0.0)
    if shading == "textureless":
        return lam[:, None].expand(albedo.shape)
    if shading != "lambertian":
        raise ValueError(f"unknown shading {shading!r}")
    return albedo * lam[:, None]


def soup_normal_consistency(soup: TriangleSoup) -> torch.Tensor:
    """Mean 1 - cos between the two triangles of each tet that emits two
    (the quad's diagonal)."""
    n = soup_face_normals(soup).reshape(-1, 2, 3)
    valid = soup.valid.reshape(-1, 2)
    both = valid[:, 0] & valid[:, 1]
    cos = torch.sum(n[:, 0] * n[:, 1], dim=-1)
    return torch.sum(torch.where(both, 1.0 - cos, torch.zeros_like(cos))) \
        / torch.clamp(torch.sum(both).to(cos.dtype), min=1.0)


def unique_tet_edges(tets) -> np.ndarray:
    """(E, 2) unique undirected edges of the tets (host-side, once), in
    ``np.unique``'s order."""
    t = tets.cpu().numpy() if torch.is_tensor(tets) else np.asarray(tets)
    e = t[:, [0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3]].reshape(-1, 2)
    return np.unique(np.sort(e, axis=1), axis=0)


class EdgeTable(NamedTuple):
    """The edge graph as each vertex's neighbours in a padded table, built
    once on the host (``edge_table``)."""
    neighbours: torch.Tensor  # (V, M) int64; a pad names the vertex itself
    valid: torch.Tensor       # (V, M) bool: the slot holds a neighbour
    degree: torch.Tensor      # (V,) float32
    n_edges: int


def edge_table(edges, n_vertices: int, device=None) -> EdgeTable:
    """Each vertex's neighbours over the (E, 2) ``edges`` (an array or a
    tensor), in the order the JAX package's scatter adds them: first the
    edges where it is the first end, then those where it is the second,
    each in edge order. A row is padded with the vertex's own index (not a
    shared pad row, whose gradient would gather one long run of entries);
    ``valid`` masks the pads. On ``device`` (default: the edges')."""
    if device is None:
        device = edges.device if torch.is_tensor(edges) else "cpu"
    e = (edges.detach().cpu().numpy() if torch.is_tensor(edges)
         else np.asarray(edges)).astype(np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    counts = np.bincount(src, minlength=n_vertices)
    order = np.argsort(src, kind="stable")
    slot = np.arange(src.size) - (np.cumsum(counts) - counts)[src[order]]
    width = max(int(counts.max(initial=0)), 1)
    table = np.repeat(np.arange(n_vertices)[:, None], width, axis=1)
    table[src[order], slot] = dst[order]
    return EdgeTable(
        neighbours=torch.as_tensor(table, device=device),
        valid=torch.as_tensor(np.arange(width)[None] < counts[:, None],
                              device=device),
        degree=torch.as_tensor(counts, dtype=torch.float32, device=device),
        n_edges=int(e.shape[0]))


def tet_laplacian_loss(verts: torch.Tensor, edges) -> torch.Tensor:
    """Uniform Laplacian over the edge graph: the mean squared distance of
    each vertex with an edge from its neighbours' mean. ``edges``: an
    ``EdgeTable`` (the trainer builds one for the run), or (E, 2) edges,
    tabled here. The neighbour sums are a gather through the table and a
    sum over its padded axis, in a fixed order (no atomics), so the loss
    and its gradient repeat to the bit on the card."""
    if not isinstance(edges, EdgeTable):
        edges = edge_table(edges, verts.shape[0], verts.device)
    nbr = torch.where(edges.valid[..., None], verts[edges.neighbours],
                      torch.zeros((), device=verts.device)).sum(1)
    deg = edges.degree[:, None]
    lap = verts - nbr / torch.clamp(deg, min=1.0)
    lap = torch.where(deg > 0, lap, torch.zeros_like(lap))
    return torch.mean(torch.sum(lap ** 2, dim=-1))


def render_dmtet_splats(soup: TriangleSoup, colors: torch.Tensor,
                        extrinsic: torch.Tensor, intrinsics: torch.Tensor,
                        image_height: int, image_width: int,
                        opacity: float = 0.95, **raster_kwargs
                        ) -> R.RasterOutput:
    """One flat Gaussian a triangle: at the centroid, in the face's frame
    (edge 1, the in-plane normal to it, the face normal), scaled to half
    the triangle's extents along the first two axes and 1e-5 along the
    normal; opacity ``opacity`` on valid triangles of nonzero area, 0
    elsewhere. ``raster_kwargs`` go to ``rasterize.rasterize`` (``mode``
    'train': the train blend, B1)."""
    tris = soup.vertices
    M = tris.shape[0]
    centroid = torch.mean(tris, dim=1)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = torch.linalg.cross(e1, e2)
    area2 = torch.linalg.norm(n, dim=-1)
    n_hat = safe_normalize(n)
    x_hat = safe_normalize(e1)
    y_hat = torch.linalg.cross(n_hat, x_hat)
    quats = matrix_to_quat(torch.stack([x_hat, y_hat, n_hat], dim=-1))
    s1 = torch.linalg.norm(e1, dim=-1) * 0.5
    s2 = torch.abs(torch.sum(e2 * y_hat, dim=-1)) * 0.5
    scales = torch.stack([torch.clamp(s1, min=1e-6),
                          torch.clamp(s2, min=1e-6),
                          torch.full((M,), 1e-5, device=tris.device)], dim=-1)
    opac = torch.where(soup.valid & (area2 > 1e-12),
                       torch.full((M,), opacity, device=tris.device),
                       torch.zeros((M,), device=tris.device))
    return R.rasterize(centroid, quats, scales, opac, colors, extrinsic,
                       intrinsics, image_height, image_width,
                       alive=soup.valid, **raster_kwargs)

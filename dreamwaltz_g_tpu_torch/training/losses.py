"""Training losses: ray sparsity, the triplane volume-sparsity prior, the
mesh-surface density guidance, the image reconstruction loss of the
NeRF -> 3DGS distillation (L1 + DSSIM), the KNN offset / scale
regularisers and the mesh regularisers.

Port of ``dreamwaltz_g_tpu/training/losses.py``. The draws are handed in
(``VolumeSparsityDraws``, the sigma-guidance points' faces and uniforms)
or made from a ``torch.Generator``, so that a test can hand the port the
JAX package's draws. As in the JAX package, no trainer path calls
``KnnRegularizer``, ``normal_consistency_loss`` or
``laplacian_smoothing_loss``: the DMTet step regularises its surface with
``nerf/dmtet.py``'s static-shape twins.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mesh import knn, sample_mesh_surface, vertex_normals


# ---------------------------------------------------------------------------
# Sparsity
# ---------------------------------------------------------------------------

def opacity_loss(pred_ws):
    return torch.sqrt(torch.mean(pred_ws ** 2 + 0.01))


def entropy_loss(pred_ws, eps: float = 1e-6):
    a = torch.clamp(pred_ws, eps, 1 - eps)
    return torch.mean(-a * torch.log2(a) - (1 - a) * torch.log2(1 - a))


def emptiness_loss(pred_ws, weight: float = 10000.0, scale: float = 10.0):
    return weight * torch.mean(torch.log(1 + scale * pred_ws))


def sparsity_loss(pred_ws, cfg, current_step: Optional[int] = None,
                  max_iteration: Optional[int] = None):
    """The weighted sum of the three, times ``sparsity_multiplier`` once
    ``current_step / max_iteration >= sparsity_step``."""
    loss = 0.0
    if cfg.lambda_opacity > 0:
        loss += cfg.lambda_opacity * opacity_loss(pred_ws)
    if cfg.lambda_entropy > 0:
        loss += cfg.lambda_entropy * entropy_loss(pred_ws)
    if cfg.lambda_emptiness > 0:
        loss += cfg.lambda_emptiness * emptiness_loss(pred_ws)
    if current_step is not None and max_iteration:
        if current_step / max_iteration >= cfg.sparsity_step:
            loss = loss * cfg.sparsity_multiplier
    return loss


def orientation_loss(weights, normals, dirs):
    loss = weights.detach() * torch.clamp(
        torch.sum(normals * dirs, -1), min=0.0) ** 2
    return torch.mean(loss)


class VolumeSparsityDraws(NamedTuple):
    """The draws of ``volume_sparsity_loss``: ``uniform`` (n - n_sh, 3) in
    [-b, b); and, with surface points, ``pick`` (n_sh,) surface indices,
    ``axis`` (n_sh,) in {0, 1, 2}, ``coord`` (n_sh, 1) in [-b, b) and
    ``fallback`` (n_sh, 3) in [-b, b), n_sh = n // 2."""

    uniform: torch.Tensor
    pick: Optional[torch.Tensor] = None
    axis: Optional[torch.Tensor] = None
    coord: Optional[torch.Tensor] = None
    fallback: Optional[torch.Tensor] = None


def volume_sparsity_draws(generator: torch.Generator, bound: float,
                          n_points: int = 4096,
                          n_surface: Optional[int] = None
                          ) -> VolumeSparsityDraws:
    """Draws for ``volume_sparsity_loss`` on the generator's device; with
    ``n_surface`` (the number of surface points) the shadow draws too."""
    dev = generator.device

    def unif(*shape):
        return (torch.rand(shape, generator=generator, device=dev) * 2 - 1) \
            * bound

    if n_surface is None:
        return VolumeSparsityDraws(uniform=unif(n_points, 3))
    n_sh = n_points // 2
    return VolumeSparsityDraws(
        uniform=unif(n_points - n_sh, 3),
        pick=torch.randint(0, n_surface, (n_sh,), generator=generator,
                           device=dev),
        axis=torch.randint(0, 3, (n_sh,), generator=generator, device=dev),
        coord=unif(n_sh, 1), fallback=unif(n_sh, 3))


def volume_sparsity_loss(model, draws: VolumeSparsityDraws,
                         surface_points: Optional[torch.Tensor] = None,
                         surface_valid: Optional[torch.Tensor] = None):
    """Cauchy density prior, mean log1p(2 sigma^2), at uniform points and,
    with ``surface_points``, at their axis-aligned shadows (each surface
    point with one coordinate resampled), where a triplane's ghost
    intersections can sit. A shadow of an invalid surface point (a ray
    that missed) falls back to a uniform point."""
    b = model.bound
    if surface_points is None:
        pts = draws.uniform
    else:
        surf = surface_points.detach()[draws.pick]
        onehot = F.one_hot(draws.axis.long(), 3).to(surf.dtype)
        shadow = surf * (1.0 - onehot) + draws.coord * onehot
        if surface_valid is not None:
            shadow = torch.where(surface_valid[draws.pick][:, None], shadow,
                                 draws.fallback)
        pts = torch.cat([draws.uniform, torch.clamp(shadow, -b, b)], dim=0)
    sigma, _ = model.density(pts)
    return torch.mean(torch.log1p(2.0 * sigma ** 2))


# ---------------------------------------------------------------------------
# Mesh-surface density guidance
# ---------------------------------------------------------------------------

class SigmaGuidancePoints(NamedTuple):
    """Sample sets of the margin loss."""

    surface: torch.Tensor   # (Ns, 3) on-surface points (density -> +peak)
    offset: torch.Tensor    # (No, 3) off-surface points (density -> -peak)


@torch.no_grad()
def make_sigma_guidance_points(
    vertices: torch.Tensor,
    faces,
    num_points: int = 5000,
    noise_range: float = 0.05,
    surface_thickness: float = 0.005,
    generator: Optional[torch.Generator] = None,
    fidx: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    noise_u: Optional[torch.Tensor] = None,
) -> SigmaGuidancePoints:
    """On-surface points and points offset along the interpolated vertex
    normal by ``(noise_u - 0.5) * noise_range``; an offset within
    ``surface_thickness`` of the surface is pushed out to the full
    ``noise_range`` instead. The draws (``fidx``, ``u`` of
    ``sample_mesh_surface`` and ``noise_u`` (N, 1) uniform) are handed in,
    or drawn from ``generator``."""
    pts, fidx, bary = sample_mesh_surface(vertices, faces, num_points,
                                          generator=generator, fidx=fidx,
                                          u=u, return_bary=True)
    faces = torch.as_tensor(faces, device=vertices.device).long()
    vn = vertex_normals(vertices, faces)[faces[fidx]]          # (N, 3, 3)
    n = torch.einsum("nk,nkd->nd", bary, vn)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    if noise_u is None:
        noise_u = torch.rand((num_points, 1), generator=generator,
                             device=vertices.device)
    noise = (torch.as_tensor(noise_u, device=vertices.device) - 0.5) \
        * noise_range
    noisy = pts + noise * n
    far_enough = torch.abs(noise[:, 0]) > surface_thickness
    offset = torch.where(far_enough[:, None], noisy, pts + n * noise_range)
    return SigmaGuidancePoints(surface=pts, offset=offset)


def sigma_margin_loss(model, pts: SigmaGuidancePoints, peak: float = 15.0,
                      loss_type: str = "margin", delta: float = 0.2):
    """Push the raw (pre-activation) density of the sigma head on the
    field encoding (``model.encode``, as the JAX package does for every
    structure) to +peak on the surface and below -peak off it: 'margin',
    'mse' or 'opacity_mse'."""
    raw_s = model.sigma_mlp(model.encode(pts.surface))[..., 0]
    raw_o = model.sigma_mlp(model.encode(pts.offset))[..., 0]
    if loss_type == "margin":
        neg = torch.relu(raw_o + peak)
        pos = torch.relu(peak - raw_s)
        return torch.mean(neg ** 2) + torch.mean(pos ** 2)
    if loss_type == "mse":
        return torch.mean((raw_s - peak) ** 2) + torch.mean((raw_o + peak) ** 2)
    if loss_type == "opacity_mse":
        op_s = 1.0 - torch.exp(-delta * F.softplus(raw_s))
        op_o = 1.0 - torch.exp(-delta * F.softplus(raw_o))
        return torch.mean((op_s - 1.0) ** 2) + torch.mean(op_o ** 2)
    raise ValueError(f"unknown sigma loss {loss_type!r}")


# ---------------------------------------------------------------------------
# Image reconstruction
# ---------------------------------------------------------------------------

def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None
                     ) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1] (the 3DGS formulation):
    local statistics under a separable Gaussian window, two depthwise
    ``F.conv2d`` passes (along W, then H) over zero-padded images, as the
    JAX package's two 1-D convolutions of the zero-padded rows."""
    k = _gaussian_kernel(window_size, device=img1.device).to(img1.dtype)
    pad = window_size // 2

    def blur(x):
        C = x.shape[-1]
        x = x.permute(2, 0, 1)[:, None]                  # (C, 1, H, W)
        x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, pad))
        x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(pad, 0))
        return x[:, 0].permute(1, 2, 0).reshape(*x.shape[2:], C)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) \
        / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def image_reconstruction_loss(image: torch.Tensor, gt_image: torch.Tensor,
                              lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM) of two (H, W, C) images: 0.8 L1
    + 0.2 DSSIM by default."""
    l1 = torch.mean(torch.abs(image - gt_image))
    return (1.0 - lambda_dssim) * l1 \
        + lambda_dssim * (1.0 - ssim(image, gt_image))


# ---------------------------------------------------------------------------
# KNN offset / scale regularisers
# ---------------------------------------------------------------------------

class KnnRegularizer(NamedTuple):
    """A static KNN structure over anchor vertices; penalises offsets that
    project past half the neighbour distance and scales past it."""

    knn_vectors: torch.Tensor  # (N, K, 3) anchor -> neighbour
    knn_norms: torch.Tensor    # (N, K)

    @staticmethod
    def build(vertices: torch.Tensor, k: int = 5) -> "KnnRegularizer":
        _, idx = knn(vertices, vertices, k + 1)
        idx = idx[:, 1:]  # drop self
        vec = vertices[idx] - vertices[:, None, :]
        return KnnRegularizer(
            knn_vectors=vec,
            knn_norms=torch.clamp(torch.linalg.norm(vec, dim=-1), min=1e-8))

    def offset_loss(self, offsets: torch.Tensor) -> torch.Tensor:
        proj = torch.einsum("nc,nkc->nk", offsets, self.knn_vectors) \
            / self.knn_norms
        err = torch.clamp(proj / self.knn_norms - 0.5, min=0.0)
        return torch.sum(torch.mean(err, dim=-1))

    def scale_loss(self, scales: torch.Tensor) -> torch.Tensor:
        s = torch.max(scales, dim=-1).values[:, None]
        err = torch.clamp(s / self.knn_norms - 1.0, min=0.0)
        return torch.sum(torch.mean(err, dim=-1))


# ---------------------------------------------------------------------------
# Mesh regularisers
# ---------------------------------------------------------------------------

def normal_consistency_loss(vertices: torch.Tensor, faces: torch.Tensor,
                            face_adjacency: torch.Tensor) -> torch.Tensor:
    """Mean 1 - cos between the normals of adjacent faces;
    ``face_adjacency`` (A, 2) pairs of face ids sharing an edge."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    adj = torch.as_tensor(face_adjacency, device=vertices.device).long()
    tri = vertices[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    return torch.mean(1.0 - torch.sum(n[adj[:, 0]] * n[adj[:, 1]], dim=-1))


def laplacian_smoothing_loss(vertices: torch.Tensor, faces: torch.Tensor
                             ) -> torch.Tensor:
    """Uniform Laplacian: the mean of |v - mean(neighbours)|^2 over the
    vertices of some face."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    V = vertices.shape[0]
    dev = vertices.device
    deg = torch.zeros((V,), device=dev).index_add(
        0, faces.reshape(-1), torch.full((faces.numel(),), 2.0, device=dev))
    nbr = torch.zeros((V, 3), device=dev)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        nbr = nbr.index_add(0, faces[:, a], vertices[faces[:, b]])
        nbr = nbr.index_add(0, faces[:, b], vertices[faces[:, a]])
    mean_nbr = nbr / torch.clamp(deg[:, None], min=1.0)
    lap = torch.where(deg[:, None] > 0, vertices - mean_nbr,
                      torch.zeros_like(vertices))
    return torch.mean(torch.sum(lap ** 2, dim=-1))


def face_adjacency_from_faces(faces: np.ndarray) -> np.ndarray:
    """On the host: (A, 2) pairs of faces sharing an edge, in the order
    the edges are first met (the first two faces of each edge)."""
    edge_map = collections.defaultdict(list)
    f = np.asarray(faces)
    for fi in range(f.shape[0]):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((int(f[fi, a]), int(f[fi, b]))))
            edge_map[key].append(fi)
    pairs = [tuple(v[:2]) for v in edge_map.values() if len(v) >= 2]
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.asarray(pairs, np.int64)

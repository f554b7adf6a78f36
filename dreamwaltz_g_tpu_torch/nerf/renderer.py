"""Volume renderer with an occupancy grid.

Port of ``dreamwaltz_g_tpu/nerf/renderer.py``: static shapes throughout,
as in the JAX package.

* An occupancy-only pre-pass over ``num_steps`` coarse samples finds each
  ray's occupied interval; ``num_steps`` stratified samples are placed in
  it and a boolean occupancy lookup masks the dead ones.
* ``compact_samples`` keeps at most ``compact_steps`` occupied samples a
  ray (a stable occupied-first sort, an even stride when a ray has more,
  then a depth re-sort), so only those reach the field.
* Front-to-back compositing is an exclusive ``cumprod`` along the sample
  axis under autograd.
* The occupancy grid is a (G, G, G) boolean array refreshed by EMA density
  queries at jittered cell centres.

Randomness is handed in: ``render_rays`` takes the stratification jitter
``jitter`` (R, num_steps) of uniform [0, 1) draws and ``pdf_u`` for the
importance pass; ``update_occupancy`` takes ``jitter`` (G^3, 3) of uniform
[-0.5, 0.5) draws, or a ``generator`` to draw them. The raymarch and the
gathers are torch ops: the JAX package has no TPU kernel for them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device


class OccupancyGrid(NamedTuple):
    density: torch.Tensor       # (G, G, G) EMA density
    occupied: torch.Tensor      # (G, G, G) bool
    mean_density: torch.Tensor  # () running mean over the cells


def init_occupancy(grid_size: int = 128, device="cuda") -> OccupancyGrid:
    device = resolve_device(device)
    g = grid_size
    return OccupancyGrid(
        density=torch.zeros((g, g, g), device=device),
        occupied=torch.ones((g, g, g), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device))


@torch.no_grad()
def update_occupancy(grid: OccupancyGrid, model, jitter=None,
                     generator: Optional[torch.Generator] = None,
                     density_thresh: float = 10.0, decay: float = 0.95,
                     chunk: int = 256 ** 2) -> OccupancyGrid:
    """EMA density update + threshold: the density at every cell centre,
    jittered within its cell (``jitter`` (G^3, 3) in [-0.5, 0.5) cells,
    else drawn from ``generator``), queried in chunks of ``chunk``
    points."""
    G = grid.density.shape[0]
    dev = grid.density.device
    bound = model.bound
    cell = 2.0 * bound / G
    ii = torch.arange(G, device=dev)
    zz, yy, xx = torch.meshgrid(ii, ii, ii, indexing="ij")
    centers = (torch.stack([zz, yy, xx], -1).reshape(-1, 3) + 0.5) * cell \
        - bound
    if jitter is None:
        if generator is None:
            raise ValueError("pass jitter= or generator=")
        jitter = torch.rand(centers.shape, generator=generator,
                            device=dev) - 0.5
    pts = centers + jitter.to(dev) * cell
    sigma = torch.cat([model.density(p)[0]
                       for p in torch.split(pts, chunk)]).reshape(G, G, G)
    density = torch.maximum(grid.density * decay, sigma)
    mean_density = torch.mean(density)
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyGrid(density=density, occupied=density > thresh,
                         mean_density=mean_density)


def occupancy_lookup(grid: OccupancyGrid, positions: torch.Tensor,
                     bound: float) -> torch.Tensor:
    """Nearest-cell boolean lookup, (..., 3) -> (...,): the cell index
    truncates toward zero (as an int32 cast does), then clips."""
    G = grid.occupied.shape[0]
    idx = torch.clamp(((positions + bound) / (2 * bound) * G).to(torch.int32),
                      0, G - 1).long()
    flat = (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2]
    return grid.occupied.reshape(-1)[flat]


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float,
             min_near: float = 0.05):
    """Slab-method near/far against [-bound, bound]^3; components of the
    direction below 1e-9 in size are clamped to +-1e-9. Returns (near,
    far, hit); a miss gets near = far = 1."""
    tiny = torch.where(rays_d < 0, -1e-9, 1e-9)
    inv = 1.0 / torch.where(torch.abs(rays_d) < 1e-9, tiny, rays_d)
    t1 = (-bound - rays_o) * inv
    t2 = (bound - rays_o) * inv
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    near = torch.clamp(near, min=min_near)
    miss = far <= near
    one = torch.ones_like(near)
    return torch.where(miss, one, near), torch.where(miss, one, far), ~miss


class RenderOutput(NamedTuple):
    image: torch.Tensor        # (R, C)
    depth: torch.Tensor        # (R,)
    weights_sum: torch.Tensor  # (R,)
    normals: Optional[torch.Tensor] = None  # (R, 3), if shaded


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of ray depths: bins (R, B) sorted,
    weights (R, B-1) -> (R, n_samples). ``u`` (R, n_samples) uniform
    draws, or None for the midpoints (i + 0.5) / n. The search is
    left-sided, as ``jnp.searchsorted``'s default."""
    R, Bm1 = weights.shape
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros((R, 1), device=w.device, dtype=w.dtype),
                     torch.cumsum(pdf, dim=-1)], dim=-1)      # (R, B)
    if u is None:
        u = ((torch.arange(n_samples, device=w.device) + 0.5)
             / n_samples).expand(R, n_samples)
    u = u.to(cdf.dtype).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=False)
    lo = torch.clamp(idx - 1, 0, Bm1)
    hi = torch.clamp(idx, 0, Bm1)
    cdf_lo = torch.gather(cdf, -1, lo)
    cdf_hi = torch.gather(cdf, -1, hi)
    bin_lo = torch.gather(bins, -1, lo)
    bin_hi = torch.gather(bins, -1, hi)
    span = cdf_hi - cdf_lo
    denom = torch.where(span < 1e-5, torch.ones_like(span), span)
    frac = (u - cdf_lo) / denom
    return bin_lo + frac * (bin_hi - bin_lo)


def compact_samples(ts: torch.Tensor, live: torch.Tensor, K: int):
    """Keep at most ``K`` occupied samples a ray, in depth order.

    A stable occupied-first sort picks the survivors; a ray with more than
    K occupied candidates keeps an evenly strided subset. The kept panel
    is then re-sorted by depth (stable), since the occupied set need not
    be a depth prefix. Returns ``(ts_sel, live_sel, stride)``, (R, K),
    (R, K), (R, 1); ``stride >= 1`` multiplies dt to keep the
    transmittance integral's support when subsampling."""
    R = ts.shape[0]
    live = live.expand(R, ts.shape[1])
    order = torch.argsort((~live).to(torch.uint8), dim=-1, stable=True)
    n_occ = torch.sum(live, dim=-1)                       # (R,)
    j = torch.arange(K, device=ts.device)
    pos = torch.where(n_occ[:, None] > K,
                      torch.div(j[None] * n_occ[:, None], K,
                                rounding_mode="floor"), j[None])
    sel = torch.gather(order, -1, pos)                    # (R, K)
    ts_sel = torch.gather(ts, -1, sel)
    live_sel = torch.gather(live, -1, sel)
    ro = torch.argsort(ts_sel.detach(), dim=-1, stable=True)
    ts_sel = torch.gather(ts_sel, -1, ro)
    live_sel = torch.gather(live_sel, -1, ro)
    stride = torch.clamp(n_occ.float() / K, min=1.0)[:, None]
    return ts_sel, live_sel, stride


def _points(rays_o, rays_d, ts, bound):
    return torch.clamp(rays_o[:, None] + rays_d[:, None] * ts[..., None],
                       -bound, bound)


def render_rays(
    model,
    grid: Optional[OccupancyGrid],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    jitter: Optional[torch.Tensor] = None,
    num_steps: int = 96,
    upsample_steps: int = 0,
    perturb: bool = False,
    shading: str = "albedo",
    light_dir: Optional[torch.Tensor] = None,
    ambient_ratio: float = 0.1,
    min_near: float = 0.05,
    return_normals: bool = False,
    compact_steps: int = 0,
    pdf_u: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """March ``num_steps`` static samples a ray and composite; with
    ``upsample_steps`` an importance pass follows the coarse weights
    (``pdf_u``: its uniform draws, else the midpoints). ``perturb`` with
    ``jitter`` (R, num_steps) uniform [0, 1) draws stratifies the samples.
    ``compact_steps = K`` runs the field on at most K occupied samples a
    ray (``compact_samples``). Record-function ranges:
    ``nerf.rays_occupancy`` (near / far, the occupancy pre-pass, the
    samples and their compaction), ``nerf.march_field`` (the field at the
    samples) and ``nerf.composite``."""
    R = rays_o.shape[0]
    bound = model.bound
    dev = rays_o.device
    with torch.profiler.record_function("nerf.rays_occupancy"):
        near, far, hit = ray_aabb(rays_o, rays_d, bound, min_near)
        steps = torch.arange(num_steps, device=dev)
        if grid is not None:
            tc = near[:, None] + (far - near)[:, None] * (
                (steps + 0.5) / num_steps)
            occ_c = occupancy_lookup(
                grid, rays_o[:, None] + rays_d[:, None] * tc[..., None],
                bound)
            any_occ = torch.any(occ_c, dim=-1)
            first = torch.argmax(occ_c.to(torch.uint8), dim=-1)
            last = num_steps - 1 - torch.argmax(
                occ_c.flip(-1).to(torch.uint8), dim=-1)
            seg = (far - near) / num_steps
            t0 = torch.where(any_occ, near + first * seg, near)
            t1 = torch.where(any_occ, near + (last + 1) * seg, near + seg)
            hit = hit & any_occ
        else:
            t0, t1 = near, far
        u = (steps + 0.5) / num_steps
        if perturb and jitter is not None:
            u = u + (jitter - 0.5) / num_steps
        ts = t0[:, None] + (t1 - t0)[:, None] * u            # (R, S)
        dt = ((t1 - t0) / num_steps)[:, None]                # (R, 1)
        pts = _points(rays_o, rays_d, ts, bound)
        live = hit[:, None]
        if grid is not None:
            live = live & occupancy_lookup(grid, pts, bound)
        if compact_steps and grid is not None and compact_steps < num_steps:
            ts, live, stride = compact_samples(ts, live, compact_steps)
            dt = dt * stride
            pts = _points(rays_o, rays_d, ts, bound)

    with torch.profiler.record_function("nerf.march_field"):
        S = ts.shape[1]
        sigma, albedo = model.density(pts.reshape(-1, 3))
        sigma = sigma.reshape(R, S)
        albedo = albedo.reshape(R, S, -1)
        sigma = torch.where(live, sigma, torch.zeros_like(sigma))

        if upsample_steps > 0:
            # importance pass: coarse weights (no grad) -> inverse-CDF
            # depths -> merge and depth-sort both sample sets
            cw = _composite_weights(sigma.detach(), dt)
            mids = 0.5 * (ts[:, 1:] + ts[:, :-1])
            new_ts = sample_pdf(mids, cw[:, 1:-1], upsample_steps,
                                pdf_u).detach()
            new_pts = _points(rays_o, rays_d, new_ts, bound)
            s2, a2 = model.density(new_pts.reshape(-1, 3))
            s2 = s2.reshape(R, upsample_steps)
            a2 = a2.reshape(R, upsample_steps, -1)
            live2 = hit[:, None]
            if grid is not None:
                live2 = live2 & occupancy_lookup(grid, new_pts, bound)
            s2 = torch.where(live2, s2, torch.zeros_like(s2))
            ts = torch.cat([ts, new_ts], dim=-1)
            order = torch.argsort(ts.detach(), dim=-1, stable=True)
            ts = torch.gather(ts, -1, order)
            sigma = torch.gather(torch.cat([sigma, s2], dim=-1), -1, order)
            albedo = torch.gather(
                torch.cat([albedo, a2], dim=1), 1,
                order[..., None].expand(-1, -1, albedo.shape[-1]))
            pts = _points(rays_o, rays_d, ts, bound)
            # per-sample deltas, the coarse step as the last
            dt = torch.cat([ts[:, 1:] - ts[:, :-1], dt], dim=-1)

        S = sigma.shape[1]
        normals = None
        if shading != "albedo" or return_normals:
            normals = finite_difference_normals(
                model, pts.reshape(-1, 3)).reshape(R, S, 3)
            color = shade(albedo, normals, shading, light_dir, ambient_ratio)
        else:
            color = albedo

    with torch.profiler.record_function("nerf.composite"):
        w = _composite_weights(sigma, dt)                    # (R, S)
        image = torch.einsum("rs,rsc->rc", w, color)
        depth = torch.einsum("rs,rs->r", w, ts)
        weights_sum = torch.sum(w, dim=-1)
        out_normals = None if normals is None else torch.einsum(
            "rs,rsc->rc", w, normals)
    return RenderOutput(image=image, depth=depth, weights_sum=weights_sum,
                        normals=out_normals)


def _composite_weights(sigma: torch.Tensor, dt: torch.Tensor
                       ) -> torch.Tensor:
    """Front-to-back compositing weights (R, S): alpha times the exclusive
    cumprod of (1 - alpha + 1e-10)."""
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    t_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alpha * t_excl


def finite_difference_normals(model, pts: torch.Tensor,
                              eps: float = 5e-3) -> torch.Tensor:
    """Central-difference density normals, unit length."""
    offs = torch.eye(3, device=pts.device) * eps
    grads = [model.density(pts + offs[d])[0] - model.density(pts - offs[d])[0]
             for d in range(3)]
    n = -torch.stack(grads, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-6)


def shade(albedo, normals, shading: str, light_dir, ambient_ratio: float):
    """'lambertian', 'textureless' or 'normal' shading; else the albedo."""
    if light_dir is None:
        light_dir = torch.tensor([0.0, 1.0, 0.0], device=albedo.device)
    lam = torch.clamp(torch.einsum("...c,c->...", normals, light_dir),
                      min=0.0)
    shade_f = (ambient_ratio + (1.0 - ambient_ratio) * lam)[..., None]
    if shading == "lambertian":
        return albedo * shade_f
    if shading == "textureless":
        return torch.ones_like(albedo) * shade_f
    if shading == "normal":
        return (normals + 1.0) * 0.5
    return albedo


def composite_background(image, weights_sum, bg_color,
                         detach_weights_sum: bool = False):
    """image + (1 - weights_sum) bg; ``detach_weights_sum`` stops the
    gradient into the opacity through the background term."""
    if detach_weights_sum:
        weights_sum = weights_sum.detach()
    return image + (1.0 - weights_sum)[..., None] * bg_color

"""The DMTet finetune (``--nerf.dmtet``): SDS on the marching-tets surface.

Port of ``dreamwaltz_g_tpu/training/dmtet_trainer.py``. A tet grid is
seeded from the (warm-started) stage-1 field and pruned to a band around
its surface (``init_dmtet``); each step extracts the surface, decodes the
field's albedo at the triangles' centroids in checkpointed chunks, shades
and renders the triangles as flat splats through the train blend (B1),
and trains the field, the SDF and the deformation by SDS (the guidance's
flash attention is B4) with the normal-consistency and Laplacian
regularisers. The field keeps its stage-1 optimizer
(``build_nerf_optimizer``); sdf and deform take Adam (b1 0.9, b2 0.99, eps
1e-15) at the field's schedule, as one more ``NeRFOptState`` group.

The step's stages run inside ``torch.profiler.record_function`` ranges:
``dmtet_step.extract``, ``.albedo_decode``, ``.render``, ``.guidance``,
``.regularizers``, ``.backward`` and ``.optimizer``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..guidance.sds import GuidanceParams, ScoreDistillation
from ..nerf.dmtet import (
    DMTetModel,
    DMTetParams,
    EdgeTable,
    edge_table,
    render_dmtet_splats,
    shade_soup,
    soup_normal_consistency,
    tet_laplacian_loss,
    unique_tet_edges,
)
from ..nerf.network import NeRFModel
from ..parallel.mesh import all_reduce_mean
from .optim import Adam, NeRFOptimizer, NeRFOptState, nerf_lr_schedule

#: rows of a checkpointed albedo-decode chunk (the last one zero-padded)
ALBEDO_CHUNK = 65536


class DMTetTrainState(NamedTuple):
    model: NeRFModel        # the stage-1 field (albedo decode; trains on)
    dmtet: DMTetParams      # the learnable SDF and deformation
    opt_state: Tuple[NeRFOptState, NeRFOptState]   # (field, dmtet)
    step: int


def init_dmtet(nerf: NeRFModel, resolution: int,
               density_thresh: float = 10.0, bound: Optional[float] = None,
               band_dilate: int = 3
               ) -> Tuple[DMTetModel, DMTetParams, EdgeTable]:
    """The tet grid at ``resolution`` fitted to the field's occupied
    region, its SDF seeded from the field (``fit_scale``), pruned to the
    band of tets within ``band_dilate`` rings of the seeded surface.
    Returns (model, params, the unique edges' ``EdgeTable``), on the
    field's device."""
    dev = nerf.device
    model = DMTetModel.create(resolution=resolution,
                              bound=bound or nerf.bound, device=dev)
    model, dparams = model.init_from_nerf(nerf, density_thresh=density_thresh,
                                          fit_scale=True)
    model = model.prune_to_surface_band(dparams, dilate=band_dilate)
    edges = edge_table(unique_tet_edges(model.tets), model.verts.shape[0],
                       dev)
    return model, dparams, edges


def build_dmtet_optimizer(cfg, max_steps: int) -> Adam:
    """sdf and deform at the field's learning rate and schedule."""
    return Adam(nerf_lr_schedule(cfg.lr_policy, cfg.lr, max_steps),
                b1=0.9, b2=0.99, eps=1e-15)


def init_train_state(nerf: NeRFModel, dparams: DMTetParams,
                     tx_nerf: NeRFOptimizer, tx_dmtet: Adam
                     ) -> DMTetTrainState:
    """The field's weights and sdf / deform take gradients; the field's
    optimizer state over its groups and sdf / deform's as one group
    'dmtet'; step 0."""
    nerf.requires_grad_(True)
    leaves = [dparams.sdf.requires_grad_(True),
              dparams.deform.requires_grad_(True)]
    geo = NeRFOptState(groups={"dmtet": (leaves, tx_dmtet,
                                         tx_dmtet.init(leaves))})
    return DMTetTrainState(model=nerf, dmtet=dparams,
                           opt_state=(tx_nerf.init(nerf), geo), step=0)


def query_albedo(nerf: NeRFModel, pts: torch.Tensor,
                 chunk: int = ALBEDO_CHUNK) -> torch.Tensor:
    """The field's albedo channels at (N, 3) points, in chunks of
    ``chunk`` rows (zero-padded to a multiple), each checkpointed when a
    gradient is taken: its forward is recomputed in the backward."""
    n = pts.shape[0]
    pad = (-n) % chunk
    if pad:
        pts = torch.cat([pts, torch.zeros((pad, 3), dtype=pts.dtype,
                                          device=pts.device)])

    def dec(p):
        return nerf.density(p)[1]

    grad = torch.is_grad_enabled()
    outs = [checkpoint(dec, p, use_reentrant=False) if grad else dec(p)
            for p in torch.split(pts, chunk)]
    return torch.cat(outs)[:n]


def _check_device(model: NeRFModel, device: torch.device) -> None:
    got = model.device
    if got.type != device.type or device.index not in (None, got.index):
        raise ValueError(f"the field is on {got}, the step on {device}")


def make_dmtet_sds_step(
    nerf: NeRFModel,
    dmtet_model: DMTetModel,
    tet_edges: EdgeTable,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    nerf_cfg,
    lambda_guidance: float = 1.0,
    neg_embeds=None,
    ambient_ratio: float = 1.0,
    pgc=None,
    tile_size: int = 32,
    capacity: int = 1024,
    chunk: int = 128,
    max_tiles_per_gaussian: int = 8,
    device="cuda",
) -> Callable:
    """One DMTet SDS step: ``step(tstate, gparams, extrinsic, intrinsics,
    campos, bg_color, text_embeds, uncond_embeds, t, light_noise=None,
    noise=None, generator=None, cond_image=None, guidance_scale=None,
    shading="albedo", progress=None)`` -> (tstate', {"loss", "sds_loss",
    "mesh_normal_loss", "mesh_laplacian_loss", "tile_overflow"}).

    Extract the surface -> albedo at the centroids -> shade (the light
    ``campos`` + ``light_noise``, normalised) -> splat render (B1) ->
    composite over ``bg_color`` -> ``pgc`` -> guidance -> + the
    regularisers -> backward -> the field's update and sdf / deform's.
    Draws not handed in come from ``generator``: the light's (3,) normal
    first, then the SDS noise. ``nerf_cfg.lock_geo`` stops the gradient
    into sdf / deform and skips their update (their moments stay as they
    are). ``neg_embeds`` (the csd / nfsd negative branch) and the step's
    ``progress`` (step / max_iteration) go to the guidance."""
    device = resolve_device(device)
    H, W = image_height, image_width
    lock_geo = bool(getattr(nerf_cfg, "lock_geo", False))
    lam_nc = float(getattr(nerf_cfg, "lambda_mesh_normal", 0.5))
    lam_lap = float(getattr(nerf_cfg, "lambda_mesh_laplacian", 0.5))
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="train")

    def step(tstate: DMTetTrainState, gparams: GuidanceParams, extrinsic,
             intrinsics, campos, bg_color, text_embeds, uncond_embeds, t,
             light_noise=None, noise=None,
             generator: Optional[torch.Generator] = None, cond_image=None,
             guidance_scale=None, shading: str = "albedo", progress=None):
        _check_device(nerf, device)
        opt_n, opt_d = tstate.opt_state
        opt_n.zero_grad()
        opt_d.zero_grad()
        if light_noise is None:
            if generator is None:
                raise ValueError("pass light_noise= or generator=")
            light_noise = torch.randn((3,), generator=generator,
                                      device=device)
        light = campos + light_noise
        light = light / torch.clamp(torch.linalg.norm(light), min=1e-8)
        dparams = tstate.dmtet
        if lock_geo:
            dparams = DMTetParams(*[x.detach() for x in dparams])
        with record_function("dmtet_step.extract"):
            soup = dmtet_model.extract(dparams)
            centroids = torch.mean(soup.vertices, dim=1)
        with record_function("dmtet_step.albedo_decode"):
            albedo = query_albedo(nerf, centroids)[..., :3]
        with record_function("dmtet_step.render"):
            colors = shade_soup(soup, albedo, shading, light,
                                ambient_ratio=ambient_ratio)
            out = render_dmtet_splats(soup, colors, extrinsic, intrinsics,
                                      H, W, **raster)
            img = out.image + (1.0 - out.alpha)[..., None] * bg_color
            if pgc is not None and img.shape[-1] == 3:
                img = pgc(img)
        with record_function("dmtet_step.guidance"):
            sds = guidance(gparams, img[None], text_embeds, uncond_embeds, t,
                           noise=noise, cond_image=cond_image,
                           guidance_scale=guidance_scale,
                           generator=generator, neg_embeds=neg_embeds,
                           progress=progress)
        loss = lambda_guidance * sds["loss"]
        metrics = {"sds_loss": sds["loss"].detach(),
                   "tile_overflow": out.overflow}
        with record_function("dmtet_step.regularizers"):
            if lam_nc > 0:
                nc = soup_normal_consistency(soup)
                loss = loss + lam_nc * nc
                metrics["mesh_normal_loss"] = nc.detach()
            if lam_lap > 0:
                lap = tet_laplacian_loss(
                    dmtet_model.deformed_verts(dparams), tet_edges)
                loss = loss + lam_lap * lap
                metrics["mesh_laplacian_loss"] = lap.detach()
        with record_function("dmtet_step.backward"):
            loss.backward()
            # several ranks run this one view alike: the mean of their
            # gradients keeps their states equal to the bit
            all_reduce_mean([p.grad for o in (opt_n, opt_d)
                             for params, _, _ in o.groups.values()
                             for p in params])
        with record_function("dmtet_step.optimizer"):
            opt_n.step()
            if not lock_geo:
                opt_d.step()
        metrics["loss"] = loss.detach()
        return DMTetTrainState(nerf, tstate.dmtet, (opt_n, opt_d),
                               tstate.step + 1), metrics

    return step


def make_dmtet_eval_render(nerf: NeRFModel, dmtet_model: DMTetModel,
                           image_height: int, image_width: int,
                           tile_size: int = 32, capacity: int = 1024,
                           chunk: int = 128, device="cuda") -> Callable:
    """Full-frame albedo render of the extracted surface: ``render(state,
    cam_c2w, cam_intr, bg_color)`` -> (image (H, W, 3), depth, alpha),
    through the train blend's forward (B1), as the JAX package renders
    it."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  mode="train")

    @torch.no_grad()
    def render(state: DMTetTrainState, cam_c2w, cam_intr, bg_color):
        _check_device(nerf, device)
        extrinsic = torch.linalg.inv(cam_c2w)
        soup = dmtet_model.extract(state.dmtet)
        albedo = query_albedo(nerf, torch.mean(soup.vertices, dim=1))[..., :3]
        out = render_dmtet_splats(soup, albedo, extrinsic, cam_intr, H, W,
                                  **raster)
        img = out.image + (1.0 - out.alpha)[..., None] * bg_color
        return img, out.depth, out.alpha

    return render

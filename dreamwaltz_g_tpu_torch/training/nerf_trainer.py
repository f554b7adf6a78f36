"""Stage-1 trainers: the NeRF pretrain (depth / mask MSE) and the NeRF SDS
step.

Port of ``dreamwaltz_g_tpu/training/nerf_trainer.py``. The field holds its
own weights (``nerf/network.py``), so ``NeRFTrainState`` carries the model
where the JAX state carries its parameter tree, and the optimizer's state
carries its groups (``training/optim.py``).

Randomness is handed in or drawn from a ``torch.Generator``. The JAX step
splits its key into the render's, the guidance's and the volume-sparsity
prior's; here those are ``jitter`` (the stratification draws), ``noise``
(the SDS noise) and ``vs_draws`` (``losses.VolumeSparsityDraws``). With
``ray_chunk``, the JAX package hands every chunk the same key, so every
chunk takes the same (ray_chunk, num_steps) jitter: a reference behaviour
that is copied here (``jitter_shape``). The chunks are checkpointed
(``torch.utils.checkpoint``, non-reentrant): their forward is recomputed
in the backward, with the same jitter, drawn once outside.

The step's stages run inside ``torch.profiler.record_function`` ranges
that a profiler reads and that cost nothing without one:
``nerf.rays_occupancy``, ``nerf.march_field`` and ``nerf.composite`` (per
chunk), ``nerf_step.regularizers``, the guidance's own
(``nerf_step.guidance`` around ``sds.encode_images`` and
``sds.latent_gradients``), ``nerf_step.backward`` and
``nerf_step.optimizer``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..data.camera import get_rays
from ..guidance.sds import GuidanceParams, ScoreDistillation
from ..nerf.network import NeRFModel
from ..nerf.renderer import OccupancyGrid, render_rays, update_occupancy
from .losses import (SigmaGuidancePoints, VolumeSparsityDraws,
                     sigma_margin_loss, sparsity_loss, volume_sparsity_draws,
                     volume_sparsity_loss)
from .optim import NeRFOptimizer, NeRFOptState


class NeRFTrainState(NamedTuple):
    model: NeRFModel
    opt_state: NeRFOptState
    step: int


def init_train_state(model: NeRFModel, tx: NeRFOptimizer) -> NeRFTrainState:
    """Every weight of ``model`` takes a gradient; the optimizer's state
    over its groups; step 0."""
    model.requires_grad_(True)
    return NeRFTrainState(model=model, opt_state=tx.init(model), step=0)


def _check_device(model: NeRFModel, device: torch.device) -> None:
    got = model.device
    if got.type != device.type or device.index not in (None, got.index):
        raise ValueError(f"the field is on {got}, the step on {device}")


def jitter_shape(image_height: int, image_width: int, ray_chunk: int,
                 num_steps: int):
    """The shape of the render's stratification draws: one (ray_chunk,
    num_steps) panel shared by every chunk when the rays are chunked, else
    one row a ray."""
    n = image_height * image_width
    return (ray_chunk if ray_chunk and n > ray_chunk else n, num_steps)


def _render_image(model, grid, cam_c2w, cam_intr, H, W, jitter, num_steps,
                  bg_color, shading="albedo", bg_mode="color",
                  upsample_steps=0, ray_chunk=0, min_near=0.05,
                  compact_steps=0, detach_bg_ws=False, pdf_u=None):
    """Render a full (H, W, C) image; returns (image, depth (H, W),
    weights_sum (H, W)). ``bg_mode='nerf'`` composites the background MLP
    at the ray directions in place of ``bg_color``. ``ray_chunk``: march
    the rays in checkpointed chunks of that many (the last padded), each
    with the same ``jitter``."""
    with record_function("nerf.rays_occupancy"):
        rays_o, rays_d = get_rays(cam_c2w[None], cam_intr[None], H, W)
        ro, rd = rays_o[0], rays_d[0]
    kw = dict(num_steps=num_steps, upsample_steps=upsample_steps,
              min_near=min_near, compact_steps=compact_steps, perturb=True,
              shading=shading, pdf_u=pdf_u)
    n = ro.shape[0]
    if ray_chunk and n > ray_chunk:
        pad = (-n) % ray_chunk
        if pad:
            ro = torch.cat([ro, torch.zeros((pad, 3), device=ro.device)])
            rd = torch.cat([rd, torch.ones((pad, 3), device=rd.device)])

        def render_chunk(o, d):
            return tuple(render_rays(model, grid, o, d, jitter=jitter,
                                     **kw)[:3])

        outs = []
        for o, d in zip(ro.split(ray_chunk), rd.split(ray_chunk)):
            if torch.is_grad_enabled():
                outs.append(checkpoint(render_chunk, o, d,
                                       use_reentrant=False))
            else:
                outs.append(render_chunk(o, d))
        image, depth, wsum = (torch.cat(x)[:n] for x in zip(*outs))
    else:
        image, depth, wsum = render_rays(model, grid, ro, rd, jitter=jitter,
                                         **kw)[:3]
    with record_function("nerf.composite"):
        if bg_mode == "nerf" and model.bg_mlp is not None:
            bg = model.background(rays_d[0])
        else:
            bg = bg_color
        ws = wsum.detach() if detach_bg_ws else wsum
        img = image + (1.0 - ws)[:, None] * bg
    return img.reshape(H, W, -1), depth.reshape(H, W), wsum.reshape(H, W)


def _draw(shape, generator, device, what):
    if generator is None:
        raise ValueError(f"pass {what}= or generator=")
    return torch.rand(shape, generator=generator, device=device)


def _vs_weight(cfg) -> float:
    """The volume-sparsity prior's weight: triplane fields only."""
    return cfg.triplane_volume_sparsity \
        if getattr(cfg, "backbone", "") == "triplane" else 0.0


def pretrain_losses(model: NeRFModel, grid: OccupancyGrid, cam_c2w,
                    cam_intr, gt_depth, gt_mask, jitter,
                    num_steps: int = 96, compact_steps: int = 0):
    """The pretrain's (mask MSE, depth MSE on the mask) of one view of
    ``gt_mask``'s (H, W), with the stratification ``jitter``."""
    H, W = gt_mask.shape
    zeros = torch.zeros(model.color_channels, device=gt_depth.device)
    _, depth, wsum = _render_image(
        model, grid, cam_c2w, cam_intr, H, W, jitter, num_steps, zeros,
        compact_steps=compact_steps)
    m = gt_mask.float()
    mask_loss = torch.mean((wsum - m) ** 2)
    depth_loss = torch.sum(m * (depth - gt_depth) ** 2) \
        / torch.clamp(torch.sum(m), min=1.0)
    return mask_loss, depth_loss


def make_pretrain_step(model: NeRFModel, image_height: int, image_width: int,
                       num_steps: int = 96, lambda_mask: float = 1.0,
                       lambda_depth: float = 1.0, compact_steps: int = 0,
                       device="cuda") -> Callable:
    """Depth / mask MSE against SMPL-X depth and mask renders:
    ``step(tstate, grid, cam_c2w, cam_intr, gt_depth, gt_mask, jitter=None,
    vs_draws=None, generator=None)`` -> (tstate', {"loss", "mask_loss",
    "depth_loss"}). On a triplane field the volume-sparsity prior's shadow
    samples come from the ground-truth surface (the depth backprojected)."""
    device = resolve_device(device)
    H, W = image_height, image_width
    vs_weight = _vs_weight(model.cfg)

    def step(tstate: NeRFTrainState, grid: OccupancyGrid, cam_c2w, cam_intr,
             gt_depth, gt_mask, jitter=None,
             vs_draws: Optional[VolumeSparsityDraws] = None,
             generator: Optional[torch.Generator] = None):
        _check_device(model, device)
        tstate.opt_state.zero_grad()
        if jitter is None:
            jitter = _draw((H * W, num_steps), generator, device, "jitter")
        mask_loss, depth_loss = pretrain_losses(
            model, grid, cam_c2w, cam_intr, gt_depth, gt_mask, jitter,
            num_steps=num_steps, compact_steps=compact_steps)
        loss = lambda_mask * mask_loss + lambda_depth * depth_loss
        if vs_weight > 0.0:
            rays_o, rays_d = get_rays(cam_c2w[None], cam_intr[None], H, W)
            surf = rays_o[0] + rays_d[0] * gt_depth.reshape(-1, 1)
            if vs_draws is None:
                vs_draws = volume_sparsity_draws(generator, model.bound,
                                                 n_surface=surf.shape[0])
            loss = loss + vs_weight * volume_sparsity_loss(
                model, vs_draws, surface_points=surf,
                surface_valid=gt_mask.reshape(-1) != 0)
        loss.backward()
        tstate.opt_state.step()
        metrics = {"loss": loss.detach(), "mask_loss": mask_loss.detach(),
                   "depth_loss": depth_loss.detach()}
        return NeRFTrainState(model, tstate.opt_state, tstate.step + 1), \
            metrics

    return step


def make_nerf_sds_step(
    model: NeRFModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    nerf_cfg,
    num_steps: int = 96,
    lambda_guidance: float = 1.0,
    neg_embeds=None,
    lambda_sigma: float = 1.0,
    sigma_peak: float = 15.0,
    sigma_loss_type: str = "margin",
    max_iteration: int = 10000,
    bg_mode: str = "color",
    ray_chunk: int = 0,
    pgc=None,
    tp_lr_weights=None,
    device="cuda",
) -> Callable:
    """One SDS step on the NeRF: render -> guidance loss -> sparsity,
    volume-sparsity and sigma-margin regularisers -> backward -> update.

    ``step(tstate, grid, gparams, cam_c2w, cam_intr, bg_color, text_embeds,
    uncond_embeds, t, jitter=None, noise=None, vs_draws=None,
    generator=None, cond_image=None, guidance_scale=None, sigma_pts=None,
    use_sigma=False, pdf_u=None, progress=None)`` -> (tstate', {"loss",
    "sds_loss", "sparsity_loss"[, "sigma_loss"]}). A draw not handed in
    comes from ``generator``: the jitter (``jitter_shape``), then the
    volume-sparsity draws, then the SDS noise. ``tp_lr_weights`` (T,): the 'ddpm' lr
    policy's per-timestep weights, applied to this step's updates at
    ``t[0]``. ``pgc``: the pixel-gradient hook on the 3-channel render.
    ``neg_embeds`` (the csd / nfsd negative branch) and the step's
    ``progress`` (step / max_iteration) go to the guidance."""
    device = resolve_device(device)
    H, W = image_height, image_width
    vs_weight = _vs_weight(nerf_cfg)
    upsample = getattr(nerf_cfg, "upsample_steps", 0)
    if tp_lr_weights is not None:
        tp_lr_weights = torch.as_tensor(tp_lr_weights, dtype=torch.float32,
                                        device=device)

    def step(tstate: NeRFTrainState, grid: OccupancyGrid,
             gparams: GuidanceParams, cam_c2w, cam_intr, bg_color,
             text_embeds, uncond_embeds, t, jitter=None, noise=None,
             vs_draws: Optional[VolumeSparsityDraws] = None,
             generator: Optional[torch.Generator] = None, cond_image=None,
             guidance_scale=None,
             sigma_pts: Optional[SigmaGuidancePoints] = None,
             use_sigma: bool = False, pdf_u=None, progress=None):
        _check_device(model, device)
        tstate.opt_state.zero_grad()
        if jitter is None:
            jitter = _draw(jitter_shape(H, W, ray_chunk, num_steps),
                           generator, device, "jitter")
        if upsample > 0 and pdf_u is None:
            pdf_u = _draw((jitter.shape[0], upsample), generator, device,
                          "pdf_u")
        img, ren_depth, wsum = _render_image(
            model, grid, cam_c2w, cam_intr, H, W, jitter, num_steps,
            bg_color, bg_mode=bg_mode, ray_chunk=ray_chunk,
            min_near=getattr(nerf_cfg, "min_near", 0.05),
            upsample_steps=upsample,
            compact_steps=getattr(nerf_cfg, "compact_steps", 0),
            detach_bg_ws=getattr(nerf_cfg, "detach_bg_weights_sum", False),
            pdf_u=pdf_u)
        if pgc is not None and img.shape[-1] == 3:
            if getattr(pgc, "wants_mask", False):
                img = pgc(img, wsum.detach()[..., None])
            else:
                img = pgc(img)
        with record_function("nerf_step.regularizers"):
            metrics = {}
            sp = sparsity_loss(wsum.reshape(-1), nerf_cfg, tstate.step,
                               max_iteration)
            reg = sp
            metrics["sparsity_loss"] = sp.detach() if torch.is_tensor(sp) \
                else torch.tensor(sp, device=device)
            if vs_weight > 0.0:
                # the rendered depth is the surface estimate whose axis
                # shadows seed the targeted samples
                rays_o, rays_d = get_rays(cam_c2w[None], cam_intr[None], H, W)
                surf = rays_o[0] + rays_d[0] * ren_depth.detach().reshape(-1, 1)
                if vs_draws is None:
                    vs_draws = volume_sparsity_draws(
                        generator, model.bound, n_surface=surf.shape[0])
                reg = reg + vs_weight * volume_sparsity_loss(
                    model, vs_draws, surface_points=surf,
                    surface_valid=wsum.detach().reshape(-1) > 0.5)
            if use_sigma and sigma_pts is not None:
                sg = sigma_margin_loss(model, sigma_pts, peak=sigma_peak,
                                       loss_type=sigma_loss_type)
                reg = reg + lambda_sigma * sg
                metrics["sigma_loss"] = sg.detach()
        with record_function("nerf_step.guidance"):
            sds = guidance(gparams, img[None], text_embeds, uncond_embeds, t,
                           noise=noise, cond_image=cond_image,
                           guidance_scale=guidance_scale,
                           generator=generator, neg_embeds=neg_embeds,
                           progress=progress)
        loss = lambda_guidance * sds["loss"] + reg
        with record_function("nerf_step.backward"):
            loss.backward()
        with record_function("nerf_step.optimizer"):
            scale = None
            if tp_lr_weights is not None:
                i = torch.as_tensor(t, device=device).reshape(-1)[0].long()
                scale = tp_lr_weights[torch.clamp(
                    i, 0, tp_lr_weights.shape[0] - 1)]
            tstate.opt_state.step(scale)
        metrics.update(loss=loss.detach(), sds_loss=sds["loss"].detach())
        return NeRFTrainState(model, tstate.opt_state, tstate.step + 1), \
            metrics

    return step


def maybe_update_occupancy(tstate: NeRFTrainState, grid: OccupancyGrid,
                           model: NeRFModel, interval: int = 16,
                           density_thresh: float = 10.0, jitter=None,
                           generator: Optional[torch.Generator] = None
                           ) -> OccupancyGrid:
    """The EMA occupancy refresh every ``interval`` steps (at steps
    divisible by it, step 0 included); the cells' jitter handed in or
    drawn from ``generator``."""
    if tstate.step % interval == 0:
        return update_occupancy(grid, model, jitter=jitter,
                                generator=generator,
                                density_thresh=density_thresh)
    return grid


# rays a pass of the eval render: the rays are independent, so the chunks
# give the whole frame's render; a 512^2 frame's 33.5M samples at once would
# hold tens of GiB of field intermediates
EVAL_RAY_CHUNK = 32768


def make_eval_render(model: NeRFModel, image_height: int, image_width: int,
                     num_steps: int = 128, device="cuda") -> Callable:
    """Full-frame eval render, no stratification, ``EVAL_RAY_CHUNK`` rays a
    pass: ``render(grid, cam_c2w, cam_intr, bg_color)`` -> (image
    (H, W, C), depth, weights_sum)."""
    device = resolve_device(device)
    H, W = image_height, image_width

    @torch.no_grad()
    def render(grid: OccupancyGrid, cam_c2w, cam_intr, bg_color):
        _check_device(model, device)
        rays_o, rays_d = get_rays(cam_c2w[None], cam_intr[None], H, W)
        outs = [render_rays(model, grid, o, d, num_steps=num_steps,
                            perturb=False)
                for o, d in zip(rays_o[0].split(EVAL_RAY_CHUNK),
                                rays_d[0].split(EVAL_RAY_CHUNK))]
        image, depth, ws = (torch.cat([getattr(o, k) for o in outs])
                            for k in ("image", "depth", "weights_sum"))
        img = image + (1.0 - ws)[:, None] * bg_color
        return img.reshape(H, W, -1), depth.reshape(H, W), ws.reshape(H, W)

    return render

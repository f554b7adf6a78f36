"""Multi-view SDS steps: B views a step, one view-mean gradient.

Port of ``dreamwaltz_g_tpu/parallel/dp.py``. The JAX package ``vmap``s one
view's loss over the B views of ``--optim.batch_size`` and shards them over
its mesh's ``data`` axis; SDS averages the views' gradients, so a B-view
step is B single-view steps averaged. Here one process runs its views
batched:

* the render animates once (or once a view with ``per_view_poses``),
  projects and bins each view, and blends all of them through one train
  blend with a leading view dimension V = B (``rasterize.
  rasterize_projected_views``: on the card one B1 forward and one B1
  backward launch a step, as the ``vmap`` batches the Pallas grid);
* the guidance runs once on the B images, a CFG batch of 2B, with each
  view's timestep, text, null text, condition image and noise. Its loss is
  ``sum(latents * grad) / B``, the mean of the views' losses, since nothing
  in it reduces across the batch (the latent clip takes each view's own
  statistic);
* the densifier's ``dummy`` on the screen-space means is shared by the
  views, so its gradient is the sum over views of the mean loss's; the
  radii are the views' maximum;
* the stage-1 step renders each view with its own draws (jitter, volume-
  sparsity points) and its own occupancy compaction, the regularisers
  inside each view's loss and the sigma loss once outside the mean.

On a (data, model) mesh (``mesh.make_mesh_2d``; ``mesh=``, else
``mesh.make_mesh()``, the data axis of every rank) each model group runs
its B / dp views (``mesh.shard_batch`` by the data index), the guidance
sharded over the model group (``parallel/tp.py``: its layers hold the
group), every gradient (the ``dummy``'s too) is all-reduced to the mean
over every rank and the radii to their maximum, and every rank takes the
same optimizer step. The ranks of a model group compute the same views,
so the mean over every rank is the mean over the data axis, and it leaves
the group's replicas equal to the bit (the render's backward adds in no
fixed order on the card). With fewer views than model groups the spare
groups are replicas; the trainer takes these steps whenever it runs on
several ranks, a single view included. At dp = 1 and tp = 2 the step is
one view on two ranks. With a single rank no collective is launched.

Randomness: ``noise`` (B, h, w, 4), the stage-1 ``jitter`` / ``pdf_u`` (B,
...) and ``vs_draws`` (a list of B) are handed in, or drawn from
``generator``: one ``torch.Generator`` drawn view after view, or a list of
one a view (the JAX package's per-view keys). With W > 1, hand in the
draws or a generator a view.

The default ``max_tiles_per_gaussian`` is 8, the JAX DP steps' (the
single-view steps bin 16).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..data.camera import get_rays
from ..gaussian.densify import update_stats
from ..guidance.sds import GuidanceParams, ScoreDistillation
from ..human.smplx_model import SMPLXParams
from ..nerf.renderer import OccupancyGrid
from ..ops import rasterize as R
from ..system.avatar import AvatarModel, animate, update_avatar_stats
from ..system.background import BackgroundMLPNet, mlp_background_image
from ..system.vanilla import VanillaAvatarModel, animate_vanilla
from ..training.gs_trainer import (
    AvatarTrainState,
    BackgroundTrainState,
    VanillaTrainState,
    _check_device,
    _check_vanilla_device,
    _leaves,
    _person,
    _place_and_merge,
    background_update,
)
from ..training.losses import (
    sigma_margin_loss,
    sparsity_loss,
    volume_sparsity_draws,
    volume_sparsity_loss,
)
from ..training.nerf_trainer import (
    NeRFTrainState,
    _check_device as _check_field_device,
    _draw,
    _render_image,
    _vs_weight,
    jitter_shape,
)
from .mesh import (
    DataMesh,
    all_reduce_max,
    all_reduce_mean,
    make_mesh,
    shard_batch,
)


def _view_generator(generator, i: int):
    """View ``i``'s generator: its own from a list, else the shared one."""
    return generator[i] if isinstance(generator, (list, tuple)) \
        else generator


def _expand(embeds: Optional[torch.Tensor], B: int):
    """A (1, L, D) context for every view."""
    if embeds is None or embeds.shape[0] == B:
        return embeds
    return embeds.expand(B, *embeds.shape[1:])


def _grads(params):
    return [p.grad for p in params]


def _adam_params(opt_state):
    return [p for g in opt_state.adam.param_groups for p in g["params"]]


def _guidance_kwargs(noise, cond_image, guidance_scale, generator,
                     neg_embeds, progress, B):
    return dict(noise=noise, cond_image=cond_image,
                guidance_scale=guidance_scale, generator=generator,
                neg_embeds=_expand(neg_embeds, B), progress=progress)


def _views(sets, extrinsic, intrinsics, tanfov, H, W):
    """Project each view's Gaussian set (and its ``dummy``) with its
    camera: the ``Gaussians2D`` of the B views."""
    out = []
    for i, (gs, dm) in enumerate(sets):
        cov3d = R.covariance3d(gs.quats, gs.scales)
        g2d = R.project_gaussians(
            gs.positions, cov3d, gs.opacities, gs.colors, extrinsic[i],
            intrinsics[i], H, W, tanfov=tanfov[i], alive=gs.alive)
        out.append(g2d._replace(means2d=g2d.means2d + dm))
    return out


def _composite(out, backgrounds, pgc):
    """(B, H, W, 3) images: each view over its background, the
    pixel-gradient hook on each view's own image."""
    images = []
    for i in range(out.image.shape[0]):
        img = out.image[i] + (1.0 - out.alpha[i])[..., None] * backgrounds[i]
        if pgc is not None and img.shape[-1] == 3:
            img = pgc(img)
        images.append(img)
    return torch.stack(images)


def make_avatar_sds_step_dp(
    model: AvatarModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 8,
    lambda_guidance: float = 1.0,
    per_view_poses: bool = False,
    neg_embeds: Optional[torch.Tensor] = None,
    pgc: Optional[Callable] = None,
    bg_net: Optional[BackgroundMLPNet] = None,
    bg_tx=None,
    placement=None,
    static_gaussians=None,
    mesh: Optional[DataMesh] = None,
    device="cuda",
) -> Callable:
    """The B-view avatar SDS step: ``step(tstate, gparams,
    observed_inputs, extrinsic (B, 4, 4), intrinsics (B, 3, 3), tanfov
    (B,), background (B, H, W, 3), text_embeds (B, L, D), uncond_embeds
    (B, L, D), t (B,), noise=None, cond_image=None (B, h, w, 3),
    guidance_scale=None, generator=None, progress=None, bg_state=None,
    c2w=None)`` -> (tstate', {"loss", "sds_loss", "tile_overflow"}).

    With ``per_view_poses`` the SMPL-X batch is the view batch (each view
    animates its own pose); otherwise the one pose is shared. With
    ``bg_net`` / ``bg_tx`` each view composites the MLP background at its
    own rays (``c2w`` (B, 4, 4); ``background`` is not read), the net's
    view-mean gradient takes a step of its Adan, and the step returns
    (tstate', bg_state', metrics). ``mesh``: the (data, model) mesh, else
    the data axis of every rank (module docstring). Ranges:
    ``dp_step.render``, ``.guidance``, ``.backward``,
    ``.optimizer_stats``."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian)
    mesh = mesh if mesh is not None else make_mesh(device=device)

    def step(tstate: AvatarTrainState, gparams: GuidanceParams,
             observed_inputs: SMPLXParams, extrinsic, intrinsics, tanfov,
             background, text_embeds, uncond_embeds, t,
             noise: Optional[torch.Tensor] = None, cond_image=None,
             guidance_scale=None, generator=None, progress=None,
             bg_state: Optional[BackgroundTrainState] = None,
             c2w: Optional[torch.Tensor] = None) -> tuple:
        if bg_net is not None and (bg_state is None or c2w is None):
            raise ValueError("the trainable-background step needs bg_state "
                             "and c2w")
        state = tstate.avatar
        _check_device(state, device)
        C = state.capacity
        if per_view_poses:
            observed_inputs = shard_batch(observed_inputs, mesh)
        (extrinsic, intrinsics, tanfov, background, text_embeds,
         uncond_embeds, t, noise, cond_image, generator, c2w) = shard_batch(
            (extrinsic, intrinsics, tanfov, background, text_embeds,
             uncond_embeds, t, noise, cond_image, generator, c2w), mesh)
        B = extrinsic.shape[0]
        leaves = _leaves(state, model)
        for leaf in leaves:
            leaf.grad = None
        if bg_net is not None:
            bg_net.zero_grad(set_to_none=True)
        dummy = torch.zeros((C + model.n_mesh_points, 2), device=device,
                            requires_grad=True)
        with record_function("dp_step.render"):
            if per_view_poses:
                sets = [_place_and_merge(
                    animate(model, state, _person(observed_inputs, i)),
                    dummy, placement, static_gaussians) for i in range(B)]
            else:
                sets = [_place_and_merge(
                    animate(model, state, observed_inputs), dummy,
                    placement, static_gaussians)] * B
            out = R.rasterize_projected_views(
                _views(sets, extrinsic, intrinsics, tanfov, H, W), H, W,
                **raster)
            if bg_net is not None:
                background = [mlp_background_image(bg_net, c2w[i],
                                                   intrinsics[i], H, W)
                              for i in range(B)]
            images = _composite(out, background, pgc)
        with record_function("dp_step.guidance"):
            sds = guidance(gparams, images, text_embeds, uncond_embeds, t,
                           **_guidance_kwargs(noise, cond_image,
                                              guidance_scale, generator,
                                              neg_embeds, progress, B))
        loss = lambda_guidance * sds["loss"]
        with record_function("dp_step.backward"):
            loss.backward()
        with record_function("dp_step.optimizer_stats"):
            bg_params = [] if bg_net is None else list(bg_net.parameters())
            all_reduce_mean(_grads(leaves) + _grads(bg_params)
                             + [dummy.grad])
            tstate.opt_state.step()
            if bg_net is not None:
                background_update(bg_net, bg_tx, bg_state)
            radii = all_reduce_max(out.radii.detach().amax(0))
            new_avatar = update_avatar_stats(state, dummy.grad[:C],
                                             radii[:C])
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "sds_loss": sds["loss"].detach(),
            "tile_overflow": out.overflow.mean()}
        all_reduce_mean(list(metrics.values()))
        new_tstate = AvatarTrainState(new_avatar, tstate.opt_state,
                                      tstate.step + 1)
        if bg_net is not None:
            return new_tstate, bg_state, metrics
        return new_tstate, metrics

    return step


def make_vanilla_sds_step_dp(
    model: VanillaAvatarModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 8,
    lambda_guidance: float = 1.0,
    per_view_poses: bool = False,
    neg_embeds: Optional[torch.Tensor] = None,
    pgc: Optional[Callable] = None,
    placement=None,
    static_gaussians=None,
    mesh: Optional[DataMesh] = None,
    device="cuda",
) -> Callable:
    """``make_avatar_sds_step_dp`` on the vanilla avatar: ``step(tstate,
    gparams, observed_inputs, extrinsic, intrinsics, tanfov, background,
    text_embeds, uncond_embeds, t, noise=None, cond_image=None,
    guidance_scale=None, generator=None, progress=None)`` -> (tstate',
    {"loss", "sds_loss", "tile_overflow"}): ``animate_vanilla`` (the DC
    colors, as the JAX DP step animates) once or once a view, the six Adam
    groups, ``update_stats``. No background net. Ranges as there."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian)
    mesh = mesh if mesh is not None else make_mesh(device=device)

    def step(tstate: VanillaTrainState, gparams: GuidanceParams,
             observed_inputs: SMPLXParams, extrinsic, intrinsics, tanfov,
             background, text_embeds, uncond_embeds, t,
             noise: Optional[torch.Tensor] = None, cond_image=None,
             guidance_scale=None, generator=None, progress=None) -> tuple:
        vstate = tstate.avatar
        _check_vanilla_device(vstate, device)
        C = vstate.capacity
        if per_view_poses:
            observed_inputs = shard_batch(observed_inputs, mesh)
        (extrinsic, intrinsics, tanfov, background, text_embeds,
         uncond_embeds, t, noise, cond_image, generator) = shard_batch(
            (extrinsic, intrinsics, tanfov, background, text_embeds,
             uncond_embeds, t, noise, cond_image, generator), mesh)
        B = extrinsic.shape[0]
        tstate.opt_state.zero_grad()
        dummy = torch.zeros((C, 2), device=device, requires_grad=True)
        with record_function("dp_step.render"):
            if per_view_poses:
                sets = [_place_and_merge(
                    animate_vanilla(model, vstate,
                                    _person(observed_inputs, i)),
                    dummy, placement, static_gaussians) for i in range(B)]
            else:
                sets = [_place_and_merge(
                    animate_vanilla(model, vstate, observed_inputs), dummy,
                    placement, static_gaussians)] * B
            out = R.rasterize_projected_views(
                _views(sets, extrinsic, intrinsics, tanfov, H, W), H, W,
                **raster)
            images = _composite(out, background, pgc)
        with record_function("dp_step.guidance"):
            sds = guidance(gparams, images, text_embeds, uncond_embeds, t,
                           **_guidance_kwargs(noise, cond_image,
                                              guidance_scale, generator,
                                              neg_embeds, progress, B))
        loss = lambda_guidance * sds["loss"]
        with record_function("dp_step.backward"):
            loss.backward()
        with record_function("dp_step.optimizer_stats"):
            all_reduce_mean(_grads(_adam_params(tstate.opt_state))
                             + [dummy.grad])
            tstate.opt_state.step()
            radii = all_reduce_max(out.radii.detach().amax(0))
            gstate = update_stats(vstate.gaussians, dummy.grad[:C],
                                  radii[:C])
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "sds_loss": sds["loss"].detach(),
            "tile_overflow": out.overflow.mean()}
        all_reduce_mean(list(metrics.values()))
        return VanillaTrainState(vstate._replace(gaussians=gstate),
                                 tstate.opt_state, tstate.step + 1), metrics

    return step


def make_nerf_sds_step_dp(
    model,
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
    mesh: Optional[DataMesh] = None,
    device="cuda",
) -> Callable:
    """The B-view stage-1 step: ``step(tstate, grid, gparams, cam_c2w (B, 4,
    4), cam_intr (B, 3, 3), bg_color (B, C), text_embeds (B, L, D),
    uncond_embeds (B, L, D), t (B,), jitter=None, noise=None,
    vs_draws=None, generator=None, cond_image=None, guidance_scale=None,
    sigma_pts=None, use_sigma=False, pdf_u=None, progress=None)`` ->
    (tstate', {"loss", "sds_loss", "sparsity_loss"[, "sigma_loss"]}).

    Each view renders with its own draws (handed in as (B, ...) or a list
    of B, else drawn from its generator in the single-view step's order:
    jitter, pdf_u, volume-sparsity draws; the SDS noise last) and its own
    compaction; its loss is ``lambda * sds + sparsity + volume
    sparsity``, and the step's loss the views' mean plus ``lambda_sigma``
    times the sigma loss, once. ``tp_lr_weights`` scale the updates by the
    mean weight of the views' timesteps. Ranges: ``nerf_step.*``, as the
    single-view step's, the guidance once for the B views."""
    device = resolve_device(device)
    H, W = image_height, image_width
    vs_weight = _vs_weight(nerf_cfg)
    upsample = getattr(nerf_cfg, "upsample_steps", 0)
    if tp_lr_weights is not None:
        tp_lr_weights = torch.as_tensor(tp_lr_weights, dtype=torch.float32,
                                        device=device)
    mesh = mesh if mesh is not None else make_mesh(device=device)

    def step(tstate: NeRFTrainState, grid: OccupancyGrid,
             gparams: GuidanceParams, cam_c2w, cam_intr, bg_color,
             text_embeds, uncond_embeds, t, jitter=None, noise=None,
             vs_draws=None, generator=None, cond_image=None,
             guidance_scale=None, sigma_pts=None, use_sigma: bool = False,
             pdf_u=None, progress=None):
        _check_field_device(model, device)
        t_all = torch.as_tensor(t, device=device).reshape(-1).long()
        (cam_c2w, cam_intr, bg_color, text_embeds, uncond_embeds, t, jitter,
         noise, vs_draws, generator, cond_image, pdf_u) = shard_batch(
            (cam_c2w, cam_intr, bg_color, text_embeds, uncond_embeds, t,
             jitter, noise, vs_draws, generator, cond_image, pdf_u), mesh)
        B = cam_c2w.shape[0]
        tstate.opt_state.zero_grad()
        images, regs, sparsity = [], [], []
        for i in range(B):
            gen = _view_generator(generator, i)
            jit = jitter[i] if jitter is not None else _draw(
                jitter_shape(H, W, ray_chunk, num_steps), gen, device,
                "jitter")
            pu = None
            if upsample > 0:
                pu = pdf_u[i] if pdf_u is not None else _draw(
                    (jit.shape[0], upsample), gen, device, "pdf_u")
            img, ren_depth, wsum = _render_image(
                model, grid, cam_c2w[i], cam_intr[i], H, W, jit, num_steps,
                bg_color[i], bg_mode=bg_mode, ray_chunk=ray_chunk,
                min_near=getattr(nerf_cfg, "min_near", 0.05),
                upsample_steps=upsample,
                compact_steps=getattr(nerf_cfg, "compact_steps", 0),
                detach_bg_ws=getattr(nerf_cfg, "detach_bg_weights_sum",
                                     False),
                pdf_u=pu)
            if pgc is not None and img.shape[-1] == 3:
                if getattr(pgc, "wants_mask", False):
                    img = pgc(img, wsum.detach()[..., None])
                else:
                    img = pgc(img)
            images.append(img)
            with record_function("nerf_step.regularizers"):
                sp = sparsity_loss(wsum.reshape(-1), nerf_cfg, tstate.step,
                                   max_iteration)
                reg = sp
                if vs_weight > 0.0:
                    rays_o, rays_d = get_rays(cam_c2w[i][None],
                                              cam_intr[i][None], H, W)
                    surf = rays_o[0] + rays_d[0] \
                        * ren_depth.detach().reshape(-1, 1)
                    vsd = vs_draws[i] if vs_draws is not None else \
                        volume_sparsity_draws(gen, model.bound,
                                              n_surface=surf.shape[0])
                    reg = reg + vs_weight * volume_sparsity_loss(
                        model, vsd, surface_points=surf,
                        surface_valid=wsum.detach().reshape(-1) > 0.5)
            regs.append(reg)
            sparsity.append(torch.as_tensor(sp, device=device).detach())
        with record_function("nerf_step.guidance"):
            sds = guidance(gparams, torch.stack(images), text_embeds,
                           uncond_embeds, t,
                           **_guidance_kwargs(noise, cond_image,
                                              guidance_scale, generator,
                                              neg_embeds, progress, B))
        loss = lambda_guidance * sds["loss"] + sum(regs) / B
        metrics = {"sparsity_loss": torch.stack(sparsity).mean()}
        if use_sigma and sigma_pts is not None:
            with record_function("nerf_step.regularizers"):
                sg = sigma_margin_loss(model, sigma_pts, peak=sigma_peak,
                                       loss_type=sigma_loss_type)
            # every rank adds it: the ranks' mean keeps its weight
            loss = loss + lambda_sigma * sg
            metrics["sigma_loss"] = sg.detach()
        with record_function("nerf_step.backward"):
            loss.backward()
        with record_function("nerf_step.optimizer"):
            all_reduce_mean(_grads(model.parameters()))
            scale = None
            if tp_lr_weights is not None:
                scale = tp_lr_weights[torch.clamp(
                    t_all, 0, tp_lr_weights.shape[0] - 1)].mean()
            tstate.opt_state.step(scale)
        metrics.update(loss=loss.detach(), sds_loss=sds["loss"].detach())
        all_reduce_mean(list(metrics.values()))
        return NeRFTrainState(model, tstate.opt_state, tstate.step + 1), \
            metrics

    return step

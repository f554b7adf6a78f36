"""Stage-2 avatar training step and the renders of a trained avatar.

Port of ``dreamwaltz_g_tpu/training/gs_trainer.py``:

* ``make_avatar_sds_step``: animate -> project (+ a zero ``dummy`` on the
  screen-space means, whose gradient is the densifier's signal) -> (T, K)
  tile bin -> differentiable tile blend -> composite -> VAE encode ->
  ControlNet + UNet CFG -> SDS gradient -> backward (through the blend's
  backward kernel) -> Adam -> densification stats;
* ``make_nerf2gs_step``: the NeRF -> 3DGS distillation, the same render
  and backward against a frozen field's render with an L1 + DSSIM loss;
* ``make_avatar_render`` / ``make_avatar_render_frames``: the eval renders,
  forward only, through the sorted tile blend.

* ``densify``: clone/split/prune of the unconstrained set with the
  optimizer-moment reset on the rewritten slots.

Not ported yet: the split and data/tensor-parallel steps, scene
placement and the static background Gaussians in the step and the
multi-device frame sharding.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..gaussian.densify import DensifyConfig, reset_opt_slots
from ..guidance.sds import GuidanceParams, ScoreDistillation
from ..human.smplx_model import SMPLXParams
from ..ops import rasterize as R
from ..system.avatar import (
    AvatarModel,
    AvatarState,
    GaussiansOut,
    animate,
    decode_opacities,
    densify_avatar,
    merge_gaussians,
    place_gaussians,
    update_avatar_stats,
)
from .losses import image_reconstruction_loss
from .optim import AvatarOptimizer, AvatarOptState, avatar_param_groups


def _person(observed_inputs: SMPLXParams, i: int) -> SMPLXParams:
    return SMPLXParams(*[x[i: i + 1] for x in observed_inputs])


def _check_device(state: AvatarState, device: torch.device) -> None:
    got = state.params.positions.device
    if got.type != device.type or device.index not in (None, got.index):
        raise ValueError(f"avatar state is on {got}, the render on {device}")


def _render_gaussians(gs: GaussiansOut, extrinsic, intrinsics, tanfov,
                      background, H: int, W: int, raster: dict):
    cov3d = R.covariance3d(gs.quats, gs.scales)
    g2d = R.project_gaussians(
        gs.positions, cov3d, gs.opacities, gs.colors, extrinsic, intrinsics,
        H, W, tanfov=tanfov, alive=gs.alive)
    out = R.rasterize_projected(g2d, H, W, **raster)
    image = out.image + (1.0 - out.alpha)[..., None] * background
    return image, out.alpha, out.depth


class AvatarTrainState(NamedTuple):
    avatar: AvatarState
    opt_state: AvatarOptState
    step: int


def _leaves(state: AvatarState, model: AvatarModel):
    return [t for ts in avatar_param_groups(state.params, model).values()
            for t in ts]


def init_avatar_train_state(state: AvatarState, tx: AvatarOptimizer,
                            model: AvatarModel) -> AvatarTrainState:
    """Make every avatar tensor a leaf that takes a gradient and build the
    optimizer over them and the model's networks (which hold their own
    weights here, so the model is an argument the JAX version lacks)."""
    for t in _leaves(state, model):
        t.requires_grad_(True)
    return AvatarTrainState(avatar=state,
                            opt_state=tx.init(state.params, model), step=0)


def _render_with_dummy(model: AvatarModel, state: AvatarState, params,
                       observed_inputs, dummy, extrinsic, intrinsics, tanfov,
                       background, H: int, W: int, raster: dict, pgc=None):
    """Animate + project (+ ``dummy`` on means2d) + rasterize + composite.
    ``pgc``: optional identity-forward hook on the composited 3-channel
    image that reshapes its gradient (pixel-gradient clipping). Returns
    (image (H, W, 3), RasterOutput)."""
    gs = animate(model, state._replace(params=params), observed_inputs)
    cov3d = R.covariance3d(gs.quats, gs.scales)
    g2d = R.project_gaussians(
        gs.positions, cov3d, gs.opacities, gs.colors, extrinsic, intrinsics,
        H, W, tanfov=tanfov, alive=gs.alive)
    g2d = g2d._replace(means2d=g2d.means2d + dummy)
    out = R.rasterize_projected(g2d, H, W, **raster)
    image = out.image + (1.0 - out.alpha)[..., None] * background
    if pgc is not None and image.shape[-1] == 3:
        image = pgc(image)
    return image, out


def make_avatar_sds_step(
    model: AvatarModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 16,
    lambda_guidance: float = 1.0,
    pgc: Optional[Callable] = None,
    device="cuda",
) -> Callable:
    """One avatar SDS step: ``step(tstate, gparams, observed_inputs,
    extrinsic, intrinsics, tanfov, background, text_embeds, uncond_embeds,
    t, noise=None, cond_image=None, guidance_scale=None, generator=None)``
    -> (tstate', {"loss", "sds_loss", "tile_overflow"}).

    One eager pass: render, encode with the graph kept, the guidance's
    latent gradient under no_grad (noise from ``noise=`` or
    ``generator``), ``loss = lambda * sum(latents * grad) / B`` in float32,
    backward, the optimizer step (``tstate.opt_state``, which carries the
    groups; the JAX version takes the optax transform as an argument), the
    stats. ``pgc`` is the pixel-gradient hook of
    ``guidance.sds.build_pixel_grad_hook`` (None: no hook), applied to the
    composited image. The optimizer updates the avatar's tensors in place,
    and each leaf keeps this step's ``.grad``. The stages run inside
    ``torch.profiler.record_function`` ranges (``sds_step.render``,
    ``.guidance``, ``.backward``, ``.optimizer_stats``), which a profiler
    reads and which cost nothing without one."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="train")

    def step(tstate: AvatarTrainState, gparams: GuidanceParams,
             observed_inputs: SMPLXParams, extrinsic, intrinsics, tanfov,
             background, text_embeds, uncond_embeds, t,
             noise: Optional[torch.Tensor] = None, cond_image=None,
             guidance_scale=None,
             generator: Optional[torch.Generator] = None,
             ) -> tuple:
        state = tstate.avatar
        _check_device(state, device)
        C = state.capacity
        for leaf in _leaves(state, model):
            leaf.grad = None
        dummy = torch.zeros((C + model.n_mesh_points, 2), device=device,
                            requires_grad=True)
        with record_function("sds_step.render"):
            image, out = _render_with_dummy(
                model, state, state.params, observed_inputs, dummy,
                extrinsic, intrinsics, tanfov, background, H, W, raster,
                pgc=pgc)
        with record_function("sds_step.guidance"):
            sds = guidance(gparams, image[None], text_embeds, uncond_embeds,
                           t, noise=noise, cond_image=cond_image,
                           guidance_scale=guidance_scale, generator=generator)
        loss = lambda_guidance * sds["loss"]
        with record_function("sds_step.backward"):
            loss.backward()
        with record_function("sds_step.optimizer_stats"):
            tstate.opt_state.step()
            new_avatar = update_avatar_stats(state, dummy.grad[:C],
                                             out.radii.detach()[:C])
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "sds_loss": sds["loss"].detach(),
            "tile_overflow": out.overflow}
        return AvatarTrainState(new_avatar, tstate.opt_state,
                                tstate.step + 1), metrics

    return step


def make_nerf2gs_step(
    model: AvatarModel,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 16,
    lambda_dssim: float = 0.2,
    device="cuda",
) -> Callable:
    """Distill a frozen NeRF's renders into the avatar: ``step(tstate,
    observed_inputs, extrinsic, intrinsics, tanfov, background,
    target_image, target_alpha)`` -> (tstate', {"loss"}).

    The render of ``make_avatar_sds_step`` (animate -> project + ``dummy``
    -> (T, K) bin -> the train blend's forward), the loss
    ``image_reconstruction_loss(image * m, target * m)`` with ``m`` the
    target's alpha (the field's foreground), backward (the blend's
    backward kernel), the optimizer step and the densification stats from
    the ``dummy``'s gradient and the radii. The target takes no gradient.
    Ranges: ``nerf2gs_step.render``, ``.loss``, ``.backward``,
    ``.optimizer_stats``."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="train")

    def step(tstate: AvatarTrainState, observed_inputs: SMPLXParams,
             extrinsic, intrinsics, tanfov, background, target_image,
             target_alpha) -> tuple:
        state = tstate.avatar
        _check_device(state, device)
        C = state.capacity
        for leaf in _leaves(state, model):
            leaf.grad = None
        dummy = torch.zeros((C + model.n_mesh_points, 2), device=device,
                            requires_grad=True)
        with record_function("nerf2gs_step.render"):
            image, out = _render_with_dummy(
                model, state, state.params, observed_inputs, dummy,
                extrinsic, intrinsics, tanfov, background, H, W, raster)
        with record_function("nerf2gs_step.loss"):
            m = target_alpha.detach()[..., None]
            loss = image_reconstruction_loss(
                image * m, target_image.detach() * m, lambda_dssim)
        with record_function("nerf2gs_step.backward"):
            loss.backward()
        with record_function("nerf2gs_step.optimizer_stats"):
            tstate.opt_state.step()
            new_avatar = update_avatar_stats(state, dummy.grad[:C],
                                             out.radii.detach()[:C])
        return AvatarTrainState(new_avatar, tstate.opt_state,
                                tstate.step + 1), {"loss": loss.detach()}

    return step


def densify(tstate: AvatarTrainState, cfg: DensifyConfig,
            generator: Optional[torch.Generator] = None,
            model: Optional[AvatarModel] = None,
            offsets=None) -> AvatarTrainState:
    """Clone/split/prune + the per-slot reset of the optimizer's moments.

    Pass ``model`` to enable the min-opacity prune on the MLP-decoded
    opacities. The avatar's tensors are rewritten in place (see
    ``densify_avatar``), so ``tstate.opt_state`` keeps its references; its
    moments are zeroed on the written slots, in place too. ``generator``
    (or ``offsets``) supplies the split's normal draws."""
    op = decode_opacities(model, tstate.avatar) if model is not None else None
    new_avatar, written = densify_avatar(tstate.avatar, cfg, generator,
                                         opacities=op, offsets=offsets)
    opt_state = reset_opt_slots(tstate.opt_state, written)
    return AvatarTrainState(new_avatar, opt_state, tstate.step)


def make_avatar_render(model: AvatarModel, image_height: int,
                       image_width: int, tile_size: int = 16,
                       capacity: int = 512, chunk: int = 64,
                       max_tiles_per_gaussian: int = 16,
                       extra_models: tuple = (), placement=None,
                       static_gaussians=None, device="cuda") -> Callable:
    """Eval/inference render.

    ``extra_models`` composes further avatars into the scene (pass their
    states as ``extra_states``); observed_inputs with batch B > 1 assigns
    person i to avatar i. ``placement``: optional (avatar_scale,
    avatar_transl), per-avatar indexed. The returned
    ``render(state, observed_inputs, extrinsic, intrinsics, tanfov,
    background, extra_states=())`` gives (image (H, W, 3), alpha (H, W),
    depth (H, W))."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="eval")

    def _place(gs, i):
        return gs if placement is None else place_gaussians(
            gs, *placement, index=i)

    @torch.no_grad()
    def render(state: AvatarState, observed_inputs: SMPLXParams,
               extrinsic, intrinsics, tanfov, background,
               extra_states: tuple = ()):
        _check_device(state, device)
        B = observed_inputs.body_pose.shape[0]
        gs = _place(animate(
            model, state,
            _person(observed_inputs, 0) if B > 1 else observed_inputs), 0)
        if extra_states:
            parts = [
                _place(animate(
                    m, s, _person(observed_inputs, min(i + 1, B - 1))
                    if B > 1 else observed_inputs), i + 1)
                for i, (m, s) in enumerate(zip(extra_models, extra_states))
            ]
            gs = merge_gaussians(gs, *parts)
        if static_gaussians is not None:
            gs = merge_gaussians(gs, static_gaussians)
        return _render_gaussians(gs, extrinsic, intrinsics, tanfov,
                                 background, H, W, raster)

    return render


def make_avatar_render_frames(model: AvatarModel, image_height: int,
                              image_width: int, tile_size: int = 16,
                              capacity: int = 512, chunk: int = 64,
                              max_tiles_per_gaussian: int = 16,
                              placement=None, device="cuda") -> Callable:
    """Frame-batched animation render: ``render_frames(state,
    observed_frames, extrinsic, intrinsics, tanfov, background)`` renders F
    frames, one after another.

    observed_frames: SMPLXParams stacked (F, 1, ...); extrinsic (F, 4, 4);
    intrinsics (F, 3, 3); tanfov (F,); background (H, W, 3) shared or
    (F, H, W, 3). Returns (F, H, W, 3) images + (F, H, W) alpha/depth."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="eval")

    @torch.no_grad()
    def render_frames(state: AvatarState, observed_frames: SMPLXParams,
                      extrinsic, intrinsics, tanfov, background):
        _check_device(state, device)
        F = extrinsic.shape[0]
        images, alphas, depths = [], [], []
        for f in range(F):
            obs = SMPLXParams(*[x[f] for x in observed_frames])
            if obs.body_pose.shape[0] > 1:
                # multi-person pose bundle: render person 0
                obs = _person(obs, 0)
            gs = animate(model, state, obs)
            if placement is not None:
                gs = place_gaussians(gs, *placement)
            bg = background[f] if background.ndim == 4 else background
            img, alpha, depth = _render_gaussians(
                gs, extrinsic[f], intrinsics[f], tanfov[f], bg, H, W, raster)
            images.append(img)
            alphas.append(alpha)
            depths.append(depth)
        return torch.stack(images), torch.stack(alphas), torch.stack(depths)

    return render_frames

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
* The vanilla avatar (``--render.gs_type vanilla``): ``VanillaTrainState``,
  ``make_vanilla_sds_step`` (animate_vanilla -> project + ``dummy`` ->
  (T, K) bin -> the train blend, B1 forward and backward -> guidance ->
  the six Adam groups -> ``gaussian.densify.update_stats``),
  ``densify_vanilla`` (children copy their parent's LBS weights),
  ``reset_vanilla_opacity`` and ``make_vanilla_render`` (the sorted blend,
  B2).

* ``make_avatar_sds_step_split``: the step as render -> encode, the
  latent gradient, then a re-render with that gradient injected and
  differentiated; with ``bg_net`` (the MLP background,
  ``--render.use_mlp_background``) the background's weights train with
  the avatar under their own Adan.

Every SDS step constructor takes ``neg_embeds`` (the negative prompt's
branch of the csd / nfsd families) and every SDS step ``progress`` (step
/ max_iteration: csd's annealed mix, ISM's delta warm-up), both handed to
the guidance. Every SDS step and render takes ``placement`` (the scene's
``(avatar_scale, avatar_transl)``) and ``static_gaussians`` (the frozen
Gaussian background, appended after the avatar, so the densification
statistics keep slicing ``[:C]``).

The B-view (multi-view) steps are ``parallel/dp.py``'s; the frames of
``make_avatar_render_frames(mesh=...)`` split over the data axis.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..gaussian.densify import (
    DensifyConfig,
    densify_step,
    reset_opacity,
    reset_opt_slots,
    update_stats,
)
from ..guidance.sds import GuidanceParams, ScoreDistillation
from ..human.smplx_model import SMPLXParams
from ..ops import rasterize as R
from ..system.background import BackgroundMLPNet, mlp_background_image
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
from ..system.vanilla import (
    VanillaAvatarModel,
    VanillaAvatarState,
    animate_vanilla,
)
from .losses import image_reconstruction_loss
from .optim import (
    Adan,
    AvatarOptimizer,
    AvatarOptState,
    GaussianOptimizer,
    avatar_param_groups,
)


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


def _place_and_merge(gs: GaussiansOut, dummy: torch.Tensor, placement,
                     static_gaussians):
    """The scene's placement, then the frozen background Gaussians after
    the avatar's, ``dummy`` padded with zeros to their count."""
    if placement is not None:
        gs = place_gaussians(gs, *placement)
    if static_gaussians is not None:
        gs = merge_gaussians(gs, static_gaussians)
        dummy = torch.cat([dummy, torch.zeros(
            (static_gaussians.positions.shape[0], 2), dtype=dummy.dtype,
            device=dummy.device)])
    return gs, dummy


def _render_with_dummy(model: AvatarModel, state: AvatarState, params,
                       observed_inputs, dummy, extrinsic, intrinsics, tanfov,
                       background, H: int, W: int, raster: dict, pgc=None,
                       placement=None, static_gaussians=None):
    """Animate (+ placement, + the static Gaussians) + project (+ ``dummy``
    on means2d) + rasterize + composite. ``pgc``: optional identity-forward
    hook on the composited 3-channel image that reshapes its gradient
    (pixel-gradient clipping). Returns (image (H, W, 3), RasterOutput)."""
    gs = animate(model, state._replace(params=params), observed_inputs)
    gs, dummy = _place_and_merge(gs, dummy, placement, static_gaussians)
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
    neg_embeds: Optional[torch.Tensor] = None,
    pgc: Optional[Callable] = None,
    placement=None,
    static_gaussians: Optional[GaussiansOut] = None,
    device="cuda",
) -> Callable:
    """One avatar SDS step: ``step(tstate, gparams, observed_inputs,
    extrinsic, intrinsics, tanfov, background, text_embeds, uncond_embeds,
    t, noise=None, cond_image=None, guidance_scale=None, generator=None,
    progress=None)`` -> (tstate', {"loss", "sds_loss", "tile_overflow"}).

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
             generator: Optional[torch.Generator] = None, progress=None,
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
                pgc=pgc, placement=placement,
                static_gaussians=static_gaussians)
        with record_function("sds_step.guidance"):
            sds = guidance(gparams, image[None], text_embeds, uncond_embeds,
                           t, noise=noise, cond_image=cond_image,
                           guidance_scale=guidance_scale, generator=generator,
                           neg_embeds=neg_embeds, progress=progress)
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
                              mesh=None, placement=None,
                              device="cuda") -> Callable:
    """Frame-batched animation render: ``render_frames(state,
    observed_frames, extrinsic, intrinsics, tanfov, background)`` renders F
    frames, one after another.

    observed_frames: SMPLXParams stacked (F, 1, ...); extrinsic (F, 4, 4);
    intrinsics (F, 3, 3); tanfov (F,); background (H, W, 3) shared or
    (F, H, W, 3). Returns (F, H, W, 3) images + (F, H, W) alpha/depth.

    With ``mesh`` (the data axis of ``parallel/mesh.py``, D ranks), each
    rank renders its contiguous F / D frames and the frames are gathered,
    so every rank returns all F (F must be a multiple of D; the trainer
    pads its last chunk)."""
    from ..parallel.mesh import gather_batch, shard_batch

    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="eval")

    @torch.no_grad()
    def render_frames(state: AvatarState, observed_frames: SMPLXParams,
                      extrinsic, intrinsics, tanfov, background):
        _check_device(state, device)
        if mesh is not None and mesh.world > 1:
            F = extrinsic.shape[0]
            if F % mesh.world:
                raise ValueError(f"frame batch {F} must be a multiple of "
                                 f"the mesh size {mesh.world}")
            if background.ndim == 3:
                background = background.expand(F, *background.shape)
            out = render_local(state, *shard_batch(
                (observed_frames, extrinsic, intrinsics, tanfov,
                 background), mesh))
            return tuple(gather_batch(x, mesh) for x in out)
        return render_local(state, observed_frames, extrinsic, intrinsics,
                            tanfov, background)

    def render_local(state, observed_frames, extrinsic, intrinsics, tanfov,
                     background):
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


class BackgroundTrainState(NamedTuple):
    """The MLP background's net (its weights take a gradient) and the state
    of its update rule."""

    net: BackgroundMLPNet
    opt_state: dict


def init_background_train_state(net: BackgroundMLPNet,
                                tx: Adan) -> BackgroundTrainState:
    params = list(net.parameters())
    for p in params:
        p.requires_grad_(True)
    return BackgroundTrainState(net=net, opt_state=tx.init(params))


def background_update(net: BackgroundMLPNet, tx: Adan,
                      bg_state: BackgroundTrainState) -> None:
    """One ``tx`` step of the background's weights on their ``.grad`` (None
    counts as 0), in place."""
    params = list(net.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    with torch.no_grad():
        for p, u in zip(params, tx.update(grads, bg_state.opt_state,
                                          params)):
            p.add_(u)


def make_avatar_sds_step_split(
    model: AvatarModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 8,
    lambda_guidance: float = 1.0,
    neg_embeds: Optional[torch.Tensor] = None,
    bg_net: Optional[BackgroundMLPNet] = None,
    bg_tx: Optional[Adan] = None,
    pgc: Optional[Callable] = None,
    placement=None,
    static_gaussians: Optional[GaussiansOut] = None,
    device="cuda",
) -> Callable:
    """The avatar SDS step in three parts: ``step(tstate, gparams,
    observed_inputs, extrinsic, intrinsics, tanfov, background,
    text_embeds, uncond_embeds, t, noise=None, cond_image=None,
    guidance_scale=None, generator=None, bg_state=None, c2w=None)`` ->
    (tstate', {"loss", "tile_overflow"}).

    (A) render -> VAE encode without a graph; (B) the frozen guidance's
    latent gradient; (C) render and encode again, ``loss = lambda *
    sum(latents * grad) / B`` in float32, backward, the optimizer step and
    the statistics. The result is the fused step's with the render and
    the encode run twice: the table blend (B1) twice forward and once
    backward, the VAE's attention (B4) twice forward.

    With ``bg_net`` / ``bg_tx`` the background is the net's image at the
    camera ``c2w`` (``background`` is not read); the net's weights take
    their gradient in (C) and ``bg_tx`` (the trainer's Adan) updates them
    in place. The step then takes ``bg_state`` (a
    ``BackgroundTrainState``) and ``c2w`` and returns (tstate',
    bg_state', metrics). The default ``max_tiles_per_gaussian`` is 8, the
    JAX step's. Ranges: ``split_step.render_encode``,
    ``.latent_gradients``, ``.render``, ``.backward``,
    ``.optimizer_stats``."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="train")

    def image_latents(gparams, state, observed_inputs, dummy, extrinsic,
                      intrinsics, tanfov, background, c2w, dt):
        if bg_net is not None:
            background = mlp_background_image(bg_net, c2w, intrinsics, H, W)
        image, out = _render_with_dummy(
            model, state, state.params, observed_inputs, dummy, extrinsic,
            intrinsics, tanfov, background, H, W, raster, pgc=pgc,
            placement=placement, static_gaussians=static_gaussians)
        return guidance.encode_images(gparams, image[None].to(dt)), out

    def step(tstate: AvatarTrainState, gparams: GuidanceParams,
             observed_inputs: SMPLXParams, extrinsic, intrinsics, tanfov,
             background, text_embeds, uncond_embeds, t,
             noise: Optional[torch.Tensor] = None, cond_image=None,
             guidance_scale=None,
             generator: Optional[torch.Generator] = None, progress=None,
             bg_state: Optional[BackgroundTrainState] = None,
             c2w: Optional[torch.Tensor] = None) -> tuple:
        if bg_net is not None and (bg_state is None or c2w is None):
            raise ValueError("the trainable-background step needs bg_state "
                             "and c2w")
        state = tstate.avatar
        _check_device(state, device)
        C = state.capacity
        view = (extrinsic, intrinsics, tanfov, background, c2w,
                text_embeds.dtype)
        dummy = torch.zeros((C + model.n_mesh_points, 2), device=device)
        with torch.no_grad(), record_function("split_step.render_encode"):
            latents, _ = image_latents(gparams, state, observed_inputs,
                                       dummy, *view)
        with record_function("split_step.latent_gradients"):
            glat = guidance.latent_gradients(
                gparams, latents, text_embeds, uncond_embeds, t,
                noise=noise, cond_image=cond_image,
                guidance_scale=guidance_scale, generator=generator,
                neg_embeds=neg_embeds, progress=progress)
        for leaf in _leaves(state, model):
            leaf.grad = None
        if bg_net is not None:
            bg_net.zero_grad(set_to_none=True)
        dummy.requires_grad_(True)
        with record_function("split_step.render"):
            latents, out = image_latents(gparams, state, observed_inputs,
                                         dummy, *view)
            loss = lambda_guidance * torch.sum(
                latents.float() * glat) / latents.shape[0]
        with record_function("split_step.backward"):
            loss.backward()
        with record_function("split_step.optimizer_stats"):
            tstate.opt_state.step()
            if bg_net is not None:
                background_update(bg_net, bg_tx, bg_state)
            new_avatar = update_avatar_stats(state, dummy.grad[:C],
                                             out.radii.detach()[:C])
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "tile_overflow": out.overflow}
        new_tstate = AvatarTrainState(new_avatar, tstate.opt_state,
                                      tstate.step + 1)
        if bg_net is not None:
            return new_tstate, bg_state, metrics
        return new_tstate, metrics

    return step


# ---------------------------------------------------------------------------
# The vanilla avatar
# ---------------------------------------------------------------------------

class VanillaTrainState(NamedTuple):
    avatar: VanillaAvatarState
    opt_state: AvatarOptState
    step: int


def init_vanilla_train_state(state: VanillaAvatarState,
                             tx: GaussianOptimizer) -> VanillaTrainState:
    """The six ``GaussianParams`` tensors become leaves that take a
    gradient, under one Adam over their groups; step 0. The LBS weights
    stay fixed."""
    for t in state.gaussians.params:
        t.requires_grad_(True)
    return VanillaTrainState(avatar=state,
                             opt_state=tx.init(state.gaussians.params),
                             step=0)


def _check_vanilla_device(state: VanillaAvatarState,
                          device: torch.device) -> None:
    got = state.gaussians.params.means.device
    if got.type != device.type or device.index not in (None, got.index):
        raise ValueError(f"avatar state is on {got}, the render on {device}")


def make_vanilla_sds_step(
    model: VanillaAvatarModel,
    guidance: ScoreDistillation,
    image_height: int,
    image_width: int,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 16,
    lambda_guidance: float = 1.0,
    neg_embeds: Optional[torch.Tensor] = None,
    pgc: Optional[Callable] = None,
    placement=None,
    static_gaussians: Optional[GaussiansOut] = None,
    device="cuda",
) -> Callable:
    """One SDS step on the vanilla avatar: ``step(tstate, gparams,
    observed_inputs, extrinsic, intrinsics, tanfov, background,
    text_embeds, uncond_embeds, t, campos=None, noise=None,
    cond_image=None, guidance_scale=None, generator=None)`` -> (tstate',
    {"loss", "sds_loss", "tile_overflow"}).

    ``animate_vanilla`` (SH colors toward ``campos``, the DC term without
    one, as the trainer calls it) -> project, with a zero ``dummy`` on the
    screen-space means -> (T, K) bin -> the train blend (B1) ->
    composite -> ``pgc`` -> guidance -> backward (B1's backward) -> the
    optimizer step on the ``GaussianParams`` leaves in place ->
    ``update_stats`` from the dummy's gradient and the radii. Ranges:
    ``vanilla_step.render``, ``.guidance``, ``.backward``,
    ``.optimizer_stats``."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="train")

    def step(tstate: VanillaTrainState, gparams: GuidanceParams,
             observed_inputs: SMPLXParams, extrinsic, intrinsics, tanfov,
             background, text_embeds, uncond_embeds, t, campos=None,
             noise: Optional[torch.Tensor] = None, cond_image=None,
             guidance_scale=None,
             generator: Optional[torch.Generator] = None,
             progress=None) -> tuple:
        vstate = tstate.avatar
        _check_vanilla_device(vstate, device)
        C = vstate.capacity
        tstate.opt_state.zero_grad()
        dummy = torch.zeros((C, 2), device=device, requires_grad=True)
        with record_function("vanilla_step.render"):
            gs = animate_vanilla(model, vstate, observed_inputs,
                                 campos=campos)
            gs, dm = _place_and_merge(gs, dummy, placement,
                                      static_gaussians)
            cov3d = R.covariance3d(gs.quats, gs.scales)
            g2d = R.project_gaussians(
                gs.positions, cov3d, gs.opacities, gs.colors, extrinsic,
                intrinsics, H, W, tanfov=tanfov, alive=gs.alive)
            g2d = g2d._replace(means2d=g2d.means2d + dm)
            out = R.rasterize_projected(g2d, H, W, **raster)
            image = out.image + (1.0 - out.alpha)[..., None] * background
            if pgc is not None and image.shape[-1] == 3:
                image = pgc(image)
        with record_function("vanilla_step.guidance"):
            sds = guidance(gparams, image[None], text_embeds, uncond_embeds,
                           t, noise=noise, cond_image=cond_image,
                           guidance_scale=guidance_scale, generator=generator,
                           neg_embeds=neg_embeds, progress=progress)
        loss = lambda_guidance * sds["loss"]
        with record_function("vanilla_step.backward"):
            loss.backward()
        with record_function("vanilla_step.optimizer_stats"):
            tstate.opt_state.step()
            gstate = update_stats(vstate.gaussians, dummy.grad[:C],
                                  out.radii.detach()[:C])
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "sds_loss": sds["loss"].detach(),
            "tile_overflow": out.overflow}
        return VanillaTrainState(vstate._replace(gaussians=gstate),
                                 tstate.opt_state, tstate.step + 1), metrics

    return step


def densify_vanilla(tstate: VanillaTrainState, cfg: DensifyConfig,
                    generator: Optional[torch.Generator] = None,
                    offsets=None) -> VanillaTrainState:
    """Clone / split / prune on the vanilla avatar's Gaussians (in place on
    the optimizer's leaves), the children copying their parent's LBS
    weights, then the moments zeroed on the written slots, in place."""
    vstate = tstate.avatar
    gstate, written, extras = densify_step(
        vstate.gaussians, cfg, generator,
        extra_attrs={"lbs": vstate.lbs_weights}, offsets=offsets)
    opt_state = reset_opt_slots(tstate.opt_state, written)
    return VanillaTrainState(
        vstate._replace(gaussians=gstate, lbs_weights=extras["lbs"]),
        opt_state, tstate.step)


def reset_vanilla_opacity(tstate: VanillaTrainState, value: float = 0.01
                          ) -> VanillaTrainState:
    """The periodic opacity reset (opacity is a parameter here), in place;
    the optimizer's moments are kept, as in the JAX package."""
    reset_opacity(tstate.avatar.gaussians, value)
    return tstate


def make_vanilla_render(model: VanillaAvatarModel, image_height: int,
                        image_width: int, tile_size: int = 16,
                        capacity: int = 512, chunk: int = 64,
                        max_tiles_per_gaussian: int = 16,
                        placement=None,
                        static_gaussians: Optional[GaussiansOut] = None,
                        device="cuda") -> Callable:
    """Eval render of the vanilla avatar, the call of
    ``make_avatar_render``'s: ``render(state, observed_inputs, extrinsic,
    intrinsics, tanfov, background)`` -> (image (H, W, 3), alpha (H, W),
    depth (H, W)), through the sorted blend (B2), the DC colors, placed
    and merged with the static Gaussians as the step is; ``extra_states``
    is taken and not read, as in the JAX package."""
    device = resolve_device(device)
    H, W = image_height, image_width
    raster = dict(tile_size=tile_size, capacity=capacity, chunk=chunk,
                  max_tiles_per_gaussian=max_tiles_per_gaussian, mode="eval")

    @torch.no_grad()
    def render(state: VanillaAvatarState, observed_inputs: SMPLXParams,
               extrinsic, intrinsics, tanfov, background,
               extra_states: tuple = ()):
        _check_vanilla_device(state, device)
        gs = animate_vanilla(model, state, observed_inputs)
        if placement is not None:
            gs = place_gaussians(gs, *placement)
        if static_gaussians is not None:
            gs = merge_gaussians(gs, static_gaussians)
        return _render_gaussians(gs, extrinsic, intrinsics, tanfov,
                                 background, H, W, raster)

    return render

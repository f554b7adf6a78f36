"""Eval/inference renders of a trained avatar.

Port of ``make_avatar_render`` and ``make_avatar_render_frames`` from
``dreamwaltz_g_tpu/training/gs_trainer.py``: animate -> project -> sorted
tile bin -> sorted tile blend -> composite over the background, forward
only. The SDS training step and the multi-device frame sharding are not
ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..human.smplx_model import SMPLXParams
from ..ops import rasterize as R
from ..system.avatar import (
    AvatarModel,
    AvatarState,
    GaussiansOut,
    animate,
    merge_gaussians,
    place_gaussians,
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
                  max_tiles_per_gaussian=max_tiles_per_gaussian)

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
                  max_tiles_per_gaussian=max_tiles_per_gaussian)

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

"""Scene: avatar(s) + background -> rendered images.

Port of ``dreamwaltz_g_tpu/system/scene.py``: ``render_gaussians``
rasterizes merged Gaussians for one camera and composites the background;
``Scene.forward`` animates the avatar and the extra avatars of a composed
scene, places each, merges them and renders.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..human.smplx_model import SMPLXParams
from ..ops import rasterize as R
from .avatar import (AvatarModel, AvatarState, GaussiansOut, animate,
                     merge_gaussians, place_gaussians)


class SceneRender(NamedTuple):
    image: torch.Tensor       # (H, W, 3) with background composited
    alpha: torch.Tensor       # (H, W)
    depth: torch.Tensor       # (H, W)
    radii: torch.Tensor       # (Ntot,) for densification stats
    foreground: torch.Tensor  # (H, W, 3) pre-composite


def render_gaussians(
    gaussians: GaussiansOut,
    cam,
    background: torch.Tensor,
    view_index: int = 0,
    tile_size: int = 16,
    capacity: int = 512,
    chunk: int = 64,
    max_tiles_per_gaussian: int = 16,
    mode: str = "train",
) -> SceneRender:
    """Project, bin and blend ``gaussians`` for view ``view_index`` of the
    ``CameraBatch`` ``cam`` and composite ``background`` ((H, W, 3) or
    (3,)). ``mode``: the blend, 'train' (the table blend, B1, with its
    backward) or 'eval' (the sorted blend, B2)."""
    H, W = cam.image_height, cam.image_width
    cov3d = R.covariance3d(gaussians.quats, gaussians.scales)
    g2d = R.project_gaussians(
        gaussians.positions, cov3d, gaussians.opacities, gaussians.colors,
        cam.extrinsic[view_index], cam.intrinsics[view_index], H, W,
        tanfov=cam.tanfov[view_index], alive=gaussians.alive)
    out = R.rasterize_projected(
        g2d, H, W, tile_size=tile_size, capacity=capacity, chunk=chunk,
        max_tiles_per_gaussian=max_tiles_per_gaussian, mode=mode)
    image = out.image + (1.0 - out.alpha)[..., None] * background
    return SceneRender(image=image, alpha=out.alpha, depth=out.depth,
                       radii=out.radii, foreground=out.image)


class Scene(NamedTuple):
    """One or more avatars and their placement.

    ``extra_models`` are the avatars of a composed scene
    (``--optim.ckpt_extra``); ``avatar_scale`` is a scalar or per-avatar
    (A,), ``avatar_transl`` (3,) or per-avatar (A, 3)."""

    model: AvatarModel
    extra_models: tuple = ()
    avatar_scale: Optional[torch.Tensor] = None
    avatar_transl: Optional[torch.Tensor] = None

    def forward(
        self,
        state: AvatarState,
        cam,
        background: torch.Tensor,
        observed_inputs: Optional[SMPLXParams] = None,
        extra_states: tuple = (),
        view_index: int = 0,
        **raster_kwargs,
    ) -> SceneRender:
        def place(gs, i):
            return place_gaussians(gs, self.avatar_scale,
                                   self.avatar_transl, index=i)

        gs = place(animate(self.model, state, observed_inputs), 0)
        if extra_states:
            extra = [
                place(animate(m, s, observed_inputs), i + 1)
                for i, (m, s) in enumerate(
                    zip(self.extra_models, extra_states))
            ]
            gs = merge_gaussians(gs, *extra)
        return render_gaussians(gs, cam, background, view_index,
                                **raster_kwargs)

"""The vanilla avatar (``--render.gs_type vanilla``): plain learnable 3D
Gaussians rigged by LBS.

Port of ``dreamwaltz_g_tpu/system/vanilla.py``: a ``GaussianState`` whose
means live in zero-pose space and are skinned into the observed pose by
per-point LBS weights (fixed from initialisation); colors come from the
Gaussians' own SH coefficients, not from a field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..gaussian.model import (
    GaussianState,
    dc_colors,
    init_state,
    opacities,
    rotations,
    scales,
    view_colors,
)
from ..human.glbs import glbs_transforms
from ..human.smplx_model import SMPLXModelData, SMPLXParams, smplx_forward
from ..ops.mesh import find_nearest_triangles
from .avatar import GaussiansOut, forward_lbs, initialize_lbs_weights, \
    inverse_lbs


class VanillaAvatarModel(NamedTuple):
    smpl: SMPLXModelData
    canonical_inputs: SMPLXParams
    sh_degree: int = 3
    max_scale: Optional[float] = None
    flip_rotation_axis: bool = True


class VanillaAvatarState(NamedTuple):
    gaussians: GaussianState
    lbs_weights: torch.Tensor  # (C, J)

    @property
    def capacity(self) -> int:
        return self.gaussians.capacity


@torch.no_grad()
def init_vanilla_avatar(
    model: VanillaAvatarModel,
    point_cloud: torch.Tensor,
    colors: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
    sh_levels: int = 4,
    init_scale: Union[float, torch.Tensor] = 0.001,
    init_opacity: float = 0.99,
    lbs_weight_smooth: bool = False,
    lbs_weight_smooth_K: int = 30,
    lbs_weight_smooth_N: int = 5000,
) -> VanillaAvatarState:
    """LBS weights from the nearest canonical triangle (optionally
    KNN-smoothed), the cloud taken into zero pose by inverse LBS, then the
    Gaussian buffers at ``capacity``. ``init_scale``: a scalar or (N, 3)
    linear scales per point."""
    smpl_out = smplx_forward(model.smpl, model.canonical_inputs)
    verts = smpl_out.vertices[0]
    faces = torch.as_tensor(model.smpl.faces, device=verts.device)
    nearest = find_nearest_triangles(point_cloud, verts, faces)
    lbs_w = initialize_lbs_weights(model.smpl, nearest, point_cloud,
                                   smooth=lbs_weight_smooth,
                                   smooth_K=lbs_weight_smooth_K,
                                   smooth_N=lbs_weight_smooth_N)
    canonical_tr = glbs_transforms(model.smpl, model.canonical_inputs)
    zero_pose = inverse_lbs(canonical_tr, point_cloud, lbs_w)
    N = point_cloud.shape[0]
    if torch.is_tensor(init_scale):
        scale = init_scale
    else:
        scale = torch.full((N, 3), float(init_scale),
                           device=point_cloud.device)
    gs = init_state(zero_pose, colors, capacity=capacity,
                    sh_levels=sh_levels, init_opacity=init_opacity,
                    init_scale=scale)
    C = gs.capacity
    if C > N:
        lbs_w = torch.cat([lbs_w, torch.zeros((C - N, lbs_w.shape[1]),
                                              device=lbs_w.device)])
    return VanillaAvatarState(gaussians=gs, lbs_weights=lbs_w)


def animate_vanilla(model: VanillaAvatarModel, state: VanillaAvatarState,
                    observed_inputs: Optional[SMPLXParams] = None,
                    campos: Optional[torch.Tensor] = None) -> GaussiansOut:
    """Forward LBS of the means and rotations into the observed pose
    (canonical when None); colors from the SH toward ``campos`` at
    ``sh_degree``, or the DC term alone without a camera."""
    if observed_inputs is None:
        observed_inputs = model.canonical_inputs
    observed_tr = glbs_transforms(model.smpl, observed_inputs)
    p = state.gaussians.params
    positions, quats = forward_lbs(
        observed_tr, p.means, state.lbs_weights, rotations(p),
        flip_rotation_axis=model.flip_rotation_axis)
    colors = view_colors(p, campos, model.sh_degree) \
        if campos is not None else dc_colors(p)
    return GaussiansOut(
        positions=positions, colors=colors, opacities=opacities(p),
        scales=scales(p, model.max_scale), quats=quats,
        alive=state.gaussians.alive,
        densify_mask=torch.ones(state.capacity, dtype=torch.bool,
                                device=positions.device))

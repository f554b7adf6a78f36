"""General Linear Blend Skinning (GLBS).

Port of ``dreamwaltz_g_tpu/human/glbs.py``: the SMPL-X LBS pipeline as named
RigidTransforms, so arbitrary 3D points (Gaussians) can be skinned by joint
weights:

* ``V_shape_offset`` / ``V_pose_offset`` -- per-vertex translations
* ``V_pose_rigid``   -- per-vertex SE(3) = W.A
* ``J_shape_offset`` -- per-joint translation (J_shaped - J_template)
* ``J_pose_rigid``   -- per-joint SE(3) = A
* ``G_transl_offset`` -- global translation

``skin_points_by_joint_weights`` skins arbitrary points by (N, J) joint
weights through ``J_pose_rigid``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..utils.transforms import RigidTransform, axis_angle_to_matrix
from .smplx_model import (
    SMPLXModelData,
    SMPLXParams,
    blend_shapes,
    full_pose_from_params,
    rigid_kinematics,
    vertices2joints,
)


class GLBSTransforms(NamedTuple):
    transform_J: RigidTransform
    transform_V: RigidTransform
    V_shape_offset: RigidTransform
    V_pose_offset: RigidTransform
    V_pose_rigid: RigidTransform
    J_shape_offset: RigidTransform
    J_pose_rigid: RigidTransform
    G_transl_offset: RigidTransform


def joint_template(model: SMPLXModelData) -> torch.Tensor:
    """(J, 3) rest joints of the unshaped template."""
    return model.J_regressor @ model.v_template


# the SMPL-X template arrays that ``overrides`` may replace with learnable
# copies
LEARNABLE_TEMPLATE_KEYS = (
    "v_template", "shapedirs", "posedirs", "expr_dirs",
    "lbs_weights", "J_regressor",
)


def glbs_transforms(
    model: SMPLXModelData,
    params: SMPLXParams,
    full_pose: Optional[torch.Tensor] = None,
    extra_betas: Optional[torch.Tensor] = None,
    overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> GLBSTransforms:
    """The named transform decomposition for one parameter batch; (J, ...)
    and (V, ...) transforms when B == 1. ``overrides`` swaps SMPL-X template
    arrays (a subset of ``LEARNABLE_TEMPLATE_KEYS``) for learnable
    copies."""
    ov = overrides or {}

    def arr(name):
        return ov.get(name, getattr(model, name))

    if full_pose is None:
        full_pose = full_pose_from_params(model, params)
    B = full_pose.shape[0]

    betas = params.betas
    if extra_betas is not None:
        betas = betas + extra_betas
    shape_components = torch.cat([betas, params.expression], dim=-1)
    dirs = torch.cat([arr("shapedirs"), arr("expr_dirs")], dim=-1)
    shape_offsets = blend_shapes(shape_components, dirs)          # (B, V, 3)
    v_shaped = arr("v_template")[None] + shape_offsets

    J_rest = vertices2joints(arr("J_regressor"), v_shaped)        # (B, J, 3)
    J_tmpl = arr("J_regressor") @ arr("v_template")

    rot_mats = axis_angle_to_matrix(full_pose.reshape(B, -1, 3))
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ arr("posedirs")).reshape(B, -1, 3)

    _, A = rigid_kinematics(rot_mats, J_rest, model.parents)       # (B, J, 4, 4)
    T = torch.einsum("vj,bjkl->bvkl", arr("lbs_weights"), A)       # (B, V, 4, 4)

    def _sq(x):
        return x[0] if B == 1 else x

    V_shape_offset = RigidTransform.from_trans(_sq(shape_offsets))
    V_pose_offset = RigidTransform.from_trans(_sq(pose_offsets))
    V_pose_rigid = RigidTransform.from_se3(_sq(T))
    J_shape_offset = RigidTransform.from_trans(_sq(J_rest - J_tmpl[None]))
    J_pose_rigid = RigidTransform.from_se3(_sq(A))
    G_transl_offset = RigidTransform.from_trans(_sq(params.transl))

    transform_V = V_shape_offset.compose(V_pose_offset, V_pose_rigid,
                                         G_transl_offset)
    transform_J = J_shape_offset.compose(J_pose_rigid, G_transl_offset)

    return GLBSTransforms(
        transform_J=transform_J,
        transform_V=transform_V,
        V_shape_offset=V_shape_offset,
        V_pose_offset=V_pose_offset,
        V_pose_rigid=V_pose_rigid,
        J_shape_offset=J_shape_offset,
        J_pose_rigid=J_pose_rigid,
        G_transl_offset=G_transl_offset,
    )


def skin_points_by_joint_weights(
    transforms: GLBSTransforms,
    points: torch.Tensor,
    joint_weights: torch.Tensor,
    transl: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Skin (N, 3) points with (N, J) joint weights: ``(W.A) p + transl``,
    the GLBS core (the per-point weighted ``J_pose_rigid``)."""
    out = transforms.J_pose_rigid.transform_points(points,
                                                   weights=joint_weights)
    if transl is not None:
        out = out + transl
    return out

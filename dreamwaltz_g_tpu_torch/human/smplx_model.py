"""SMPL-X body model as functions over tensors.

Port of ``dreamwaltz_g_tpu/human/smplx_model.py``. Layout (the
SMPLX_NEUTRAL_2020.npz conventions):

* ``v_template``  (V, 3)
* ``shapedirs``   (V, 3, n_betas), ``expr_dirs`` (V, 3, n_expr)
* ``posedirs``    (P, V*3) with P = 9*(J-1)
* ``J_regressor`` (J, V), ``lbs_weights`` (V, J)
* ``parents``     (J,) numpy kinematic tree, parents[0] = -1
* ``pose_mean``   (J*3,)

SMPL-X full pose order (55 joints x 3 axis-angle):
global_orient(1) | body(21) | jaw(1) | leye(1) | reye(1) | lhand(15) | rhand(15).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..utils.transforms import axis_angle_to_matrix

NUM_BODY_JOINTS = 21
NUM_HAND_JOINTS = 15
NUM_FACE_JOINTS = 3  # jaw, leye, reye


class SMPLXModelData(NamedTuple):
    """Static model arrays: tensors on one device, topology in numpy."""

    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    expr_dirs: torch.Tensor     # (V, 3, n_expr)
    posedirs: torch.Tensor      # (P, V*3)
    J_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: np.ndarray         # (J,)
    pose_mean: torch.Tensor     # (J*3,)
    faces: np.ndarray           # (F, 3)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return self.expr_dirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device


class SMPLXParams(NamedTuple):
    """Per-frame pose/shape parameters, batched over B."""

    betas: torch.Tensor            # (B, n_betas)
    expression: torch.Tensor       # (B, n_expr)
    global_orient: torch.Tensor    # (B, 3)
    body_pose: torch.Tensor        # (B, 21*3)
    jaw_pose: torch.Tensor         # (B, 3)
    leye_pose: torch.Tensor        # (B, 3)
    reye_pose: torch.Tensor        # (B, 3)
    left_hand_pose: torch.Tensor   # (B, 15*3)
    right_hand_pose: torch.Tensor  # (B, 15*3)
    transl: torch.Tensor           # (B, 3)


class SMPLXOutput(NamedTuple):
    vertices: torch.Tensor       # (B, V, 3)
    joints: torch.Tensor         # (B, J, 3) posed joint locations
    A: torch.Tensor              # (B, J, 4, 4) rest->posed joint transforms
    v_shaped: torch.Tensor       # (B, V, 3)
    shape_offsets: torch.Tensor  # (B, V, 3)
    pose_offsets: torch.Tensor   # (B, V, 3)
    full_pose: torch.Tensor      # (B, J*3)


def default_params(model: SMPLXModelData, batch_size: int = 1) -> SMPLXParams:
    def z(*s):
        return torch.zeros((batch_size,) + s, dtype=torch.float32,
                           device=model.device)

    return SMPLXParams(
        betas=z(model.num_betas),
        expression=z(model.num_expr),
        global_orient=z(3),
        body_pose=z(NUM_BODY_JOINTS * 3),
        jaw_pose=z(3),
        leye_pose=z(3),
        reye_pose=z(3),
        left_hand_pose=z(NUM_HAND_JOINTS * 3),
        right_hand_pose=z(NUM_HAND_JOINTS * 3),
        transl=z(3),
    )


def full_pose_from_params(model: SMPLXModelData, p: SMPLXParams) -> torch.Tensor:
    """The (B, J*3) axis-angle pose in SMPL-X joint order plus pose_mean.

    Non-55-joint models (synthetic test bodies) use the reduced layout
    global_orient | body_pose[:(J-1)*3]."""
    J = model.num_joints
    if J != 1 + NUM_BODY_JOINTS + NUM_FACE_JOINTS + 2 * NUM_HAND_JOINTS:
        B = p.global_orient.shape[0]
        body = p.body_pose[:, : (J - 1) * 3]
        body = torch.nn.functional.pad(body, (0, (J - 1) * 3 - body.shape[1]))
        return torch.cat([p.global_orient.reshape(B, 3), body], dim=-1) \
            + model.pose_mean
    full = torch.cat(
        [
            p.global_orient.reshape(-1, 3),
            p.body_pose.reshape(-1, NUM_BODY_JOINTS * 3),
            p.jaw_pose.reshape(-1, 3),
            p.leye_pose.reshape(-1, 3),
            p.reye_pose.reshape(-1, 3),
            p.left_hand_pose.reshape(-1, NUM_HAND_JOINTS * 3),
            p.right_hand_pose.reshape(-1, NUM_HAND_JOINTS * 3),
        ],
        dim=-1,
    )
    return full + model.pose_mean


def blend_shapes(shape_components: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3)."""
    return torch.einsum("bl,vcl->bvc", shape_components, dirs)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", J_regressor, vertices)


def rigid_kinematics(rot_mats: torch.Tensor, joints: torch.Tensor,
                     parents: np.ndarray):
    """Forward-kinematics chain (smplx's batch_rigid_transform semantics).

    Returns posed_joints (B, J, 3) and A (B, J, 4, 4), where A_j maps
    rest-space points skinned to joint j into posed space."""
    J = joints.shape[1]
    par = torch.as_tensor(np.asarray(parents[1:]), device=joints.device)
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]],
                           dim=1)

    rots = [None] * J
    trans = [None] * J
    rots[0] = rot_mats[:, 0]
    trans[0] = rel_joints[:, 0]
    for j in range(1, J):
        p = int(parents[j])
        rots[j] = rots[p] @ rot_mats[:, j]
        trans[j] = (rots[p] @ rel_joints[:, j, :, None])[..., 0] + trans[p]
    G_rot = torch.stack(rots, dim=1)   # (B, J, 3, 3)
    G_t = torch.stack(trans, dim=1)    # (B, J, 3)

    a_t = G_t - (G_rot @ joints[..., None])[..., 0]
    A = torch.zeros(G_rot.shape[:2] + (4, 4), dtype=G_rot.dtype,
                    device=G_rot.device)
    A[..., :3, :3] = G_rot
    A[..., :3, 3] = a_t
    A[..., 3, 3] = 1.0
    return G_t, A


def smplx_forward(
    model: SMPLXModelData,
    params: SMPLXParams,
    full_pose: Optional[torch.Tensor] = None,
) -> SMPLXOutput:
    """SMPL-X forward: shapes -> pose blendshapes -> kinematics -> LBS."""
    if full_pose is None:
        full_pose = full_pose_from_params(model, params)
    B = full_pose.shape[0]
    shape_components = torch.cat([params.betas, params.expression], dim=-1)
    dirs = torch.cat([model.shapedirs, model.expr_dirs], dim=-1)
    shape_offsets = blend_shapes(shape_components, dirs)
    v_shaped = model.v_template[None] + shape_offsets

    J_rest = vertices2joints(model.J_regressor, v_shaped)

    rot_mats = axis_angle_to_matrix(full_pose.reshape(B, -1, 3))
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, -1, 3)

    posed_joints, A = rigid_kinematics(rot_mats, J_rest, model.parents)

    # per-vertex skinning transform T = W . A
    T = torch.einsum("vj,bjkl->bvkl", model.lbs_weights, A)
    v_posed = v_shaped + pose_offsets
    vertices = (T[..., :3, :3] @ v_posed[..., None])[..., 0] + T[..., :3, 3]

    transl = params.transl[:, None, :]
    return SMPLXOutput(
        vertices=vertices + transl,
        joints=posed_joints + transl,
        A=A,
        v_shaped=v_shaped,
        shape_offsets=shape_offsets,
        pose_offsets=pose_offsets,
        full_pose=full_pose,
    )


def _model_data(device, v_template, shapedirs, expr_dirs, posedirs,
                J_regressor, lbs_weights, parents, pose_mean, faces
                ) -> SMPLXModelData:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SMPLXModelData(
        v_template=t(v_template), shapedirs=t(shapedirs),
        expr_dirs=t(expr_dirs), posedirs=t(posedirs),
        J_regressor=t(J_regressor), lbs_weights=t(lbs_weights),
        parents=np.asarray(parents), pose_mean=t(pose_mean),
        faces=np.asarray(faces))


def load_smplx_npz(
    path: str,
    num_betas: int = 300,
    num_expr: int = 100,
    flat_hand_mean: bool = False,
    kid_template_path: Optional[str] = None,
    device="cuda",
) -> SMPLXModelData:
    """Load a SMPLX_*.npz model file (300 betas / 100 expressions in the
    reference). ``kid_template_path`` appends the kid template's offset from
    the adult template as one extra shape direction."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=True) as data:
        v_template = np.asarray(data["v_template"], np.float32)
        shapedirs_full = np.asarray(data["shapedirs"], np.float32)
        shapedirs = shapedirs_full[..., :num_betas]
        expr_dirs = shapedirs_full[..., 300: 300 + num_expr]
        if kid_template_path is not None:
            kid = np.asarray(np.load(kid_template_path), np.float32)
            kid = kid - np.mean(kid, axis=0, keepdims=True)
            shapedirs = np.concatenate(
                [shapedirs, (kid - v_template)[..., None]], axis=-1)
        posedirs = np.asarray(data["posedirs"], np.float32)
        posedirs = posedirs.reshape(posedirs.shape[0] * 3, -1).T \
            if posedirs.ndim == 3 else posedirs
        if posedirs.shape[0] != 9 * (np.asarray(data["J_regressor"]).shape[0] - 1):
            pd = np.asarray(data["posedirs"], np.float32)
            posedirs = pd.reshape(-1, pd.shape[-1]).T
        J_regressor = np.asarray(data["J_regressor"], np.float32)
        lbs_weights = np.asarray(data["weights"], np.float32)
        parents = np.asarray(data["kintree_table"], np.int64)[0]
        parents[0] = -1
        faces = np.asarray(data["f"], np.int64)
        J = J_regressor.shape[0]
        pose_mean = np.zeros(J * 3, np.float32)
        if not flat_hand_mean and "hands_meanl" in data:
            lh = np.asarray(data["hands_meanl"], np.float32).reshape(-1)
            rh = np.asarray(data["hands_meanr"], np.float32).reshape(-1)
            pose_mean[-2 * NUM_HAND_JOINTS * 3: -NUM_HAND_JOINTS * 3] = lh
            pose_mean[-NUM_HAND_JOINTS * 3:] = rh
    return _model_data(device, v_template, shapedirs, expr_dirs, posedirs,
                       J_regressor, lbs_weights, parents, pose_mean, faces)


def make_synthetic_model(
    num_vertices: int = 128,
    num_joints: int = 8,
    num_betas: int = 4,
    num_expr: int = 2,
    seed: int = 0,
    device="cuda",
) -> SMPLXModelData:
    """A 'stick person' with SMPL-X-shaped arrays, for tests and runs where
    the licensed SMPL-X npz is absent. The numpy draws are the JAX package's,
    so both packages build the identical body from one seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    parents = np.arange(-1, num_joints - 1)
    joint_pos = np.stack(
        [np.zeros(num_joints), np.linspace(0, 1.4, num_joints), np.zeros(num_joints)],
        axis=-1,
    ).astype(np.float32)

    t = rng.uniform(0, 1.4, size=num_vertices)
    theta = rng.uniform(0, 2 * np.pi, size=num_vertices)
    r = 0.12 + 0.02 * rng.standard_normal(num_vertices)
    v_template = np.stack(
        [r * np.cos(theta), t, r * np.sin(theta)], axis=-1
    ).astype(np.float32)

    d = np.linalg.norm(v_template[:, None, :] - joint_pos[None], axis=-1)
    w = np.exp(-(d / 0.25) ** 2) + 1e-4
    lbs_weights = (w / w.sum(-1, keepdims=True)).astype(np.float32)

    jr = np.exp(-(d.T / 0.15) ** 2) + 1e-6
    J_regressor = (jr / jr.sum(-1, keepdims=True)).astype(np.float32)

    shapedirs = (0.01 * rng.standard_normal((num_vertices, 3, num_betas))).astype(np.float32)
    expr_dirs = (0.01 * rng.standard_normal((num_vertices, 3, num_expr))).astype(np.float32)
    posedirs = (0.001 * rng.standard_normal((9 * (num_joints - 1), num_vertices * 3))).astype(np.float32)

    faces = rng.integers(0, num_vertices, size=(2 * num_vertices, 3))

    return _model_data(device, v_template, shapedirs, expr_dirs, posedirs,
                       J_regressor, lbs_weights, parents,
                       np.zeros(num_joints * 3), faces)

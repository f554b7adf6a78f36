"""The DreamWaltz-G animatable avatar: hybrid 3D Gaussian representation.

Port of the render-path part of ``dreamwaltz_g_tpu/system/avatar.py``:

* *unconstrained* Gaussians live in zero-pose space, carry per-point LBS
  weights transferred from the nearest SMPL-X triangle, take colors and
  opacities from the field encoder + ``SigmaMLP`` at canonical-pose
  positions, and pose-conditioned offset/scale/quaternion deltas from a
  ``DeformNetwork``; they are forward-LBS'd into the observed pose;
* *mesh-binding* Gaussians for hands/face ride SMPL-X submesh triangles by
  barycentric coordinates, with flat scales from triangle frames.

``AvatarModel`` is the static definition; it owns the two networks as
``nn.Module``s, so their weights live there (the JAX package keeps them in
``AvatarParams.color_mlp`` / ``sq_net``). ``AvatarParams`` / ``AvatarState``
hold every other tensor under the JAX field names. ``animate`` is
differentiable with respect to every float tensor of ``AvatarParams`` and
the networks' weights. ``update_avatar_stats`` accumulates the densifier's
statistics and ``densify_avatar`` clones, splits and prunes the
unconstrained set in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..gaussian.densify import DensifyConfig, allocate_slots
from ..human.deform import DeformNetwork
from ..human.glbs import GLBSTransforms, glbs_transforms
from ..human.smplx_model import SMPLXModelData, SMPLXParams, smplx_forward
from ..nerf.encoder import encode_any, init_encoder_any
from ..nerf.network import SigmaMLP
from ..ops.mesh import (
    NearestTriangles,
    find_nearest_triangles,
    interpolate_vertex_attributes,
    knn,
)
from ..utils.timing import span
from ..utils.transforms import (
    matrix_to_quat,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    safe_normalize,
)

# barycentric patterns per triangle
_BARY_PATTERNS = {
    1: [[1 / 3, 1 / 3, 1 / 3]],
    3: [[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
    4: [[1 / 3, 1 / 3, 1 / 3], [2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
        [1 / 6, 1 / 6, 2 / 3]],
    6: [[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
        [1 / 6, 5 / 12, 5 / 12], [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6]],
}


class MeshBindingStatic(NamedTuple):
    vertex_indices: np.ndarray      # (Vp,) global vertex ids of the part
    triangle_indices: np.ndarray    # (Fp,) global triangle ids of the part
    triangles: np.ndarray           # (Fp, 3) local vertex ids
    points_to_triangles: np.ndarray  # (M,)
    points_to_vertices: np.ndarray  # (M, 3) local ids
    n_per_triangle: int


class MeshBindingParams(NamedTuple):
    bary_coords: torch.Tensor    # (Fp, G, 3) raw, normalized by sum on use
    vertex_coords: torch.Tensor  # (Vp, 3) template coords
    scales: torch.Tensor         # (M, 3) per-point multipliers, clamped [0.5, 2]


class AvatarParams(NamedTuple):
    positions: torch.Tensor     # (C, 3) zero-pose space
    log_scales: torch.Tensor    # (C, 3)
    quats: torch.Tensor         # (C, 4)
    lbs_weights: torch.Tensor   # (C, J)
    encoder: object             # field tables (TriplaneParams or
    #                             GridEncoderParams)
    mesh: Dict[str, MeshBindingParams]
    extra_betas: torch.Tensor   # (n_betas,)
    smpl_learn: Dict[str, torch.Tensor]  # learnable SMPL-X template copies


class AvatarState(NamedTuple):
    params: AvatarParams
    alive: torch.Tensor
    grad_accum: torch.Tensor
    grad_denom: torch.Tensor
    max_radii: torch.Tensor
    vertex_indices: Optional[torch.Tensor] = None  # (C,) nearest SMPL-X vertex

    @property
    def capacity(self) -> int:
        return self.params.positions.shape[0]


class GaussiansOut(NamedTuple):
    """Merged renderable Gaussians."""

    positions: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    alive: torch.Tensor
    densify_mask: torch.Tensor  # True only on unconstrained slots


@dataclass
class AvatarModel:
    """Static avatar definition, with the networks' weights."""

    smpl: SMPLXModelData
    canonical_inputs: SMPLXParams
    enc_cfg: object  # TriplaneConfig or GridEncoderConfig
    nerf_bound: float
    color_mlp: SigmaMLP
    sq_net: Union[DeformNetwork, SigmaMLP]  # SigmaMLP(out=7) in hash mode
    mesh_parts: Dict[str, MeshBindingStatic] = field(default_factory=dict)
    init_scale: float = 0.001
    max_scale: float = 0.01
    init_offset: float = 0.01
    use_non_rigid_offsets: bool = True
    use_non_rigid_scales: bool = True
    use_non_rigid_rotations: bool = False
    flip_rotation_axis: bool = True
    learn_hand_betas: bool = False
    learn_face_betas: bool = False
    # gs_type='hash': scales/quats from a pose-independent SigmaMLP over the
    # field encoding instead of per-point params + the deform net
    hash_mode: bool = False
    use_joint_shape_offsets: bool = False
    use_vertex_shape_offsets: bool = False
    use_vertex_pose_offsets: bool = False
    # 'add' or multiplicative; gates BOTH the scale and the quaternion
    # branch, as in the reference
    non_rigid_rotation_mode: str = "add"
    deform_with_shape: bool = False
    deform_rotation_mode: str = "quaternion"
    use_nerf_encoded_position: bool = True
    deform_learn: Tuple[str, ...] = ()
    use_zero_scales: bool = False
    use_constant_colors: Optional[Tuple[float, float, float]] = None
    use_constant_opacities: Optional[float] = None
    use_fixed_n_gaussians: Optional[int] = None
    render_only: str = "all"   # {'all', 'unconstrained', 'mesh'}

    def part_learns_betas(self, name: str) -> bool:
        return (name == "hands" and self.learn_hand_betas) or \
            (name == "face" and self.learn_face_betas)

    @property
    def learn_betas(self) -> bool:
        return self.learn_hand_betas or self.learn_face_betas

    @property
    def n_mesh_points(self) -> int:
        return sum(p.points_to_triangles.shape[0]
                   for p in self.mesh_parts.values())


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def make_mesh_binding_static(
    faces: np.ndarray,
    vertex_indices: np.ndarray,
    triangle_indices: np.ndarray,
    n_per_triangle: int = 6,
) -> MeshBindingStatic:
    vertex_indices = np.asarray(vertex_indices)
    triangle_indices = np.asarray(triangle_indices)
    remap = np.full(int(faces.max()) + 1, -1, np.int64)
    remap[vertex_indices] = np.arange(len(vertex_indices))
    local_tris = remap[faces[triangle_indices]]
    if not (local_tris >= 0).all():
        raise ValueError("triangle uses a vertex outside the part")
    Fp = len(triangle_indices)
    p2t = np.repeat(np.arange(Fp), n_per_triangle)
    return MeshBindingStatic(
        vertex_indices=vertex_indices,
        triangle_indices=triangle_indices,
        triangles=local_tris,
        points_to_triangles=p2t,
        points_to_vertices=local_tris[p2t],
        n_per_triangle=n_per_triangle,
    )


def init_mesh_binding_params(
    static: MeshBindingStatic, v_template: torch.Tensor,
) -> MeshBindingParams:
    dev = v_template.device
    Fp = static.triangles.shape[0]
    G = static.n_per_triangle
    pattern = torch.tensor(_BARY_PATTERNS[G], dtype=torch.float32, device=dev) \
        if G in _BARY_PATTERNS else torch.full((G, 3), 1 / 3, device=dev)
    return MeshBindingParams(
        bary_coords=pattern[None].expand(Fp, G, 3).clone(),
        vertex_coords=v_template[torch.as_tensor(static.vertex_indices,
                                                 device=dev)],
        scales=torch.ones((Fp * G, 3), device=dev),
    )


def knn_chunk(n_points: int, budget_floats: int = 2 ** 28,
              most: int = 4096) -> int:
    """Query rows a ``knn`` chunk over ``n_points`` points may take so that
    its (chunk, n_points, 3) difference tensor stays within
    ``budget_floats`` float32s (1 GiB): 4096 up to 21,845 points, 89 at a
    million. The neighbours do not depend on it."""
    return max(1, min(most, budget_floats // max(3 * n_points, 1)))


def initialize_lbs_weights(
    smpl: SMPLXModelData,
    nearest: NearestTriangles,
    positions: Optional[torch.Tensor] = None,
    smooth: bool = False,
    smooth_K: int = 30,
    smooth_N: int = 5000,
    use_sqrt: bool = True,
    valid_dist_threshold: float = 0.01,
) -> torch.Tensor:
    """Barycentric LBS-weight transfer from the nearest triangle, the
    optional KNN smoothing, then normalisation.

    The smoothing is ``smooth_N`` iterations of a distance-weighted average
    over each point's ``smooth_K`` nearest other ``positions`` (kernel
    ``1 / (mesh_dist[neighbour] * knn_dist)``), applied only to points
    farther than ``valid_dist_threshold`` from the mesh; the others keep
    their transferred weights."""
    faces = torch.as_tensor(smpl.faces, device=smpl.device)
    w = interpolate_vertex_attributes(nearest, faces, smpl.lbs_weights)
    if smooth:
        if positions is None:
            raise ValueError("smooth=True needs the points' positions")
        d2, idx = knn(positions, positions, smooth_K + 1,
                      chunk=knn_chunk(positions.shape[0]))
        idx, d2 = idx[:, 1:], d2[:, 1:]  # drop self
        mesh_d, knn_d = nearest.sq_dists, d2
        if use_sqrt:
            mesh_d, knn_d = torch.sqrt(mesh_d), torch.sqrt(knn_d)
        kw = 1.0 / torch.clamp(mesh_d[idx] * knn_d, min=1e-12)
        kw = kw / kw.sum(-1, keepdim=True)
        upd = (mesh_d > valid_dist_threshold).to(w.dtype)[:, None]
        with span("avatar.lbs_smooth", w.device):
            for _ in range(smooth_N):
                new = torch.einsum("nk,nkj->nj", kw, w[idx])
                w = (1.0 - upd) * w + upd * new
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def forward_lbs(
    transforms: GLBSTransforms,
    positions: torch.Tensor,
    weights: torch.Tensor,
    quats: Optional[torch.Tensor] = None,
    flip_rotation_axis: bool = True,
    rotation_mode: str = "quaternion",
    use_vertex_shape_offsets: bool = False,
    use_joint_shape_offsets: bool = False,
    use_vertex_pose_offsets: bool = False,
    vertex_indices: Optional[torch.Tensor] = None,
):
    """Skin points (and optionally orientation quats) by joint weights:
    (J_pose_rigid o G_transl).weight(w), after the optional shape and pose
    offset translations."""
    if use_vertex_shape_offsets:
        positions = transforms.V_shape_offset.transform_points(
            positions, indices=vertex_indices)
    elif use_joint_shape_offsets:
        positions = transforms.J_shape_offset.transform_points(
            positions, weights=weights)
    if use_vertex_pose_offsets:
        positions = transforms.V_pose_offset.transform_points(
            positions, indices=vertex_indices)
    t = transforms.J_pose_rigid.compose(transforms.G_transl_offset)
    per_point = t.weight(weights)
    out = per_point.transform_points(positions)
    if quats is None:
        return out
    q = per_point.transform_quaternions(
        quats, flip_rotation_axis=flip_rotation_axis,
        rotation_mode=rotation_mode)
    return out, q


def inverse_lbs(
    transforms: GLBSTransforms,
    positions: torch.Tensor,
    weights: torch.Tensor,
    use_vertex_shape_offsets: bool = False,
    use_joint_shape_offsets: bool = False,
    use_vertex_pose_offsets: bool = False,
    vertex_indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Posed -> zero-pose by solving the blended LBS matrix per point, then
    undoing the optional offset translations (pose first, then shape)."""
    t = transforms.J_pose_rigid.compose(transforms.G_transl_offset)
    blended = t.weight(weights)
    out = torch.linalg.solve(
        blended.rot, (positions - blended.trans)[..., None])[..., 0]
    if use_vertex_pose_offsets:
        out = transforms.V_pose_offset.inverse().transform_points(
            out, indices=vertex_indices)
    if use_vertex_shape_offsets:
        out = transforms.V_shape_offset.inverse().transform_points(
            out, indices=vertex_indices)
    elif use_joint_shape_offsets:
        out = transforms.J_shape_offset.inverse().transform_points(
            out, weights=weights)
    return out


def effective_offset_flags(model: AvatarModel) -> Tuple[bool, bool, bool]:
    """(vertex_shape, joint_shape, vertex_pose) offset-term flags; hash-mode
    skinning always carries the vertex pose offsets."""
    with_shape = model.hash_mode and model.deform_with_shape
    return (model.use_vertex_shape_offsets or with_shape,
            model.use_joint_shape_offsets,
            model.use_vertex_pose_offsets or model.hash_mode)


@torch.no_grad()
def init_avatar_state(
    model: AvatarModel,
    point_cloud: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    capacity: Optional[int] = None,
    prune_dists_close_to_mesh: Optional[float] = 0.01,
    lbs_weight_smooth: bool = False,
    init_scales: Optional[torch.Tensor] = None,  # (N, 3) linear per-point
    device="cuda",
    nerf_model=None,
    lbs_weight_smooth_K: int = 30,
    lbs_weight_smooth_N: int = 5000,
) -> AvatarState:
    """Build the avatar from a point cloud: canonical SMPL-X mesh,
    nearest-triangle attachment, prune-near-mesh (points close to a
    mesh-bound part lose their alive bit), LBS-weight transfer (with the
    KNN smoothing when ``lbs_weight_smooth``), inverse LBS into zero-pose
    space. Draws the field tables and (re)initialises the model's networks
    from ``generator`` (seed 0 on ``device`` by default).

    ``nerf_model`` (a stage-1 ``NeRFModel``, the JAX function's
    ``nerf_params``) continues the stage-1 field: its encoder's tables
    (the triplane's planes or the grid's tables) are copied verbatim into
    the avatar's encoder and its sigma / albedo head
    into ``model.color_mlp``; only the deform net is drawn."""
    device = resolve_device(device)
    if model.smpl.device != device:
        raise ValueError(f"model.smpl is on {model.smpl.device}, not {device}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    point_cloud = torch.as_tensor(point_cloud, dtype=torch.float32,
                                  device=device)
    smpl_out = smplx_forward(model.smpl, model.canonical_inputs)
    verts = smpl_out.vertices[0]
    faces = torch.as_tensor(model.smpl.faces, device=device)

    nearest = find_nearest_triangles(point_cloud, verts, faces)

    keep = torch.ones(point_cloud.shape[0], dtype=torch.bool, device=device)
    if prune_dists_close_to_mesh is not None:
        for part_name, part in model.mesh_parts.items():
            # hands get a 10x threshold
            thr = prune_dists_close_to_mesh * (10.0 if part_name == "hands" else 1.0)
            part_tri = torch.as_tensor(part.triangle_indices, device=device)
            close = torch.isin(nearest.triangle_indices, part_tri) \
                & (nearest.sq_dists < thr ** 2)
            keep = keep & ~close

    lbs_w = initialize_lbs_weights(
        model.smpl, nearest, point_cloud, smooth=lbs_weight_smooth,
        smooth_K=lbs_weight_smooth_K, smooth_N=lbs_weight_smooth_N)

    canonical_tr = glbs_transforms(model.smpl, model.canonical_inputs)
    vso, jso, vpo = effective_offset_flags(model)
    zero_pose_positions = inverse_lbs(
        canonical_tr, point_cloud, lbs_w,
        use_vertex_shape_offsets=vso,
        use_joint_shape_offsets=jso,
        use_vertex_pose_offsets=vpo,
        vertex_indices=nearest.vertex_indices)

    N = point_cloud.shape[0]
    C = capacity or N
    if C < N:
        raise ValueError(f"capacity {C} < {N} points")

    def pad(a, fill=0.0):
        if C == N:
            return a
        return torch.cat([a, torch.full((C - N,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=device)])

    nets = (model.color_mlp, model.sq_net)
    for net in nets:
        net.to(device)
    if nerf_model is not None:
        encoder = type(nerf_model.encoder)(
            nerf_model.encoder[0].detach().clone())
        model.color_mlp.load_state_dict(nerf_model.sigma_mlp.state_dict())
        nets = (model.sq_net,)
    else:
        encoder = init_encoder_any(model.enc_cfg, generator)
    for net in nets:
        net.reset_parameters(generator)

    mesh_params = {
        name: init_mesh_binding_params(st, model.smpl.v_template)
        for name, st in model.mesh_parts.items()
    }
    log_init = float(np.log(model.init_scale))
    if init_scales is not None:
        log_scales = pad(torch.log(torch.clamp(
            torch.as_tensor(init_scales, dtype=torch.float32, device=device),
            min=1e-7)), fill=log_init)
    else:
        log_scales = torch.full((C, 3), log_init, device=device)
    quats = torch.zeros((C, 4), device=device)
    quats[:, 0] = 1.0
    params = AvatarParams(
        positions=pad(zero_pose_positions),
        log_scales=log_scales,
        quats=quats,
        lbs_weights=pad(lbs_w),
        encoder=encoder,
        mesh=mesh_params,
        extra_betas=torch.zeros((model.smpl.num_betas,), device=device),
        smpl_learn={k: getattr(model.smpl, k).clone()
                    for k in model.deform_learn},
    )
    alive = pad(keep, fill=False)
    z = torch.zeros((C,), device=device)
    vidx = pad(nearest.vertex_indices, fill=0)
    return AvatarState(params=params, alive=alive, grad_accum=z,
                       grad_denom=z.clone(), max_radii=z.clone(),
                       vertex_indices=vidx)


# ---------------------------------------------------------------------------
# Forward / animate
# ---------------------------------------------------------------------------

def _vertex_normals(vertex_coords: torch.Tensor,
                    triangles: np.ndarray) -> torch.Tensor:
    """Area-weighted per-vertex normals of a part submesh."""
    tris = torch.as_tensor(triangles, device=vertex_coords.device)
    tri = vertex_coords[tris]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = torch.zeros_like(vertex_coords)
    for k in range(3):
        vn = vn.index_add(0, tris[:, k], fn)
    return safe_normalize(vn)


def _mesh_part_gaussians(
    model: AvatarModel,
    params: AvatarParams,
    name: str,
    canonical_tr: GLBSTransforms,
    observed_tr: GLBSTransforms,
) -> GaussiansOut:
    """Mesh-binding Gaussians for one part."""
    st = model.mesh_parts[name]
    mp = params.mesh[name]
    dev = mp.vertex_coords.device
    vid = torch.as_tensor(st.vertex_indices, device=dev)
    bary = mp.bary_coords / torch.clamp(
        mp.bary_coords.sum(-1, keepdim=True), min=1e-9)

    cnl_verts = canonical_tr.transform_V.index(vid).transform_points(mp.vertex_coords)
    obs_verts = observed_tr.transform_V.index(vid).transform_points(mp.vertex_coords)

    tris = torch.as_tensor(st.triangles, device=dev)
    cnl_pos = torch.einsum("fgk,fkc->fgc", bary, cnl_verts[tris]).reshape(-1, 3)
    obs_pos = torch.einsum("fgk,fkc->fgc", bary, obs_verts[tris]).reshape(-1, 3)

    # colors from the field at canonical positions; opacity fixed to 1
    enc = encode_any(params.encoder, model.enc_cfg, cnl_pos, model.nerf_bound)
    colors = torch.sigmoid(model.color_mlp(enc)[:, 1:])
    opacities = torch.ones(obs_pos.shape[0], device=dev)

    # triangle-frame scales/quaternions in the observed pose
    p2v = torch.as_tensor(st.points_to_vertices, device=dev)
    vn = _vertex_normals(obs_verts, st.triangles)
    point_bary = bary.reshape(-1, 3)
    normals = torch.einsum("nk,nkc->nc", point_bary, vn[p2v])
    v0 = safe_normalize(normals)
    ref = torch.tensor([1.0, 0.0, 0.0], device=dev).expand_as(v0)
    v1 = safe_normalize(torch.linalg.cross(v0, ref))
    v2 = safe_normalize(torch.linalg.cross(v0, v1))
    R = torch.stack([v0, v1, v2], dim=2)
    R = R * torch.tensor([1.0, -1.0, -1.0], device=dev)[None, :, None]
    quats = matrix_to_quat(R)

    p123 = obs_verts[p2v]  # (M, 3, 3)
    d = p123 - obs_pos[:, None, :]
    s1 = torch.sum(torch.abs(torch.einsum("nkc,nc->nk", d, v1)), -1) / st.n_per_triangle
    s2 = torch.sum(torch.abs(torch.einsum("nkc,nc->nk", d, v2)), -1) / st.n_per_triangle
    mult = torch.clamp(mp.scales, 0.5, 2.0)
    scales = torch.stack(
        [torch.full_like(s1, 1e-6), s1 * mult[:, 1], s2 * mult[:, 2]], dim=-1)

    M = obs_pos.shape[0]
    return GaussiansOut(
        positions=obs_pos, colors=colors, opacities=opacities,
        scales=scales, quats=quats,
        alive=torch.ones(M, dtype=torch.bool, device=dev),
        densify_mask=torch.zeros(M, dtype=torch.bool, device=dev),
    )


def animate(
    model: AvatarModel,
    state: AvatarState,
    observed_inputs: Optional[SMPLXParams] = None,
    unconstrained_only: bool = False,
) -> GaussiansOut:
    """Renderable Gaussians in the observed pose."""
    params = state.params
    if observed_inputs is None:
        observed_inputs = model.canonical_inputs

    ov = params.smpl_learn or None
    canonical_tr = glbs_transforms(model.smpl, model.canonical_inputs,
                                   overrides=ov)
    observed_tr = glbs_transforms(model.smpl, observed_inputs, overrides=ov)

    use_vso, use_jso, use_vpo = effective_offset_flags(model)
    if (use_vso or use_vpo) and state.vertex_indices is None:
        raise ValueError(
            "use_vertex_*_offsets / deform_with_shape need per-point "
            "nearest-vertex indices; rebuild the state via init_avatar_state")
    offset_kw = dict(
        use_vertex_shape_offsets=use_vso,
        use_joint_shape_offsets=use_jso,
        use_vertex_pose_offsets=use_vpo,
        vertex_indices=state.vertex_indices,
    )

    w = params.lbs_weights
    canonical_positions = forward_lbs(canonical_tr, params.positions, w,
                                      **offset_kw)

    enc = encode_any(params.encoder, model.enc_cfg, canonical_positions,
                     model.nerf_bound)
    oc = model.color_mlp(enc)
    opacities = torch.sigmoid(oc[:, 0])
    colors = torch.sigmoid(oc[:, 1:])

    positions = params.positions
    if model.hash_mode:
        sq = model.sq_net(enc)
        scales = torch.clamp(torch.exp(sq[:, :3]) * model.init_scale,
                             1e-7, model.max_scale)
        quats = quat_normalize(sq[:, 3:7])
    else:
        sq_in = enc if model.use_nerf_encoded_position \
            else params.positions.detach()
        offsets, dscales, dquats = model.sq_net(sq_in,
                                                observed_inputs.body_pose)
        add_mode = model.non_rigid_rotation_mode == "add"
        if model.use_non_rigid_offsets:
            positions = positions + offsets * model.init_offset
        base = torch.exp(params.log_scales)
        if model.use_non_rigid_scales:
            scales = base + dscales * model.init_scale if add_mode \
                else base * (1.0 + dscales * model.init_scale)
        else:
            scales = base
        scales = torch.clamp(scales, 1e-7, model.max_scale)
        if model.use_non_rigid_rotations:
            quats = quat_normalize(params.quats + dquats) if add_mode \
                else quat_multiply(quat_normalize(dquats),
                                   quat_normalize(params.quats))
        else:
            quats = quat_normalize(params.quats)

    positions, quats = forward_lbs(
        observed_tr, positions, w, quats,
        flip_rotation_axis=not model.hash_mode and model.flip_rotation_axis,
        rotation_mode=model.deform_rotation_mode,
        **offset_kw)

    unconstrained = GaussiansOut(
        positions=positions, colors=colors, opacities=opacities,
        scales=scales, quats=quats, alive=state.alive,
        densify_mask=torch.ones(state.capacity, dtype=torch.bool,
                                device=positions.device),
    )
    if unconstrained_only or not model.mesh_parts:
        return _apply_render_overrides(model, unconstrained)

    # parts with a learnable shape tweak skin through transforms recomputed
    # with extra_betas, canonical and observed alike
    if model.learn_betas:
        eb = params.extra_betas
        canonical_tr_b = glbs_transforms(
            model.smpl, model.canonical_inputs, extra_betas=eb, overrides=ov)
        observed_tr_b = glbs_transforms(
            model.smpl, observed_inputs, extra_betas=eb, overrides=ov)
    parts = [
        _mesh_part_gaussians(
            model, params, name,
            canonical_tr_b if model.part_learns_betas(name) else canonical_tr,
            observed_tr_b if model.part_learns_betas(name) else observed_tr)
        for name in model.mesh_parts
    ]
    return _apply_render_overrides(model, merge_gaussians(unconstrained,
                                                          *parts))


def _apply_render_overrides(model: AvatarModel, gs: GaussiansOut,
                            ) -> GaussiansOut:
    """Scene-level render overrides, as alive masks and value swaps."""
    if model.render_only == "unconstrained":
        gs = gs._replace(alive=gs.alive & gs.densify_mask)
    elif model.render_only == "mesh":
        gs = gs._replace(alive=gs.alive & ~gs.densify_mask)
    if model.use_zero_scales:
        gs = gs._replace(scales=gs.scales * 0.1)
    if model.use_constant_colors is not None:
        c = torch.as_tensor(model.use_constant_colors, dtype=gs.colors.dtype,
                            device=gs.colors.device)
        gs = gs._replace(colors=c.expand(gs.colors.shape[:-1] + (3,)))
    if model.use_constant_opacities is not None:
        gs = gs._replace(opacities=torch.full_like(
            gs.opacities, model.use_constant_opacities))
    if model.use_fixed_n_gaussians is not None:
        # keep the first n alive entries
        keep = torch.cumsum(gs.alive.to(torch.int32), 0) \
            <= model.use_fixed_n_gaussians
        gs = gs._replace(alive=gs.alive & keep)
    return gs


def merge_gaussians(*gs: GaussiansOut) -> GaussiansOut:
    return GaussiansOut(*[
        torch.cat([getattr(g, f) for g in gs], dim=0)
        for f in GaussiansOut._fields
    ])


def place_gaussians(gs: GaussiansOut, scale=None, transl=None,
                    index: int = 0) -> GaussiansOut:
    """Scene-level per-avatar placement applied after animate. ``scale`` is
    a scalar or per-avatar (A,); ``transl`` is (3,) or per-avatar (A, 3);
    ``index`` selects the avatar's entry."""
    dev = gs.positions.device
    if scale is not None:
        s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        s = s[index] if s.ndim == 1 else s
        gs = gs._replace(positions=gs.positions * s, scales=gs.scales * s)
    if transl is not None:
        t = torch.as_tensor(transl, dtype=torch.float32, device=dev)
        t = t[index] if t.ndim == 2 else t
        gs = gs._replace(positions=gs.positions + t[None])
    return gs


# ---------------------------------------------------------------------------
# Densification on the unconstrained set
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_avatar_stats(state: AvatarState, means2d_grad: torch.Tensor,
                        radii: torch.Tensor) -> AvatarState:
    """Accumulate densification stats from the first C (unconstrained)
    entries of the merged render: the screen-space gradient norm and a
    visibility count where the slot is alive and on screen, and the
    largest screen radius."""
    C = state.capacity
    vis = (radii[:C] > 0) & state.alive
    gnorm = torch.linalg.norm(means2d_grad[:C], dim=-1)
    zero = torch.zeros_like(gnorm)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(vis, gnorm, zero),
        grad_denom=state.grad_denom + vis.to(torch.float32),
        max_radii=torch.maximum(state.max_radii,
                                torch.where(vis, radii[:C], zero)),
    )


@torch.no_grad()
def decode_opacities(model: AvatarModel, state: AvatarState) -> torch.Tensor:
    """(C,) MLP-driven opacities at canonical-pose positions. The avatar has
    no opacity parameter (colors and opacities come from the field and its
    MLP), so the densifier's min-opacity prune evaluates the decoded
    opacity."""
    canonical_tr = glbs_transforms(model.smpl, model.canonical_inputs,
                                   overrides=state.params.smpl_learn or None)
    vso, jso, vpo = effective_offset_flags(model)
    pos = forward_lbs(
        canonical_tr, state.params.positions, state.params.lbs_weights,
        use_vertex_shape_offsets=vso,
        use_joint_shape_offsets=jso,
        use_vertex_pose_offsets=vpo,
        vertex_indices=state.vertex_indices)
    enc = encode_any(state.params.encoder, model.enc_cfg, pos,
                     model.nerf_bound)
    return torch.sigmoid(model.color_mlp(enc)[:, 0])


@torch.no_grad()
def densify_avatar(
    state: AvatarState,
    cfg: DensifyConfig,
    generator: Optional[torch.Generator] = None,
    opacities: Optional[torch.Tensor] = None,
    offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[AvatarState, torch.Tensor]:
    """Clone/split/prune the unconstrained Gaussians in zero-pose space.

    The per-point learnables are positions, log_scales, quats and
    lbs_weights (colors and opacities are MLP-driven). A clone duplicates
    the point into a free slot; a split samples two children inside the
    Gaussian's extent and shrinks their scales, child 1 in the parent's
    slot, child 2 in a free one. Returns (new_state, written): ``written``
    marks the slots whose parameters were rewritten or pruned, whose
    optimizer moments must be reset.

    The children are written **in place** (under ``no_grad``) into the
    tensors of ``state.params``: they are the leaves an optimizer holds, so
    it keeps its references; the returned state shares them and carries a
    new ``alive`` mask, zeroed statistics and the children's
    ``vertex_indices``.

    ``opacities``: pass ``decode_opacities(model, state)`` to enable the
    min-opacity prune. The two (C, 3) standard-normal draws of the split
    come from ``generator``, or are handed in as ``offsets=(n1, n2)`` (the
    JAX package draws them from the two halves of its key)."""
    p = state.params
    C = state.capacity
    dev = p.positions.device
    avg_grad = state.grad_accum / torch.clamp(state.grad_denom, min=1.0)
    s = torch.exp(p.log_scales)
    max_s = s.max(dim=-1).values
    none = torch.zeros(C, dtype=torch.bool, device=dev)

    limit = cfg.percent_dense * cfg.spatial_scale
    hot = state.alive & (avg_grad > cfg.grad_threshold) \
        & (state.grad_denom > 0)
    # grad-prune mode: clone/split are suspended and the high-gradient
    # points are pruned instead
    if cfg.grad_prune:
        clone_mask = split_mask = none
    else:
        clone_mask = hot & (max_s <= limit) if cfg.enable_clone else none
        split_mask = hot & (max_s > limit) if cfg.enable_split else none

    prune_mask = none
    if opacities is not None:
        prune_mask = prune_mask | (state.alive
                                   & (opacities < cfg.min_opacity))
    if cfg.max_screen_size is not None:
        prune_mask = prune_mask | (state.alive
                                   & (state.max_radii > cfg.max_screen_size))
    if cfg.max_world_size is not None:
        prune_mask = prune_mask | (state.alive
                                   & (max_s > cfg.max_world_size))
    if cfg.grad_prune:
        prune_mask = prune_mask | hot
    if not cfg.enable_prune:
        prune_mask = none
    # a split parent is consumed: its slot is overwritten by child 1
    prune_mask = prune_mask & ~split_mask

    alive_after = state.alive & ~prune_mask
    need = clone_mask | split_mask
    dest, granted = allocate_slots(need, alive_after)

    if offsets is None:
        if generator is None:
            raise ValueError("pass generator= or offsets=")
        n1, n2 = (torch.randn(s.shape, generator=generator, device=dev)
                  for _ in range(2))
    else:
        n1, n2 = (torch.as_tensor(n, dtype=torch.float32, device=dev)
                  for n in offsets)
    nq = quat_normalize(p.quats)
    off1 = quat_rotate(nq, n1 * s)
    off2 = quat_rotate(nq, n2 * s)
    split_logs = torch.log(torch.clamp(s / cfg.split_scale_shrink,
                                       min=1e-10))

    # every source value is taken before the first write; the free slots
    # that receive children and the split parents' own slots are disjoint
    src = torch.nonzero(granted)[:, 0]
    dst = dest[src].long()
    sp = split_mask & granted
    split_src = split_mask[src, None]
    child_pos = torch.where(split_src, (p.positions + off2)[src],
                            p.positions[src])
    child_logs = torch.where(split_src, split_logs[src], p.log_scales[src])
    first_pos = (p.positions + off1)[sp]
    child_quats, child_lbs = p.quats[src], p.lbs_weights[src]

    p.positions[dst] = child_pos
    p.log_scales[dst] = child_logs
    p.quats[dst] = child_quats
    p.lbs_weights[dst] = child_lbs
    p.positions[sp] = first_pos
    p.log_scales[sp] = split_logs[sp]

    alive_new = alive_after.clone()
    alive_new[dst] = True
    written = torch.zeros(C, dtype=torch.bool, device=dev)
    written[dst] = True
    written = written | sp | prune_mask

    vidx = state.vertex_indices
    if vidx is not None:
        # children inherit the parent's nearest-vertex attachment
        vidx = vidx.clone()
        vidx[dst] = state.vertex_indices[src]

    z = torch.zeros((C,), dtype=torch.float32, device=dev)
    return AvatarState(params=p, alive=alive_new, grad_accum=z,
                       grad_denom=z.clone(), max_radii=z.clone(),
                       vertex_indices=vidx), written

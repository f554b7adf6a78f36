"""Synthetic avatar fixtures for tests and chip runs.

Port of ``tiny_avatar_setup`` from ``dreamwaltz_g_tpu/tests_support.py``
(without the guidance builders). It takes sizes, so the same builder makes
the few-vertex test avatar and the full-width one that ``chip_smoke.py``
renders. The body and the point cloud come from numpy draws identical to
the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ._device import resolve_device
from .human.deform import DeformNetwork
from .human.smplx_model import SMPLXParams, default_params, make_synthetic_model
from .nerf.encoder import TriplaneConfig
from .nerf.network import SigmaMLP
from .system import avatar as A


class TinyAvatarSetup(NamedTuple):
    model: A.AvatarModel
    state: A.AvatarState
    cloud: torch.Tensor
    observed: SMPLXParams


def tiny_avatar_setup(capacity: int = 128, n_points: int = 64,
                      num_vertices: int = 120, num_joints: int = 6,
                      num_betas: int = 3, num_expr: int = 2,
                      seed: int = 0, mesh_part: Optional[str] = "face",
                      part_triangles: int = 10, n_per_triangle: int = 3,
                      enc_cfg: Optional[TriplaneConfig] = None,
                      mlp_hidden: int = 32, mlp_layers: int = 2,
                      deform_depth: int = 2, deform_width: int = 32,
                      prune_dists_close_to_mesh: Optional[float] = None,
                      device="cuda") -> TinyAvatarSetup:
    """An articulated avatar around the synthetic stick body.

    ``mesh_part`` names one part bound to the ``part_triangles`` highest
    triangles at ``n_per_triangle`` Gaussians each (None: no part). The
    defaults are the JAX fixture's sizes; its default hash-grid field is
    not ported, so the field here is a triplane (16^2 x 8 by default)."""
    device = resolve_device(device)
    smpl = make_synthetic_model(num_vertices=num_vertices,
                                num_joints=num_joints, num_betas=num_betas,
                                num_expr=num_expr, seed=seed, device=device)
    canonical = default_params(smpl, 1)
    if enc_cfg is None:
        enc_cfg = TriplaneConfig(resolution=16, feature_dim=8)

    mesh_parts = {}
    if mesh_part is not None:
        faces = smpl.faces
        v = smpl.v_template.cpu().numpy()
        top = np.argsort(-v[faces].mean(1)[:, 1])[:part_triangles]
        part_vids = np.unique(faces[top].reshape(-1))
        mesh_parts[mesh_part] = A.make_mesh_binding_static(
            faces, part_vids, top, n_per_triangle=n_per_triangle)

    model = A.AvatarModel(
        smpl=smpl,
        canonical_inputs=canonical,
        enc_cfg=enc_cfg,
        nerf_bound=2.0,
        color_mlp=SigmaMLP(enc_cfg.output_dim, hidden=mlp_hidden,
                           num_layers=mlp_layers, out_channels=4,
                           device=device),
        sq_net=DeformNetwork(xyz_input_ch=enc_cfg.output_dim,
                             depth=deform_depth, width=deform_width,
                             device=device),
        mesh_parts=mesh_parts,
    )
    rng = np.random.default_rng(seed)
    cloud = torch.as_tensor(rng.normal(size=(n_points, 3)) * 0.15
                            + np.asarray([0, 0.7, 0]), dtype=torch.float32,
                            device=device)
    state = A.init_avatar_state(
        model, cloud, torch.Generator(device=device).manual_seed(seed),
        capacity=capacity,
        prune_dists_close_to_mesh=prune_dists_close_to_mesh, device=device)
    return TinyAvatarSetup(model=model, state=state, cloud=cloud,
                           observed=default_params(smpl, 1))

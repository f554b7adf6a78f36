"""Convert reference DreamWaltz-G torch checkpoints into the port's states,
so avatars trained with the reference can be animated and served here.

Port of ``dreamwaltz_g_tpu/convert_reference.py``; the results are the
port's own objects (a ``NeRFModel``, an ``AvatarState`` with the weights in
the model's modules, a ``GaussianState``), not JAX trees.

Reference checkpoint layout: ``{'train_step', 'checkpoints', 'model':
scene state_dict}``; scene keys are ``avatar.<param>`` /
``background.<param>``:

* ``avatar._positions / _scales / _quaternions / _lbs_weights``;
* ``avatar.nerf_encoder.embeddings``: flat (sum_T, F) hash tables, read
  through ``nerf.encoder.tables_from_flat``;
* ``avatar.nerf_opacity_and_color_net.net.{i}.weight/bias``: the sigma MLP;
* ``avatar.deform_model.layers.{i}.weight/bias`` and the heads
  ``gaussian_warp / gaussian_rotation / gaussian_scaling``;
* ``avatar.mesh_binding_gaussians.<part>._bary_coords/_vertex_coords/_scales``;
* ``avatar._betas``: the learnable extra betas.

Stage-1 NeRF checkpoints (``model`` = the field's state dict):
``encoder.embeddings``, ``sigma_net.net.{i}.*``, ``bg_net.net.{i}.*``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ._device import resolve_device
from .convert import load_flax_dense_params
from .nerf.encoder import tables_from_flat


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a reference .pth and return the flat model state dict as
    numpy. The file is read with ``weights_only=True`` (tensors, numbers,
    strings and containers of them: the reference's layout needs no
    more)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in sd.items()}


def _strip(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _dense(sd, name: str, out_features: int) -> dict:
    """torch Linear ``name.weight`` (out, in) / ``name.bias`` as a Flax
    Dense leaf (kernel (in, out)); a missing bias is zero."""
    w = np.asarray(sd[f"{name}.weight"], np.float32)
    b = sd.get(f"{name}.bias")
    return {"kernel": w.T, "bias": np.zeros(out_features, np.float32)
            if b is None else np.asarray(b, np.float32)}


def _mlp_params(sd: Dict[str, np.ndarray], prefix: str,
                num_layers: int) -> dict:
    """torch MLP (``net.{i}.weight/bias``) -> {'params': {dense_i: ...}}."""
    return {"params": {
        f"dense_{i}": _dense(sd, f"{prefix}net.{i}",
                             sd[f"{prefix}net.{i}.weight"].shape[0])
        for i in range(num_layers)}}


def _deform_params(sd: Dict[str, np.ndarray], depth: int) -> dict:
    """torch DeformNetwork (``layers.{i}`` and three heads) -> the port's
    ``DeformNetwork`` names."""
    out = {f"dense_{i}": _dense(sd, f"layers.{i}",
                                sd[f"layers.{i}.weight"].shape[0])
           for i in range(depth) if f"layers.{i}.weight" in sd}
    for ours, theirs, dim in (("head_offset", "gaussian_warp", 3),
                              ("head_quat", "gaussian_rotation", 4),
                              ("head_scale", "gaussian_scaling", 3)):
        out[ours] = _dense(sd, theirs, dim)
    return {"params": out}


@torch.no_grad()
def convert_nerf_checkpoint(sd: Dict[str, np.ndarray], cfg,
                            with_background: bool = True,
                            device="cuda"):
    """Stage-1 NeRF state dict -> the port's ``NeRFModel`` for ``cfg`` (a
    ``NeRFConfig`` whose backbone is a grid). The background MLP is built
    only when ``with_background`` and the dict holds one."""
    from .nerf.network import NeRFModel

    device = resolve_device(device)
    model = NeRFModel(cfg, with_background=with_background
                      and "bg_net.net.0.weight" in sd, device=device)
    enc = tables_from_flat(model.enc_cfg, sd["encoder.embeddings"], device)
    model.tables.copy_(enc.tables)
    load_flax_dense_params(model.sigma_mlp, _mlp_params(
        sd, "sigma_net.", model.sigma_mlp.num_layers))
    if model.bg_mlp is not None:
        load_flax_dense_params(model.bg_mlp, _mlp_params(
            sd, "bg_net.", model.bg_mlp.num_layers))
    return model


@torch.no_grad()
def convert_avatar_checkpoint(sd: Dict[str, np.ndarray], model,
                              capacity: Optional[int] = None,
                              device="cuda"):
    """Scene / avatar state dict -> the port's ``AvatarState`` sized to
    ``capacity`` (default: the checkpoint's live count + 25% for
    densification headroom), with the sigma MLP and the deform net loaded
    into ``model.color_mlp`` / ``model.sq_net`` (``model`` an
    ``AvatarModel`` on a grid field). Without deform weights the net is
    drawn from a generator seeded 0, as the JAX function draws from
    ``PRNGKey(0)`` (other values)."""
    from .system.avatar import (
        AvatarParams,
        AvatarState,
        MeshBindingParams,
        init_mesh_binding_params,
    )

    device = resolve_device(device)
    av = _strip(sd, "avatar.")
    pos = np.asarray(av["_positions"], np.float32)
    N = pos.shape[0]
    C = capacity or int(N * 1.25)
    if C < N:
        raise ValueError(f"capacity {C} < {N} points")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def pad(a, fill=0.0):
        a = np.asarray(a, np.float32)
        return t(np.concatenate(
            [a, np.full((C - N,) + a.shape[1:], fill, np.float32)]))

    encoder = tables_from_flat(model.enc_cfg, av["nerf_encoder.embeddings"],
                               device=device)
    for net in (model.color_mlp, model.sq_net):
        net.to(device)
    load_flax_dense_params(model.color_mlp, _mlp_params(
        av, "nerf_opacity_and_color_net.", model.color_mlp.num_layers))
    deform = _strip(av, "deform_model.")
    if deform:
        load_flax_dense_params(model.sq_net,
                               _deform_params(deform, model.sq_net.depth))
    else:
        model.sq_net.reset_parameters(
            torch.Generator(device=device).manual_seed(0))

    v_template = model.smpl.v_template.to(device)
    mesh = {}
    for name, static in model.mesh_parts.items():
        part = _strip(av, f"mesh_binding_gaussians.{name}.")
        if "_bary_coords" in part:
            mesh[name] = MeshBindingParams(
                bary_coords=t(part["_bary_coords"]),
                vertex_coords=t(part["_vertex_coords"])
                if "_vertex_coords" in part else v_template[torch.as_tensor(
                    static.vertex_indices, device=device)],
                scales=t(part["_scales"]) if "_scales" in part
                else torch.ones((static.points_to_triangles.shape[0], 3),
                                device=device))
        else:
            mesh[name] = init_mesh_binding_params(static, v_template)

    n_betas = model.smpl.num_betas
    extra_betas = torch.zeros((n_betas,), device=device)
    if "_betas" in av:
        b = np.asarray(av["_betas"], np.float32).reshape(-1)[:n_betas]
        extra_betas = t(np.pad(b, (0, n_betas - b.shape[0])))

    quats = av.get("_quaternions")
    if quats is None:
        quats = np.zeros((N, 4), np.float32)
        quats[:, 0] = 1.0
    params = AvatarParams(
        positions=pad(pos),
        log_scales=pad(av["_scales"], fill=-10.0),
        quats=pad(quats),
        lbs_weights=pad(av["_lbs_weights"]),
        encoder=encoder,
        mesh=mesh,
        extra_betas=extra_betas,
        smpl_learn={},
    )
    z = torch.zeros((C,), device=device)
    return AvatarState(params=params,
                       alive=torch.arange(C, device=device) < N,
                       grad_accum=z, grad_denom=z.clone(),
                       max_radii=z.clone())


def convert_gaussian_checkpoint(sd: Dict[str, np.ndarray],
                                capacity: Optional[int] = None,
                                device="cuda"):
    """Plain 3DGS ``GaussianModel`` state dict -> the port's
    ``GaussianState`` (the vanilla avatar's or a background's)."""
    from .gaussian.model import GaussianParams, GaussianState

    device = resolve_device(device)
    pos = np.asarray(sd["_positions"], np.float32)
    N = pos.shape[0]
    C = capacity or N

    def pad(a, fill=0.0):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(np.concatenate(
            [a, np.full((C - N,) + a.shape[1:], fill, np.float32)]),
            device=device)

    dc = np.asarray(sd["_sh_features_dc"], np.float32).reshape(N, 1, 3)
    rest = np.asarray(sd["_sh_features_rest"], np.float32).reshape(N, -1, 3)
    params = GaussianParams(
        means=pad(pos),
        sh_dc=pad(dc),
        sh_rest=pad(rest),
        opacity_logit=pad(np.asarray(sd["_opacities"]).reshape(N, 1),
                          fill=-10.0),
        log_scales=pad(sd["_scales"], fill=-10.0),
        quats=pad(sd["_quaternions"]),
    )
    z = torch.zeros((C,), device=device)
    return GaussianState(params=params,
                         alive=torch.arange(C, device=device) < N,
                         grad_accum=z, grad_denom=z.clone(),
                         max_radii=z.clone())

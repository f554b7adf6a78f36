"""Carry a JAX-package avatar into the port.

``avatar_state_from_numpy(tree, model)`` takes the JAX ``AvatarState`` as a
tree of numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray, state)``),
loads the two networks' Flax weights into ``model.color_mlp`` and
``model.sq_net`` and returns the port's ``AvatarState``.

* Flax ``Dense`` kernels are (in, out): they land transposed in
  ``nn.Linear.weight``. Layer names (``dense_i``, ``head_offset``,
  ``head_scale``, ``head_quat``, ``branch_w``, ``branch_v``) map one to one.
* Triplane planes (3, R, R, F) keep their layout.
* ``MeshBindingParams`` and the per-slot arrays copy across.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .nerf.encoder import TriplaneParams
from .system.avatar import (
    AvatarModel,
    AvatarParams,
    AvatarState,
    MeshBindingParams,
)


@torch.no_grad()
def load_flax_dense_params(module: nn.Module, flax_params) -> None:
    """Copy a Flax params tree ({'params': {name: {'kernel', 'bias'}}}) into
    the module's same-named ``nn.Linear`` layers; every layer must be
    covered."""
    layers = flax_params.get("params", flax_params)
    own = {name for name, m in module.named_children()
           if isinstance(m, nn.Linear)}
    if set(layers) != own:
        raise ValueError(f"layer names differ: flax {sorted(layers)}, "
                         f"torch {sorted(own)}")
    for name, p in layers.items():
        lin = getattr(module, name)
        kernel = torch.as_tensor(np.array(p["kernel"], np.float32)).T
        if kernel.shape != lin.weight.shape:
            raise ValueError(f"{name}: flax kernel {tuple(kernel.shape[::-1])}"
                             f" vs torch weight {tuple(lin.weight.shape)}")
        lin.weight.copy_(kernel)
        lin.bias.copy_(torch.as_tensor(np.array(p["bias"], np.float32)))


def avatar_state_from_numpy(tree, model: AvatarModel,
                            device="cuda") -> AvatarState:
    """The port's AvatarState from a numpy JAX AvatarState; the network
    weights go into ``model``'s modules (moved to ``device``)."""
    device = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        dtype = bool if a.dtype == bool else \
            np.int64 if a.dtype.kind in "iu" else np.float32
        return torch.as_tensor(np.array(a, dtype), device=device)

    p = tree.params
    if not hasattr(p.encoder, "planes"):
        raise NotImplementedError(
            "only triplane field encoders are ported; got "
            f"{type(p.encoder).__name__}")
    for net, flax_params in ((model.color_mlp, p.color_mlp),
                             (model.sq_net, p.sq_net)):
        net.to(device)
        load_flax_dense_params(net, flax_params)
    params = AvatarParams(
        positions=t(p.positions),
        log_scales=t(p.log_scales),
        quats=t(p.quats),
        lbs_weights=t(p.lbs_weights),
        encoder=TriplaneParams(planes=t(p.encoder.planes)),
        mesh={name: MeshBindingParams(bary_coords=t(m.bary_coords),
                                      vertex_coords=t(m.vertex_coords),
                                      scales=t(m.scales))
              for name, m in p.mesh.items()},
        extra_betas=t(p.extra_betas),
        smpl_learn={k: t(v) for k, v in p.smpl_learn.items()},
    )
    vidx = tree.vertex_indices
    return AvatarState(
        params=params,
        alive=t(tree.alive),
        grad_accum=t(tree.grad_accum),
        grad_denom=t(tree.grad_denom),
        max_radii=t(tree.max_radii),
        vertex_indices=None if vidx is None else t(vidx),
    )

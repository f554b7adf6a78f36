"""Carry JAX-package weights and state into the port.

``avatar_state_from_numpy(tree, model)`` takes the JAX ``AvatarState`` as a
tree of numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray, state)``),
loads the two networks' Flax weights into ``model.color_mlp`` and
``model.sq_net`` and returns the port's ``AvatarState``.

* Flax ``Dense`` kernels are (in, out): they land transposed in
  ``nn.Linear.weight``. Layer names (``dense_i``, ``head_offset``,
  ``head_scale``, ``head_quat``, ``branch_w``, ``branch_v``) map one to one.
* Triplane planes (3, R, R, F) and grid tables (L, T_max, F) keep their
  layout.
* ``MeshBindingParams`` and the per-slot arrays copy across.

``nerf_state_from_numpy(tree, model)`` loads the JAX ``NeRFParams`` (as
numpy) into the port's ``NeRFModel``: the triplane planes or grid
tables (and the ``dual_enc`` sigma encoder), the sigma / albedo heads, the background MLP
and ``sigma_scale``. ``nerf_checkpoint_from_numpy`` and
``avatar_checkpoint_from_numpy`` write either as a port checkpoint, which
the CLI's ``--render.from_nerf`` / ``--optim.ckpt`` read.

``dmtet_from_numpy`` takes a numpy JAX ``DMTetModel`` and ``DMTetParams``
to the port's, and ``vanilla_state_from_numpy`` a numpy JAX
``VanillaAvatarState`` (its ``GaussianState`` and LBS weights).

``unet_from_flax``, ``controlnet_from_flax``, ``vae_from_flax`` and
``clip_text_from_flax`` load the Flax parameter trees of the JAX guidance
models and text tower (as numpy) into the port's modules, whose names are
diffusers' and transformers' own:

* Flax ``Conv`` kernels (kh, kw, in, out) become (out, in, kh, kw);
  ``Dense`` (in, out) becomes ``nn.Linear.weight`` (out, in);
  ``GroupNorm`` / ``LayerNorm`` ``scale`` becomes ``weight``.
* Flax module names map to module paths: ``down_blocks_0/attentions_1/
  transformer_blocks_0/attn1/to_out_0`` ->
  ``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_out.0``; the
  VAE's flat ``down_blocks_0_resnets_1`` -> ``down_blocks.0.resnets.1``, its
  ``quant_conv`` / ``post_quant_conv`` at the top level.
* The text tower's ``layers_i`` -> ``text_model.encoder.layers.i``, its
  ``mlp_fc1`` -> ``mlp.fc1``, its embeddings (``embedding`` and the bare
  ``position_embedding``) -> ``text_model.embeddings.*.weight``.
* Every module parameter must be covered and every Flax leaf used.

``clip_vision_from_flax`` and ``clip_text_tower_from_flax`` do the same
for the R-Precision towers (``utils/r_precision.py``), whose names are
transformers' ``CLIPModel``'s: the ViT's ``patch_embedding`` /
``class_embedding`` / ``position_embedding`` under
``vision_model.embeddings.``, ``pre_layernorm`` -> ``pre_layrnorm``.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .nerf.encoder import GridEncoderParams, TriplaneParams
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


@torch.no_grad()
def nerf_state_from_numpy(tree, model) -> None:
    """Load a numpy JAX ``NeRFParams`` into ``model`` (a ``NeRFModel``) in
    place; every part the model has must be in the tree and the reverse."""
    def put(dst, a, name):
        a = torch.as_tensor(np.array(a, np.float32))
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: jax {tuple(a.shape)} vs torch "
                             f"{tuple(dst.shape)}")
        dst.copy_(a)

    name = model.enc_name
    if tree.encoder._fields != (name,):
        raise ValueError(f"the tree's encoder is {type(tree.encoder).__name__}"
                         f", the model's holds {name!r}")
    put(getattr(model, name), tree.encoder[0], name)
    pairs = (("encoder_sigma", name + "_sigma"), ("sigma_mlp", "sigma_mlp"),
             ("albedo_mlp", "albedo_mlp"), ("bg_mlp", "bg_mlp"),
             ("sigma_scale", "sigma_scale"))
    for jax_name, name in pairs:
        src, dst = getattr(tree, jax_name), getattr(model, name)
        if (src is None) != (dst is None):
            raise ValueError(f"{jax_name}: present on one side only")
        if src is None:
            continue
        if isinstance(dst, nn.Module):
            load_flax_dense_params(dst, src)
        elif jax_name == "encoder_sigma":
            put(dst, src[0], name)
        else:
            put(dst, src, name)


_ENCODER_PARAMS = {("planes",): TriplaneParams, ("tables",): GridEncoderParams}


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
    for net, flax_params in ((model.color_mlp, p.color_mlp),
                             (model.sq_net, p.sq_net)):
        net.to(device)
        load_flax_dense_params(net, flax_params)
    params = AvatarParams(
        positions=t(p.positions),
        log_scales=t(p.log_scales),
        quats=t(p.quats),
        lbs_weights=t(p.lbs_weights),
        encoder=_ENCODER_PARAMS[p.encoder._fields](t(p.encoder[0])),
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


def _tensor(a, device):
    a = np.asarray(a)
    dtype = bool if a.dtype == bool else \
        np.int64 if a.dtype.kind in "iu" else np.float32
    return torch.as_tensor(np.array(a, dtype), device=device)


def dmtet_from_numpy(model_tree, params_tree, device="cuda"):
    """The port's (``DMTetModel``, ``DMTetParams``) from the JAX pair as
    numpy (the grid's vertices, tets, bound and deform scale; sdf and
    deform)."""
    from .nerf.dmtet import DMTetModel, DMTetParams

    device = resolve_device(device)
    model = DMTetModel(verts=_tensor(model_tree.verts, device),
                       tets=_tensor(model_tree.tets, device),
                       bound=float(model_tree.bound),
                       deform_scale=float(model_tree.deform_scale))
    return model, DMTetParams(sdf=_tensor(params_tree.sdf, device),
                              deform=_tensor(params_tree.deform, device))


def vanilla_state_from_numpy(tree, device="cuda"):
    """The port's ``VanillaAvatarState`` from a numpy JAX one."""
    from .gaussian.model import GaussianParams, GaussianState
    from .system.vanilla import VanillaAvatarState

    device = resolve_device(device)
    g = tree.gaussians
    return VanillaAvatarState(
        gaussians=GaussianState(
            params=GaussianParams(*[_tensor(a, device) for a in g.params]),
            alive=_tensor(g.alive, device),
            grad_accum=_tensor(g.grad_accum, device),
            grad_denom=_tensor(g.grad_denom, device),
            max_radii=_tensor(g.max_radii, device)),
        lbs_weights=_tensor(tree.lbs_weights, device))


def nerf_checkpoint_from_numpy(tree, nerf_cfg, ckpt_dir):
    """Write a numpy JAX ``NeRFParams`` as a port checkpoint directory
    (``training/checkpoint.py``'s format: the field's state dict under
    "params"), so that ``--render.from_nerf`` or ``--optim.ckpt`` reads a
    field the JAX package trained. Returns the step directory."""
    from .nerf.network import build_nerf
    from .training.checkpoint import save_pytree

    model = build_nerf(nerf_cfg, with_background=tree.bg_mlp is not None,
                       device="cpu")
    nerf_state_from_numpy(tree, model)
    return save_pytree(ckpt_dir, {"params": model.state_dict(),
                                  "opt_state": {}, "step": 0})


def avatar_checkpoint_from_numpy(tree, model: AvatarModel, ckpt_dir):
    """Write a numpy JAX ``AvatarState`` as a port checkpoint directory,
    the tree ``--optim.ckpt`` warm-starts a stage-2 sub-stage from (the
    networks' weights land in ``model`` too). Returns the step
    directory."""
    from .training.checkpoint import save_pytree
    from .training.trainer import avatar_tree

    state = avatar_state_from_numpy(tree, model, device="cpu")
    return save_pytree(ckpt_dir, {"params": avatar_tree(state, model),
                                  "opt_state": {}, "step": 0})


# ---------------------------------------------------------------------------
# Guidance weights
# ---------------------------------------------------------------------------

_INDEXED = re.compile(r"(?<![A-Za-z])(down_blocks|up_blocks|resnets|attentions"
                      r"|transformer_blocks|downsamplers|upsamplers|blocks"
                      r"|to_out|net)_(\d+)")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _module_path(flax_modules) -> str:
    """Flax module names -> the diffusers-style torch module path."""
    name = ".".join(flax_modules).replace("mid_block_", "mid_block.")
    name = _INDEXED.sub(r"\1.\2", name)
    return re.sub(r"(\.\d+)_", r"\1.", name)


def flax_state_dict(flax_params, prefix: str = "", rename=None) -> dict:
    """{torch name: float32 tensor} from a Flax params tree (numpy leaves),
    with kernels laid out as torch keeps them."""
    tree = flax_params.get("params", flax_params)
    out = {}
    for path, leaf in _flatten(tree).items():
        *mods, kind = path
        a = np.asarray(leaf, np.float32)
        if kind == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        name = _module_path(mods)
        if rename is not None:
            name = rename(name)
        leaf_name = {"kernel": "weight", "scale": "weight",
                     "bias": "bias"}[kind]
        out[f"{prefix}{name}.{leaf_name}"] = torch.as_tensor(
            np.ascontiguousarray(a))
    return out


@torch.no_grad()
def _load(module: nn.Module, state: dict) -> nn.Module:
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"weights do not match the module: missing "
                       f"{missing[:5]} ({len(missing)}), unused {unused[:5]} "
                       f"({len(unused)})")
    for name, t in own.items():
        if tuple(state[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: flax {tuple(state[name].shape)} vs "
                             f"torch {tuple(t.shape)}")
        t.copy_(state[name].to(t.dtype))
    return module


def unet_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``UNet2DCondition`` params tree into the port's UNet."""
    return _load(module, flax_state_dict(flax_params))


def controlnet_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``ControlNet`` params tree into the port's ControlNet."""
    return _load(module, flax_state_dict(flax_params))


def vae_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``AutoencoderKL`` tree ({'encoder': ..., 'decoder': ...}),
    whose encoder and decoder hold the two quant convs, into the port's
    AutoencoderKL."""
    state = {}
    for part, top in (("encoder", "quant_conv"),
                      ("decoder", "post_quant_conv")):
        state.update(flax_state_dict(
            flax_params[part],
            rename=lambda n, part=part, top=top:
            n if n.startswith(top) else f"{part}.{n}"))
    return _load(module, state)


def clip_text_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``CLIPTextModel`` params tree into the port's tower."""
    tree = flax_params.get("params", flax_params)
    state = {}
    for path, leaf in _flatten(tree).items():
        a = np.asarray(leaf, np.float32)
        if path == ("position_embedding",):
            state["text_model.embeddings.position_embedding.weight"] = \
                torch.as_tensor(a)
            continue
        *mods, kind = path
        if kind == "kernel":
            a = a.T
        name = ".".join(mods)
        name = re.sub(r"^layers_(\d+)", r"encoder.layers.\1", name)
        name = name.replace("mlp_fc", "mlp.fc")
        if name == "token_embedding":
            name = "embeddings.token_embedding"
        if name != "text_projection":
            name = "text_model." + name
        leaf_name = "bias" if kind == "bias" else "weight"
        state[f"{name}.{leaf_name}"] = torch.as_tensor(
            np.ascontiguousarray(a))
    return _load(module, state)


def clip_vision_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``utils/r_precision.CLIPVisionModel`` params tree into the
    port's ``CLIPVisionModel`` (transformers' names)."""
    tree = flax_params.get("params", flax_params)
    emb = "vision_model.embeddings."
    state = {}
    for path, leaf in _flatten(tree).items():
        a = np.asarray(leaf, np.float32)
        if path in (("class_embedding",), ("position_embedding",)):
            name = emb + path[0] + ("" if path[0] == "class_embedding"
                                    else ".weight")
            state[name] = torch.tensor(a)
            continue
        *mods, kind = path
        if kind == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        name = ".".join(mods)
        name = re.sub(r"^layers_(\d+)", r"vision_model.encoder.layers.\1",
                      name)
        name = name.replace("mlp_fc", "mlp.fc")
        name = {"patch_embedding": emb + "patch_embedding",
                "pre_layernorm": "vision_model.pre_layrnorm",
                "post_layernorm": "vision_model.post_layernorm"}.get(
            name, name)
        leaf_name = "bias" if kind == "bias" else "weight"
        state[f"{name}.{leaf_name}"] = torch.as_tensor(
            np.ascontiguousarray(a))
    return _load(module, state)


def clip_text_tower_from_flax(module: nn.Module, flax_params) -> nn.Module:
    """Load a JAX ``utils/r_precision.CLIPTextTower`` params tree (the text
    model and its ``text_projection``) into the port's ``CLIPTextTower``."""
    tree = flax_params.get("params", flax_params)
    return clip_text_from_flax(module, dict(
        tree["text_model"], text_projection=tree["text_projection"]))

"""Synthetic avatar and guidance fixtures for tests and chip runs.

Port of ``tiny_avatar_setup``, ``tiny_guidance`` and ``tiny_guidance_xl``
from ``dreamwaltz_g_tpu/tests_support.py``. ``tiny_avatar_setup`` takes sizes,
so the same builder makes the few-vertex test avatar and the full-width one
that ``chip_smoke.py`` trains and renders; the body and the point cloud come
from numpy draws identical to the JAX package's. ``sd15_guidance`` builds
the SD1.5-size UNet, ControlNet and VAE with random weights from a seed,
straight into their type on their device; ``sd21_guidance`` and
``sdxl_guidance`` the SD2.x and SDXL-base stacks likewise (SDXL with its
two text towers). ``screen_gaussians`` places 2D
Gaussians straight on the screen for the blend kernels' tests.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .guidance.controlnet import ControlNet
from .guidance.layers import build
from .guidance.sds import GuidanceParams, ScoreDistillation
from .guidance.time_prior import make_schedule
from .guidance.unet import (
    UNet2DCondition,
    UNetConfig,
    sd15_unet_config,
    sd21_unet_config,
    sdxl_unet_config,
    tiny_unet_config,
)
from .guidance.vae import AutoencoderKL, sd_vae_config, tiny_vae_config
from .human.deform import DeformNetwork
from .human.smplx_model import SMPLXParams, default_params, make_synthetic_model
from .nerf.encoder import GridEncoderConfig, TriplaneConfig
from .nerf.network import SigmaMLP
from .ops import rasterize as R
from .ops.blend import PATCH_H, PATCH_W, footprint_boxes, pack_rows
from .system import avatar as A


# the JAX fixture's default field: a 4-level tiled grid, 2^8 tables
TINY_GRID = GridEncoderConfig(num_levels=4, level_dim=2, base_resolution=4,
                              desired_resolution=32, log2_hashmap_size=8)


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
                      enc_cfg: Union[TriplaneConfig, GridEncoderConfig,
                                     None] = None,
                      mlp_hidden: int = 32, mlp_layers: int = 2,
                      deform_depth: int = 2, deform_width: int = 32,
                      prune_dists_close_to_mesh: Optional[float] = None,
                      device="cuda") -> TinyAvatarSetup:
    """An articulated avatar around the synthetic stick body.

    ``mesh_part`` names one part bound to the ``part_triangles`` highest
    triangles at ``n_per_triangle`` Gaussians each (None: no part). The
    defaults are the JAX fixture's sizes, but the field here is a triplane
    (16^2 x 8) by default; ``enc_cfg`` takes a ``TriplaneConfig`` or a
    ``GridEncoderConfig`` (``TINY_GRID`` is the JAX fixture's grid)."""
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


def _guidance(ucfg, vcfg, cond_block_channels, seed, with_controlnet,
              device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    unet = build(lambda: UNet2DCondition(ucfg), device, dtype, gen)
    vae = build(lambda: AutoencoderKL(vcfg), device, dtype, gen)
    cn = None
    if with_controlnet:
        cn = build(lambda: ControlNet(ucfg, cond_block_channels), device,
                   dtype, gen)
        cn.zero_init_()
    return GuidanceParams(unet=unet, vae=vae, controlnet=cn)


def tiny_guidance(seed: int = 0, with_controlnet: bool = False,
                  latent_size: int = 8, device="cuda", dtype=torch.float32):
    """A randomly initialised tiny SD stack (the JAX fixture's sizes: the
    tiny UNet and VAE, a ControlNet with two condition blocks to match the
    tiny VAE's factor 2). Returns (ScoreDistillation, GuidanceParams)."""
    device = resolve_device(device)
    params = _guidance(tiny_unet_config(), tiny_vae_config(), (16, 32), seed,
                       with_controlnet, device, dtype)
    return ScoreDistillation(schedule=make_schedule(device=device),
                             latent_size=latent_size,
                             guidance_scale=7.5), params


def sd15_guidance(seed: int = 0, with_controlnet: bool = True,
                  device="cuda", dtype=torch.bfloat16):
    """The SD1.5-size stack (``sd15_unet_config`` UNet and ControlNet,
    ``sd_vae_config`` VAE, 64^2 latents, CFG scale 50) with random weights
    drawn from ``seed`` in ``dtype`` on ``device``; the ControlNet's zero
    convolutions are zero, as at a fresh init. Returns
    (ScoreDistillation, GuidanceParams)."""
    device = resolve_device(device)
    params = _guidance(sd15_unet_config(), sd_vae_config(),
                       (16, 32, 96, 256), seed, with_controlnet, device, dtype)
    return ScoreDistillation(schedule=make_schedule(device=device),
                             latent_size=64, guidance_scale=50.0), params


def sd21_guidance(seed: int = 0, with_controlnet: bool = True,
                  latent_size: int = 96, device="cuda",
                  dtype=torch.bfloat16):
    """The SD2.x-size stack (``sd21_unet_config`` UNet and ControlNet,
    ``sd_vae_config`` VAE, CFG scale 50) with random weights from ``seed``;
    at the 768-v cards' 96^2 latents it predicts v. Returns
    (ScoreDistillation, GuidanceParams)."""
    device = resolve_device(device)
    params = _guidance(sd21_unet_config(), sd_vae_config(),
                       (16, 32, 96, 256), seed, with_controlnet, device, dtype)
    return ScoreDistillation(
        schedule=make_schedule(device=device), latent_size=latent_size,
        guidance_scale=50.0, prediction_type="v_prediction"
        if latent_size == 96 else "epsilon"), params


def _towers(cfgs, seed, device):
    """Text towers of ``cfgs`` in float32, random from ``seed`` + i."""
    from .guidance.clip_text import CLIPTextModel

    towers = []
    for i, cfg in enumerate(cfgs):
        tower = build(lambda cfg=cfg: CLIPTextModel(cfg), device,
                      torch.float32)
        tower.reset_parameters(
            torch.Generator(device=device).manual_seed(seed + i))
        towers.append(tower)
    return towers


def tiny_guidance_xl(seed: int = 0, latent_size: int = 8, device="cuda",
                     dtype=torch.float32):
    """A randomly initialised tiny SDXL-style stack (the JAX fixture's
    sizes: the addition-embed UNet on a 56-wide context, the tiny VAE, no
    ControlNet) with a tiny dual text tower over hash ids. Returns
    (ScoreDistillationXL, GuidanceParams, text_embed_fn), ``text_embed_fn``
    giving (embeds (N, 16, 56), pooled (N, 24)) in float32."""
    from .guidance.clip_text import HashTokenizer, tiny_text_config
    from .guidance.sdxl import ScoreDistillationXL, xl_text_embed_fn

    device = resolve_device(device)
    tcfg1 = tiny_text_config()
    tcfg2 = tiny_text_config()._replace(projection_dim=24, hidden_size=24)
    ucfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=tcfg1.hidden_size
                      + tcfg2.hidden_size, num_heads=2,
                      attn_down=(True, False), addition_embed=True,
                      addition_pooled_dim=tcfg2.projection_dim,
                      addition_time_embed_dim=8)
    params = _guidance(ucfg, tiny_vae_config(), (16, 32), seed, False,
                       device, dtype)
    clip1, clip2 = _towers((tcfg1, tcfg2), seed + 1, device)
    tok = HashTokenizer(vocab_size=tcfg1.vocab_size,
                        max_length=tcfg1.max_length)
    sd = ScoreDistillationXL(schedule=make_schedule(device=device),
                             latent_size=latent_size, guidance_scale=7.5)
    return sd, params, xl_text_embed_fn(tok, clip1, clip2, device)


def sdxl_guidance(seed: int = 0, with_controlnet: bool = True,
                  device="cuda", dtype=torch.bfloat16):
    """The SDXL-base stack (``sdxl_unet_config`` UNet and a pose ControlNet
    on the same config, ``sd_vae_config`` VAE, 128^2 latents, CFG scale 50)
    in ``dtype`` and its two text towers (CLIP-L, bigG with its projection)
    in float32, random from ``seed``. Returns (ScoreDistillationXL,
    GuidanceParams, (clip_l, clip_bigg))."""
    from .guidance.clip_text import CLIPTextConfig, clip_bigg_config
    from .guidance.sdxl import ScoreDistillationXL

    device = resolve_device(device)
    params = _guidance(sdxl_unet_config(), sd_vae_config(),
                       (16, 32, 96, 256), seed, with_controlnet, device, dtype)
    towers = _towers((CLIPTextConfig(), clip_bigg_config()), seed + 1,
                     device)
    sd = ScoreDistillationXL(schedule=make_schedule(device=device),
                             latent_size=128, guidance_scale=50.0)
    return sd, params, tuple(towers)


def screen_gaussians(n: int, height: int, width: int, seed: int = 0,
                     opacity=(0.3, 0.99), sigma=(0.5, 6.0),
                     grazing: bool = False,
                     device="cpu") -> R.Gaussians2D:
    """``n`` Gaussians placed straight on a height x width screen, as
    ``rasterize.project_gaussians`` returns them: random rotated covariances
    with standard deviations in ``sigma`` plus the projection's 0.3 blur,
    opacities in ``opacity``, depths in [1, 5). The radius covers the
    footprint box (``ops/blend.py:footprint_boxes``) by a pixel, so every
    pixel an entry can blend lies in a tile it is binned to. With
    ``grazing``, each Gaussian is moved so that one x edge and one y edge of
    its box fall within a pixel of a patch border (x a multiple of 8, y of
    4): the cull's closest calls."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, np.pi, n)
    l1 = rng.uniform(*sigma, n) ** 2 + 0.3
    l2 = rng.uniform(*sigma, n) ** 2 + 0.3
    c, s = np.cos(th), np.sin(th)
    a = l1 * c * c + l2 * s * s
    b = (l1 - l2) * c * s
    d = l1 * s * s + l2 * c * c
    det = a * d - b * b
    f32 = torch.float32
    conic = torch.tensor(np.stack([d / det, -b / det, a / det], -1), dtype=f32)
    op = torch.tensor(rng.uniform(*opacity, n), dtype=f32)
    colors = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=f32)
    box = footprint_boxes(pack_rows(torch.zeros((n, 2)), conic, op,
                                    colors)[:-1]).numpy()
    half = np.stack([box[:, 1], box[:, 3]], -1)          # x, y half-extents
    if grazing:
        border = np.stack([PATCH_W * rng.integers(0, width // PATCH_W + 1, n),
                           PATCH_H * rng.integers(0, height // PATCH_H + 1,
                                                  n)], -1)
        side = rng.choice([-1.0, 1.0], (n, 2))
        means = border + rng.uniform(-1, 1, (n, 2)) - side * half
    else:
        means = rng.uniform(0, 1, (n, 2)) * [width, height]
    radius = np.ceil(np.maximum(half.max(-1), 3 * np.sqrt(np.maximum(l1, l2))))
    return R.Gaussians2D(
        means2d=torch.tensor(means, dtype=f32, device=dev),
        conic=conic.to(dev),
        depth=torch.tensor(rng.uniform(1, 5, n), dtype=f32, device=dev),
        radius=torch.tensor(radius + 1, dtype=f32, device=dev),
        opacity=op.to(dev), colors=colors.to(dev),
        mask=torch.ones(n, dtype=torch.bool, device=dev))

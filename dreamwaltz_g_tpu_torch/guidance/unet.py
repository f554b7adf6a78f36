"""Stable Diffusion UNet (UNet2DConditionModel).

Port of ``dreamwaltz_g_tpu/guidance/unet.py`` with ControlNet residual
injection (additive down/mid residuals). ``sd15_unet_config()`` matches the
released SD1.5 weights, ``sd21_unet_config()`` SD2.x's (1024-wide context,
64-wide heads), ``sdxl_unet_config()`` SDXL-base's (three levels, 10
transformer layers at the deepest, the ``addition_embed`` 'text_time'
conditioning: the pooled text embedding and the six size / crop ids
embedded into the time embedding), ``tiny_unet_config()`` the tests' tiny
UNet. The model runs in its weights' type: inputs are cast to it at
``forward`` (under ``layers.jax_promotion`` they keep their own, as in the
JAX package).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    model_input,
    timestep_embedding,
)


class UNetConfig(NamedTuple):
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    # SD1.5 uses 8 heads at every resolution (head_dim = C / 8)
    num_heads: int = 8
    transformer_depth: int = 1         # int, or per-block tuple
    # which down blocks carry cross-attention (SD1.5: the first three)
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    freq_shift: float = 0.0
    head_dim: Optional[int] = None     # fixed per-head width (SD2.x / SDXL)
    addition_embed: bool = False       # SDXL's 'text_time' conditioning
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280    # the pooled text embedding's width

    def block_heads(self, out_ch: int) -> int:
        if self.head_dim is not None:
            return max(out_ch // self.head_dim, 1)
        return self.num_heads

    def block_depth(self, block_index: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[block_index]
        return self.transformer_depth


def sd15_unet_config() -> UNetConfig:
    return UNetConfig()


def sd21_unet_config() -> UNetConfig:
    """SD2.x (stable-diffusion-2[-1][-base]): the OpenCLIP ViT-H context
    (1024) and 64-wide heads (5 / 10 / 20 / 20 a level). The 768-v cards
    are v-prediction models (``ScoreDistillation(prediction_type=
    'v_prediction', latent_size=96)``)."""
    return UNetConfig(cross_attention_dim=1024, head_dim=64)


def sdxl_unet_config() -> UNetConfig:
    """SDXL-base (stable-diffusion-xl-base-1.0)."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        cross_attention_dim=2048,
        transformer_depth=(1, 2, 10),
        attn_down=(False, True, True),
        head_dim=64,
        addition_embed=True,
    )


def tiny_unet_config() -> UNetConfig:
    return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=32, num_heads=2,
                      attn_down=(True, False))


def _transformer(cfg: UNetConfig, ch: int, block_index: int) -> Transformer2D:
    heads = cfg.block_heads(ch)
    return Transformer2D(ch, heads, ch // heads, cfg.cross_attention_dim,
                         cfg.block_depth(block_index))


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 with_attn: bool, add_downsample: bool, block_index: int = 0):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb)
            for i in range(cfg.layers_per_block)])
        if with_attn:
            self.attentions = nn.ModuleList([
                _transformer(cfg, out_channels, block_index)
                for _ in range(cfg.layers_per_block)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels)])

    def forward(self, x, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UNetMidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, temb)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, channels, -1)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock(nn.Module):
    """``in_channels[i]``: the channels of resnet i's input, the running
    features concatenated with the skip it pops."""

    def __init__(self, cfg: UNetConfig, in_channels: Sequence[int],
                 out_channels: int, with_attn: bool, add_upsample: bool,
                 block_index: int = 0):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c, out_channels, temb) for c in in_channels])
        if with_attn:
            self.attentions = nn.ModuleList([
                _transformer(cfg, out_channels, block_index)
                for _ in in_channels])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, x, skips: List[torch.Tensor], temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


def addition_embedding(cfg: UNetConfig) -> Optional[TimestepEmbedding]:
    """SDXL's ``add_embedding`` (None without ``addition_embed``)."""
    if not cfg.addition_embed:
        return None
    return TimestepEmbedding(
        cfg.addition_pooled_dim + 6 * cfg.addition_time_embed_dim,
        cfg.block_out_channels[0] * 4)


def time_conditioning(module: nn.Module, timesteps: torch.Tensor,
                      dt: torch.dtype, pooled_embeds=None,
                      add_time_ids=None) -> torch.Tensor:
    """The UNet's / ControlNet's time embedding, plus, with
    ``addition_embed``, ``add_embedding`` of [pooled (B, Dp), the
    sinusoidal embedding of each of the six ids (B, 6 * dim)]."""
    cfg = module.cfg
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              downscale_freq_shift=cfg.freq_shift)
    temb = module.time_embedding(model_input(temb, dt))
    if cfg.addition_embed:
        if pooled_embeds is None or add_time_ids is None:
            raise ValueError("addition_embed needs pooled_embeds and "
                             "add_time_ids")
        B = pooled_embeds.shape[0]
        ids = timestep_embedding(
            add_time_ids.reshape(-1), cfg.addition_time_embed_dim,
            downscale_freq_shift=cfg.freq_shift).reshape(B, -1)
        aug = torch.cat([model_input(pooled_embeds, dt),
                         model_input(ids, dt)], dim=-1)
        temb = temb + module.add_embedding(aug)
    return temb


def _down_path(cfg: UNetConfig):
    """The encoder half shared by the UNet and the ControlNet: conv_in's
    width, the down blocks, and the channels of every skip in push order."""
    chs = cfg.block_out_channels
    blocks, skips, prev = [], [chs[0]], chs[0]
    for bi, out_ch in enumerate(chs):
        last = bi == len(chs) - 1
        blocks.append(CrossAttnDownBlock(cfg, prev, out_ch, cfg.attn_down[bi],
                                         not last, bi))
        skips += [out_ch] * (cfg.layers_per_block + (0 if last else 1))
        prev = out_ch
    return nn.ModuleList(blocks), skips


class UNet2DCondition(nn.Module):
    """Inputs NHWC latents (B, H, W, 4), timesteps (B,), context (B, L, D).

    ``down_residuals`` (NHWC, one per skip) / ``mid_residual`` inject
    ControlNet residuals. Returns NHWC (B, H, W, out_channels)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        ch0 = chs[0]
        self.time_embedding = TimestepEmbedding(ch0, ch0 * 4)
        self.add_embedding = addition_embedding(cfg)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.down_blocks, skip_chs = _down_path(cfg)
        self.mid_block = UNetMidBlock(cfg, chs[-1])
        ups, x_ch = [], chs[-1]
        for bi in reversed(range(len(chs))):
            ins = []
            for _ in range(cfg.layers_per_block + 1):
                ins.append(x_ch + skip_chs.pop())
                x_ch = chs[bi]
            ups.append(CrossAttnUpBlock(cfg, ins, chs[bi], cfg.attn_down[bi],
                                        bi != 0, bi))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(32 if ch0 >= 32 else ch0, ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                pooled_embeds: Optional[torch.Tensor] = None,   # (B, Dp)
                add_time_ids: Optional[torch.Tensor] = None,    # (B, 6)
                ) -> torch.Tensor:
        dt = self.conv_in.weight.dtype
        context = model_input(context, dt)
        temb = time_conditioning(self, timesteps, dt, pooled_embeds,
                                 add_time_ids)

        x = self.conv_in(model_input(sample, dt).permute(0, 3, 1, 2))
        skips = [x]
        for block in self.down_blocks:
            x, s = block(x, temb, context)
            skips.extend(s)
        if down_residuals is not None:
            if len(down_residuals) != len(skips):
                raise ValueError(f"controlnet residual count "
                                 f"{len(down_residuals)} != {len(skips)}")
            skips = [s + model_input(r, dt).permute(0, 3, 1, 2)
                     for s, r in zip(skips, down_residuals)]
        x = self.mid_block(x, temb, context)
        if mid_residual is not None:
            x = x + model_input(mid_residual, dt).permute(0, 3, 1, 2)
        for block in self.up_blocks:
            x = block(x, skips, temb, context)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1)

"""ControlNet.

Port of ``dreamwaltz_g_tpu/guidance/controlnet.py``: a copy of the UNet
encoder and mid block, a small conv stack embedding the condition image to
latent resolution, and zero-initialised 1x1 convs on every skip output.
NHWC at ``forward``; on an ``addition_embed`` config (SDXL) the pooled
embeddings and the size / crop ids join the time embedding, as in the
UNet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Conv2d, TimestepEmbedding, model_input
from .unet import (
    UNetConfig,
    UNetMidBlock,
    _down_path,
    addition_embedding,
    time_conditioning,
)


class ControlNetConditioningEmbedding(nn.Module):
    """Condition image (B, 3, H*f, W*f) -> (B, ch0, H, W), f = 2^(len - 1)."""

    def __init__(self, out_channels: int,
                 block_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.conv_in = Conv2d(3, block_channels[0], 3, padding=1)
        blocks = []
        for i in range(len(block_channels) - 1):
            blocks.append(Conv2d(block_channels[i], block_channels[i], 3,
                                 padding=1))
            blocks.append(Conv2d(block_channels[i], block_channels[i + 1],
                                 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(block_channels[-1], out_channels, 3,
                               padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 cond_block_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        ch0 = chs[0]
        self.time_embedding = TimestepEmbedding(ch0, ch0 * 4)
        self.add_embedding = addition_embedding(cfg)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            ch0, cond_block_channels)
        self.down_blocks, skip_chs = _down_path(cfg)
        self.mid_block = UNetMidBlock(cfg, chs[-1])
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv2d(c, c, 1) for c in skip_chs])
        self.controlnet_mid_block = Conv2d(chs[-1], chs[-1], 1)

    @torch.no_grad()
    def zero_init_(self) -> None:
        """The zero convolutions of a fresh ControlNet (the condition
        embedding's ``conv_out`` and every residual conv), as Flax
        initialises them."""
        for conv in [self.controlnet_cond_embedding.conv_out,
                     self.controlnet_mid_block, *self.controlnet_down_blocks]:
            conv.weight.zero_()
            conv.bias.zero_()

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, cond_image: torch.Tensor,
                conditioning_scale: float = 1.0, guess_mode: bool = False,
                pooled_embeds: Optional[torch.Tensor] = None,
                add_time_ids: Optional[torch.Tensor] = None,
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample (B, h, w, 4), cond_image (B, 8h, 8w, 3) in [0, 1];
        ``pooled_embeds`` (B, Dp) and ``add_time_ids`` (B, 6) on an
        ``addition_embed`` config. Returns the NHWC down residuals (one per
        UNet skip) and the mid residual. ``guess_mode``: residual scales
        ramp logspace(-1, 0) shallow -> deep."""
        dt = self.conv_in.weight.dtype
        context = model_input(context, dt)
        temb = time_conditioning(self, timesteps, dt, pooled_embeds,
                                 add_time_ids)

        x = self.conv_in(model_input(sample, dt).permute(0, 3, 1, 2))
        x = x + self.controlnet_cond_embedding(
            model_input(cond_image, dt).permute(0, 3, 1, 2))
        skips = [x]
        for block in self.down_blocks:
            x, s = block(x, temb, context)
            skips.extend(s)
        x = self.mid_block(x, temb, context)

        n_out = len(skips) + 1
        if guess_mode:
            scales = (torch.logspace(-1.0, 0.0, n_out) * conditioning_scale
                      ).tolist()
        else:
            scales = [conditioning_scale] * n_out
        down_res = [(conv(s) * scales[i]).permute(0, 2, 3, 1)
                    for i, (conv, s) in enumerate(
                        zip(self.controlnet_down_blocks, skips))]
        mid_res = (self.controlnet_mid_block(x) * scales[-1]).permute(
            0, 2, 3, 1)
        return down_res, mid_res

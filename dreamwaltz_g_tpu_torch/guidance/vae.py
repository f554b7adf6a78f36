"""AutoencoderKL (the SD VAE).

Port of ``dreamwaltz_g_tpu/guidance/vae.py``. ``encode`` gives the mean of
the latent distribution times the 0.18215 scaling factor (SDS uses the
mode), or a sample of it when given ``noise=`` or a ``generator``. Images and
latents are NHWC at ``encode`` / ``decode``; names are diffusers' (the
``quant_conv`` pair at the top level).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import AttnBlockVAE, Downsample2D, ResnetBlock2D, Upsample2D


class VAEConfig(NamedTuple):
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


def sd_vae_config() -> VAEConfig:
    return VAEConfig()


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(32, 64), layers_per_block=1)


def _ResnetNoTime(in_channels: int, out_channels: int) -> ResnetBlock2D:
    """VAE resnet: no time conditioning, GroupNorm epsilon 1e-6."""
    return ResnetBlock2D(in_channels, out_channels, None, eps=1e-6)


class _Sampling(nn.Module):
    def __init__(self, resnets, sampler=None, name="downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([_ResnetNoTime(ch, ch),
                                      _ResnetNoTime(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlockVAE(ch)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        blocks, prev = [], chs[0]
        for bi, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(_ResnetNoTime(prev, ch))
                prev = ch
            last = bi == len(chs) - 1
            blocks.append(_Sampling(resnets,
                                    None if last else Downsample2D(ch)))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(chs[-1])
        self.conv_norm_out = nn.GroupNorm(min(32, chs[-1]), chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        ch = chs[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch)
        blocks, prev = [], ch
        for ui, ch in enumerate(reversed(chs)):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(_ResnetNoTime(prev, ch))
                prev = ch
            last = ui == len(chs) - 1
            blocks.append(_Sampling(resnets, None if last else Upsample2D(ch),
                                    name="upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(min(32, prev), prev, eps=1e-6)
        self.conv_out = nn.Conv2d(prev, cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Encode/decode with the SD scaling factor; NHWC at the boundary."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        L = cfg.latent_channels
        self.quant_conv = nn.Conv2d(2 * L, 2 * L, 1)
        self.post_quant_conv = nn.Conv2d(L, L, 1)

    def encode(self, images: torch.Tensor,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] -> (B, h, w, 4) scaled latents, in
        the weights' type: the distribution's mode, or, with ``noise``
        (B, h, w, 4) or a ``generator`` to draw it from, the posterior
        sample ``mean + exp(0.5 clip(logvar, -30, 20)) * noise``."""
        x = images.to(self.quant_conv.weight.dtype) * 2.0 - 1.0
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        L = self.cfg.latent_channels
        mean = moments[:, :L].permute(0, 2, 3, 1)
        if noise is not None or generator is not None:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device)
            logvar = moments[:, L:].permute(0, 2, 3, 1)
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            mean = mean + std * noise.to(mean.device, mean.dtype)
        return mean * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 4) scaled latents -> (B, H, W, 3) images in [0, 1]."""
        z = latents.to(self.post_quant_conv.weight.dtype) \
            / self.cfg.scaling_factor
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

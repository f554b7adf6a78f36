"""SDXL score distillation.

Port of ``dreamwaltz_g_tpu/guidance/sdxl.py``: ``ScoreDistillationXL``
subclasses ``ScoreDistillation`` and changes only the eps prediction, which
carries the pooled text embedding and the six ``add_time_ids`` (original
size, crop, target size) into every UNet and ControlNet call, so every
loss family and denoise mode runs on SDXL. The pooled embeddings are set
per prompt (``pooled_text`` / ``pooled_uncond``); the latents are 128^2
for 1024^2 renders. As in the JAX package, the VAE keeps SD1.5's scaling
factor 0.18215 and the predictions are taken as eps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .._device import resolve_device
from .sds import GuidanceParams, ScoreDistillation


def xl_text_embed_fn(tokenizer, clip1, clip2, device):
    """``text_embed_fn(texts)`` -> (embeds (N, L, D1 + D2), pooled (N, Dp)):
    tower 1's penultimate states beside tower 2's, and tower 2's projected
    pooled output, both towers on the one tokenizer's ids."""
    @torch.no_grad()
    def text_embed_fn(texts):
        ids = torch.as_tensor(tokenizer(list(texts)), device=device)
        h2, pooled = clip2(ids, mode="penultimate_pooled")
        return torch.cat([clip1(ids, mode="penultimate"), h2], -1), pooled

    return text_embed_fn


def make_add_time_ids(batch: int, orig_size=(1024, 1024), crop=(0, 0),
                      target_size=(1024, 1024), device="cuda"
                      ) -> torch.Tensor:
    """(B, 6) float32 SDXL micro-conditioning ids."""
    ids = torch.tensor([*orig_size, *crop, *target_size],
                       dtype=torch.float32, device=resolve_device(device))
    return ids.expand(batch, 6)


@dataclass
class ScoreDistillationXL(ScoreDistillation):
    """SDXL guidance: the pooled embeddings ride along with the context."""

    pooled_text: Optional[torch.Tensor] = None     # (1, Dp)
    pooled_uncond: Optional[torch.Tensor] = None   # (1, Dp)
    latent_size: int = 128
    guess_mode: bool = False

    def _eps(self, params: GuidanceParams, latents, t, context,
             cond_image=None, pooled=None):
        """One eps prediction; ``pooled`` (B, Dp) defaults to the text
        branch's pooled embedding."""
        B = latents.shape[0]
        if pooled is None:
            pooled = self.pooled_text.expand(B, -1)
        tids = make_add_time_ids(B, device=latents.device)
        if params.controlnet is not None and cond_image is not None:
            down_res, mid_res = params.controlnet(
                latents, t, context, cond_image, self.controlnet_scale,
                guess_mode=self.guess_mode, pooled_embeds=pooled,
                add_time_ids=tids)
            return params.unet(latents, t, context, down_residuals=down_res,
                               mid_residual=mid_res, pooled_embeds=pooled,
                               add_time_ids=tids)
        return params.unet(latents, t, context, pooled_embeds=pooled,
                           add_time_ids=tids)

    def _cfg_eps(self, params, latents_noisy, t, ctx_text, ctx_uncond,
                 cond_image, guidance_scale):
        """CFG with each branch's pooled embedding."""
        B = latents_noisy.shape[0]
        lat2 = torch.cat([latents_noisy, latents_noisy], 0)
        t2 = torch.cat([t, t], 0)
        ctx2 = torch.cat([ctx_uncond, ctx_text], 0)
        cond2 = None if cond_image is None else torch.cat(
            [cond_image, cond_image], 0)
        pooled2 = torch.cat([self.pooled_uncond.expand(B, -1),
                             self.pooled_text.expand(B, -1)], 0)
        eps = self._eps(params, lat2, t2, ctx2, cond2, pooled=pooled2)
        eps_uncond, eps_text = eps[:B], eps[B:]
        return eps_uncond + guidance_scale * (eps_text - eps_uncond), \
            eps_uncond, eps_text

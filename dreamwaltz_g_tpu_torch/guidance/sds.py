"""Score Distillation Sampling.

Port of the score-family core of ``dreamwaltz_g_tpu/guidance/sds.py``:
render -> VAE encode (gradients flow) -> add noise at timestep t -> frozen
UNet (+ ControlNet) eps prediction with classifier-free guidance -> the
``sds`` / ``sjc`` / ``sjc-red`` gradient -> weighting -> latent guards ->
``loss = sum(latents * grad) / B``, whose gradient with respect to the
latents is ``grad / B`` (the SpecifyGradient trick).

The modules hold their own weights, so ``GuidanceParams`` carries the three
modules where the JAX package carries their parameter trees. The noise
comes from an explicit ``noise=`` tensor or a ``torch.Generator``. Each
model runs in its weights' type: at bfloat16 the UNet sees bfloat16 noisy
latents, where the JAX package adds the float32 schedule to bfloat16
latents and runs the UNet on the promoted float32.

Not ported yet: the csd / nfsd / ism / custom families, the denoise modes
(z0, x0), the pixel-gradient hooks, ``sample_images`` and resizing a render
to the VAE's input size; asking for one raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.profiler import record_function

from .time_prior import DiffusionSchedule, make_schedule

#: the loss families ported so far
LOSS_TYPES = ("sds", "sjc", "sjc-red")


class GuidanceParams(NamedTuple):
    """The frozen guidance models."""

    unet: nn.Module
    vae: nn.Module
    controlnet: Optional[nn.Module] = None


@dataclass
class ScoreDistillation:
    """Static guidance settings + the loss computation."""

    schedule: DiffusionSchedule = None
    loss_type: str = "sds"
    weight_type: str = "sjc"          # {'dreamfusion', 'latent-nerf', 'ism', 'sjc'}
    guidance_scale: float = 50.0
    guidance_rescale: float = 0.0     # CFG std-rescale (arXiv 2305.08891 §3.4)
    controlnet_scale: float = 1.0
    grad_latent_clip: bool = False
    grad_latent_clip_scale: float = 3.0
    grad_latent_norm: bool = False
    grad_latent_nan_to_num: bool = True
    prediction_type: str = "epsilon"  # or 'v_prediction'
    latent_size: int = 64

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = make_schedule()
        if self.loss_type not in LOSS_TYPES:
            raise NotImplementedError(
                f"loss_type {self.loss_type!r} is not ported; ported: "
                f"{LOSS_TYPES}")

    def encode_images(self, params: GuidanceParams, images: torch.Tensor
                      ) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, h, w, 4) latents, with the graph
        kept. The render must already be the VAE's input size
        (``latent_size`` x the VAE's downsampling factor)."""
        B, H, W, _ = images.shape
        target = self.latent_size * 2 ** (
            len(params.vae.cfg.block_out_channels) - 1)
        if H != target or W != target:
            raise NotImplementedError(
                f"render {H}x{W} != the VAE input {target}x{target}: resizing "
                "renders is not ported")
        return params.vae.encode(images)

    def _eps(self, params: GuidanceParams, latents, t, context,
             cond_image=None):
        """One frozen eps prediction, ControlNet-conditioned when both a
        ControlNet and a condition image are given."""
        if params.controlnet is not None and cond_image is not None:
            down_res, mid_res = params.controlnet(
                latents, t, context, cond_image, self.controlnet_scale)
            pred = params.unet(latents, t, context, down_residuals=down_res,
                               mid_residual=mid_res)
        else:
            pred = params.unet(latents, t, context)
        if self.prediction_type == "v_prediction":
            # eps = sqrt(ac) v + sqrt(1 - ac) x_t
            ac = self.schedule.alphas_cumprod.to(latents.device)[t]
            ac = ac.reshape((-1,) + (1,) * (latents.ndim - 1))
            pred = (torch.sqrt(ac) * pred.float()
                    + torch.sqrt(1.0 - ac) * latents.float()).to(pred.dtype)
        return pred

    def _cfg_eps(self, params, latents_noisy, t, ctx_text, ctx_uncond,
                 cond_image, guidance_scale):
        """eps with classifier-free guidance: one batched pass over the
        (uncond | text) stack."""
        B = latents_noisy.shape[0]
        lat2 = torch.cat([latents_noisy, latents_noisy], 0)
        t2 = torch.cat([t, t], 0)
        ctx2 = torch.cat([ctx_uncond, ctx_text], 0)
        cond2 = None if cond_image is None else torch.cat(
            [cond_image, cond_image], 0)
        eps = self._eps(params, lat2, t2, ctx2, cond2)
        eps_uncond, eps_text = eps[:B], eps[B:]
        return eps_uncond + guidance_scale * (eps_text - eps_uncond), \
            eps_uncond, eps_text

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        ac = self.schedule.alphas_cumprod.to(t.device)[t]
        if self.weight_type == "dreamfusion":
            w = 1.0 - ac
        elif self.weight_type == "latent-nerf":
            w = (1.0 - ac) * torch.sqrt(ac)
        elif self.weight_type == "ism":
            w = torch.sqrt((1.0 - ac) / ac)
        elif self.weight_type == "sjc":
            w = torch.ones_like(ac)
        else:
            raise NotImplementedError(self.weight_type)
        return w[:, None, None, None]

    def __call__(
        self,
        params: GuidanceParams,
        images: torch.Tensor,          # (B, H, W, 3) rendered, grads flow
        text_embeds: torch.Tensor,     # (B, L, D)
        uncond_embeds: torch.Tensor,   # (B, L, D) null or negative prompt
        t: torch.Tensor,               # (B,) integer timesteps
        noise: Optional[torch.Tensor] = None,
        cond_image: Optional[torch.Tensor] = None,   # (B, 8h, 8w, 3)
        guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Returns 'loss' (a float32 scalar: backprop this), 'gradients',
        'latents' and 'target'."""
        with record_function("sds.encode_images"):
            latents = self.encode_images(params,
                                         images.to(text_embeds.dtype))
        with record_function("sds.latent_gradients"):
            grad = self.latent_gradients(
                params, latents.detach(), text_embeds, uncond_embeds, t,
                noise=noise, cond_image=cond_image,
                guidance_scale=guidance_scale, generator=generator)
        loss = torch.sum(latents.float() * grad) / latents.shape[0]
        return {"loss": loss, "gradients": grad, "latents": latents,
                "target": latents.detach().float() - grad}

    @torch.no_grad()
    def latent_gradients(
        self,
        params: GuidanceParams,
        lat_sg: torch.Tensor,          # (B, h, w, 4) latents, no grad flow
        text_embeds: torch.Tensor,
        uncond_embeds: torch.Tensor,
        t: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        cond_image: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The frozen forward-only half of SDS: eps predictions -> weighted,
        guarded latent gradient (float32). The noise is ``noise`` or, when
        that is None, a standard normal draw from ``generator``."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        dt = text_embeds.dtype
        lat_sg = lat_sg.to(dt)
        if noise is None:
            if generator is None:
                raise ValueError("pass noise= or generator=")
            noise = torch.randn(lat_sg.shape, generator=generator,
                                device=lat_sg.device, dtype=dt)
        noise = noise.to(dt)
        t = t.to(lat_sg.device).long()
        schedule = self.schedule.to(lat_sg.device)
        latents_noisy = schedule.add_noise(lat_sg.float(), noise.float(),
                                           t).to(dt)

        eps_hat, _, eps_text = self._cfg_eps(
            params, latents_noisy, t, text_embeds, uncond_embeds, cond_image,
            gs)
        if self.guidance_rescale > 0.0:
            eps_hat = _rescale_noise_cfg(eps_hat, eps_text,
                                         self.guidance_rescale)
        # sjc-red keeps the full CFG'd score as the gradient
        grad = eps_hat if self.loss_type == "sjc-red" else eps_hat - noise
        grad = grad.float() * self._weight(t)

        # latent-gradient guards
        if self.grad_latent_clip:
            g = torch.nan_to_num(grad)
            nz = torch.clamp(torch.sum(g.abs() > 0), min=1)
            std = torch.sqrt(torch.sum(g * g) / nz) \
                * self.grad_latent_clip_scale
            grad = torch.nan_to_num(torch.clamp(grad, -std, std))
        if self.grad_latent_norm:
            g = torch.nan_to_num(grad)
            n = torch.sqrt(torch.sum(g * g, dim=(1, 2, 3), keepdim=True))
            grad = g / torch.clamp(n, min=1e-8)
        if self.grad_latent_nan_to_num:
            grad = torch.nan_to_num(grad)
        return grad.float()


def _rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                       guidance_rescale: float) -> torch.Tensor:
    """Rescale CFG'd eps toward the text branch's std (arXiv 2305.08891
    §3.4)."""
    axes = tuple(range(1, noise_cfg.ndim))
    std_text = torch.std(noise_pred_text, dim=axes, keepdim=True,
                         correction=0)
    std_cfg = torch.clamp(torch.std(noise_cfg, dim=axes, keepdim=True,
                                    correction=0), min=1e-8)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg

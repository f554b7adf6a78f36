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
model runs in its weights' type: at bfloat16 the UNet and the ControlNet
see bfloat16 noisy latents and a bfloat16 time embedding, and compute in
bfloat16. The JAX package does not: its float32 schedule promotes the
noised latents to float32 (``add_noise``), its float32 time embedding stays
float32 through the bf16 ``Dense`` layers, and Flax promotes every layer to
float32 from there. ``jax_promotion=True`` copies that (the noised latents
stay float32, the eps stack runs under ``layers.jax_promotion``); the
default keeps bfloat16, the card's path, a difference by design whose gap
``tests/test_torch_bf16_guidance.py`` measures and bounds.

The pixel-gradient hooks (``make_pgc``, ``make_rgb_grad_hook``,
``make_pgc_suppress``, ``build_pixel_grad_hook``) are identity functions on
the rendered image whose backward clips, normalizes or suppresses its
gradient, as ``torch.autograd.Function``s.

``sample_images`` walks a DDIM grid from pure noise through the same eps
stack and decodes the latents: the ``--log.check_sd`` samples.

Not ported yet: the csd / nfsd / ism / custom families, the denoise modes
(z0, x0) and 4-channel latent renders (``latent_input``); asking for a
family that is not ported raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from . import layers
from .time_prior import DiffusionSchedule, make_schedule

#: the loss families ported so far
LOSS_TYPES = ("sds", "sjc", "sjc-red")


def resize_images(images: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) as ``jax.image.resize(...,
    'bilinear')`` resizes: half-pixel centres, antialiased when it
    shrinks. Computed in float32 (the CPU has no bfloat16 antialiased
    resize) and returned in the input's type."""
    return F.interpolate(
        images.permute(0, 3, 1, 2).float(), size=(height, width),
        mode="bilinear", align_corners=False,
        antialias=True).permute(0, 2, 3, 1).to(images.dtype)


class GuidanceParams(NamedTuple):
    """The frozen guidance models."""

    unet: nn.Module
    vae: nn.Module
    controlnet: Optional[nn.Module] = None


@dataclass
class ScoreDistillation:
    """Static guidance settings + the loss computation."""

    # on the device of the models it serves; None: the SD1.5 schedule on
    # the card
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
    # False keeps a render whose size the UNet takes natively (the VAE's
    # input size, or a square 768) instead of resizing it
    input_interpolate: bool = True
    # the JAX package's types in the eps stack (module docstring)
    jax_promotion: bool = False

    def __post_init__(self):
        if self.loss_type not in LOSS_TYPES:
            raise NotImplementedError(
                f"loss_type {self.loss_type!r} is not ported; ported: "
                f"{LOSS_TYPES}")
        if self.schedule is None:
            self.schedule = make_schedule()

    def encode_images(self, params: GuidanceParams, images: torch.Tensor
                      ) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, h, w, 4) latents, with the graph
        kept. A render of another size than the VAE's input
        (``latent_size`` x the VAE's downsampling factor) is resized to it
        first, bilinearly and antialiased when it shrinks, as
        ``jax.image.resize`` does; with ``input_interpolate=False`` a
        square 768 render is kept and encodes to 96^2 latents."""
        B, H, W, _ = images.shape
        target = self.latent_size * 2 ** (
            len(params.vae.cfg.block_out_channels) - 1)
        if (H != target or W != target) and (
                self.input_interpolate or H != W or H not in (target, 768)):
            images = resize_images(images, target, target)
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
            ac = self.schedule.alphas_cumprod[t]
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

    @torch.no_grad()
    def sample_images(self, params: GuidanceParams, text_embeds,
                      uncond_embeds,
                      generator: Optional[torch.Generator] = None,
                      num_inference_steps: int = 50, guidance_scale=None,
                      cond_image=None, noise: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Text -> image DDIM sampling from pure noise (the ``--log.check_sd``
        export): ``num_inference_steps`` strides of ``T // steps`` from
        ``T - stride`` down, each a CFG eps (through the ControlNet when
        ``cond_image`` and a ControlNet are given) and ``schedule.ddim_step``
        (alpha-bar 1 past t = 0, where a stride does not divide T), the
        carry cast back to the embeddings' type each step; then the VAE
        decode of the float32 latents. The noise (B, h, w, 4) is ``noise``
        or a standard normal draw from ``generator``. Returns (B, H, W, 3)
        images in [0, 1]."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        dt = text_embeds.dtype
        dev = text_embeds.device
        B = text_embeds.shape[0]
        T = self.schedule.num_train_timesteps
        stride = T // num_inference_steps
        shape = (B, self.latent_size, self.latent_size, 4)
        if noise is None:
            if generator is None:
                raise ValueError("pass noise= or generator=")
            noise = torch.randn(shape, generator=generator, device=dev,
                                dtype=dt)
        x = noise.to(dev, dt)
        for i in range(num_inference_steps):
            t_cur = torch.full((B,), T - stride - i * stride,
                               dtype=torch.long, device=dev)
            with layers.jax_promotion(self.jax_promotion):
                eps, _, _ = self._cfg_eps(params, x, t_cur, text_embeds,
                                          uncond_embeds, cond_image, gs)
            x = self.schedule.ddim_step(x.float(), eps.float(), t_cur,
                                        t_cur - stride).to(dt)
        return params.vae.decode(x.float())

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        ac = self.schedule.alphas_cumprod[t]
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
        latents_noisy = self.schedule.add_noise(lat_sg.float(), noise.float(), t)
        if not self.jax_promotion:
            latents_noisy = latents_noisy.to(dt)

        with layers.jax_promotion(self.jax_promotion):
            eps_hat, _, eps_text = self._cfg_eps(
                params, latents_noisy, t, text_embeds, uncond_embeds,
                cond_image, gs)
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


# ---------------------------------------------------------------------------
# Pixel gradient clipping (PGC): identity forward, reshaped backward
# ---------------------------------------------------------------------------

class _GradHook(torch.autograd.Function):
    """Identity on ``x``; the backward passes the gradient through
    ``bwd(g)`` (and gives the mask, when there is one, no gradient)."""

    @staticmethod
    def forward(ctx, bwd, x, mask=None):
        ctx.bwd = bwd
        ctx.has_mask = mask is not None
        if ctx.has_mask:
            ctx.save_for_backward(mask)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.has_mask:
            (mask,) = ctx.saved_tensors
            return None, ctx.bwd(mask, g), torch.zeros_like(mask)
        return None, ctx.bwd(g), None


def make_pgc(clip_value: float = 0.1, mode: str = "clip"):
    """Identity forward; the backward clips or normalizes per-pixel RGB
    gradients. ``mode``: 'clip', 'std_clip' or 'normalize'."""
    if mode not in ("clip", "std_clip", "normalize"):
        raise NotImplementedError(mode)

    def bwd(g):
        if mode == "clip":
            return torch.clamp(g, -clip_value, clip_value)
        if mode == "std_clip":
            std = torch.std(g, correction=0) * clip_value
            return torch.minimum(torch.maximum(g, -std), std)
        n = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        return g / torch.clamp(n, min=1e-8) * clip_value

    return lambda x: _GradHook.apply(bwd, x)


def make_rgb_grad_hook(grad_clip: bool, grad_norm: bool,
                       grad_clip_scale: float = 3.0,
                       with_mask: bool = False):
    """RMS-std clip, then global L2 normalization, of the rendered image's
    gradient.

    ``with_mask``: the hook takes a second (H, W, 1) mask argument (the
    render's accumulated weights); the gradient is masked before the std
    statistic, which runs over the mask > 0.5 pixels only, so a soft mask's
    small background entries do not deflate the threshold. The returned
    callable then carries ``wants_mask = True`` so that its caller knows to
    pass the mask."""

    def finish(out):
        if grad_norm:
            n = torch.sqrt(torch.sum(out * out))
            out = out / torch.clamp(n, min=1e-8)
        return out

    if with_mask:
        def bwd_m(mask, g):
            out = g
            if grad_clip:
                gz = torch.nan_to_num(out * mask)
                sel = (mask > 0.5).expand_as(gz)
                sq = torch.where(sel, gz * gz, torch.zeros_like(gz))
                nz = torch.clamp(torch.sum(sel & (gz != 0)), min=1)
                std = torch.sqrt(torch.sum(sq) / nz) * grad_clip_scale
                out = torch.nan_to_num(
                    torch.minimum(torch.maximum(gz, -std), std))
            return finish(out)

        def hook_m(x, mask):
            return _GradHook.apply(bwd_m, x, mask)

        hook_m.wants_mask = True
        return hook_m

    def bwd(g):
        out = g
        if grad_clip:
            gz = torch.nan_to_num(out)
            nz = torch.clamp(torch.sum(gz.abs() > 0), min=1)
            std = torch.sqrt(torch.sum(gz * gz) / nz) * grad_clip_scale
            out = torch.nan_to_num(
                torch.minimum(torch.maximum(out, -std), std))
        return finish(out)

    return lambda x: _GradHook.apply(bwd, x)


def make_pgc_suppress(clip_value: float, suppress_type: int = 0):
    """The numbered PGC suppress family (channel dimension last):
    0 pixel-wise clip, 1 clip, 2 global scale, 3 sigmoid, 4 PNGD,
    5 pixel-max PNGD, any other number: identity."""
    c = clip_value

    def bwd(g):
        if suppress_type == 0:
            ratio = torch.clamp(c / torch.clamp(g.abs(), min=1e-20), max=1.0)
            return g * ratio.min(dim=-1, keepdim=True).values
        if suppress_type == 1:
            return torch.clamp(g, -c, c)
        if suppress_type == 2:
            return g / torch.clamp(g.abs().max(), min=1e-20) * c
        if suppress_type == 3:
            return (torch.sigmoid(g) - 0.5) * c
        if suppress_type == 4:
            return c * g / (g.abs() + c)
        if suppress_type == 5:
            n = g.abs().max(dim=-1, keepdim=True).values
            return c * g / (n + c)
        return g

    return lambda x: _GradHook.apply(bwd, x)


def build_pixel_grad_hook(guide_cfg):
    """The image-gradient hook a config selects, or None: the PGC suppress
    family when ``pgc_clip_rgb >= 0``, else the clip / norm hook when
    either is on."""
    if getattr(guide_cfg, "pgc_clip_rgb", -1.0) is not None \
            and guide_cfg.pgc_clip_rgb >= 0:
        return make_pgc_suppress(guide_cfg.pgc_clip_rgb,
                                 guide_cfg.pgc_suppress_type)
    if guide_cfg.grad_rgb_clip or guide_cfg.grad_rgb_norm:
        return make_rgb_grad_hook(
            guide_cfg.grad_rgb_clip,
            guide_cfg.grad_rgb_norm,
            guide_cfg.grad_rgb_clip_scale,
            with_mask=getattr(guide_cfg, "grad_rgb_clip_mask_guidance",
                              False))
    return None

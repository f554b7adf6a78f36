"""Score Distillation Sampling.

Port of ``dreamwaltz_g_tpu/guidance/sds.py``: render -> VAE encode
(gradients flow) -> add noise at timestep t -> frozen UNet (+ ControlNet)
eps prediction with classifier-free guidance -> a loss family's gradient
-> weighting -> latent guards -> ``loss = sum(latents * grad) / B``, whose
gradient with respect to the latents is ``grad / B`` (the SpecifyGradient
trick).

The families (``loss_type``):

* score families ``sds`` / ``sjc`` / ``sjc-red`` (the CFG'd score less the
  noise, or the score itself), ``custom`` (the raw condition delta),
  ``csd`` (the condition delta; with ``progress`` and ``neg_embeds`` the
  annealed three-term mix of the text, null and negative scores), ``nfsd``
  (the domain term switches at t = 200) and ``ism`` (Interval Score
  Matching: a DDIM inversion of the clean latents in ``ism_xs_delta_t``
  strides to t - delta, then one step of the annealed delta to t);
* denoise modes ``z0`` / ``z0_final`` (a latent-space loss against the
  denoised latents: one DDIM step on the ``denoise_timesteps`` grid, or
  the whole walk down it) and ``x0`` / ``x0_final`` (the same target
  decoded, a pixel-space loss: the VAE is outside the gradient's path).

The modules hold their own weights, so ``GuidanceParams`` carries the three
modules where the JAX package carries their parameter trees. The noise
comes from an explicit ``noise=`` tensor or a ``torch.Generator`` (or one
a batch element, a view's own); each
path takes the one draw it uses (the JAX functions draw the score
families' and ISM's noise from the first half of ``key``'s split, the
``z0`` target's in ``latent_gradients`` from the second, and
``__call__``'s ``z0`` / ``x0`` target's from ``key`` itself). Each model
runs in its weights' type: at bfloat16 the UNet and the ControlNet see
bfloat16 noisy latents and a bfloat16 time embedding, and compute in
bfloat16. The JAX package does not: its float32 schedule promotes the
noised latents to float32 (``add_noise``), its float32 time embedding stays
float32 through the bf16 ``Dense`` layers, and Flax promotes every layer to
float32 from there. ``jax_promotion=True`` copies that (the noised latents
stay float32, the eps stack runs under ``layers.jax_promotion``); the
default keeps bfloat16, the card's path, a difference by design whose gap
``tests/test_torch_bf16_guidance.py`` measures and bounds.

``latent_input`` (Latent-NeRF): the render's 4 channels are the latents,
resized to the latent grid and not encoded.

The pixel-gradient hooks (``make_pgc``, ``make_rgb_grad_hook``,
``make_pgc_suppress``, ``build_pixel_grad_hook``) are identity functions on
the rendered image whose backward clips, normalizes or suppresses its
gradient, as ``torch.autograd.Function``s.

``sample_images`` walks a DDIM grid from pure noise through the same eps
stack and decodes the latents: the ``--log.check_sd`` samples.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from . import layers
from .time_prior import DiffusionSchedule, make_schedule

#: the score families and the denoise modes (module docstring)
SCORE_TYPES = ("sds", "sjc", "sjc-red", "custom", "csd", "nfsd", "ism")
DENOISE_TYPES = ("z0", "z0_final", "x0", "x0_final")
LOSS_TYPES = SCORE_TYPES + DENOISE_TYPES


@functools.lru_cache(maxsize=32)
def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 weights of one axis of ``resize_images``:
    ``F.interpolate``'s own bilinear antialiased weights, read off by
    resizing the identity on the CPU; cached (read-only)."""
    eye = torch.eye(n_in, dtype=torch.float32)[:, None, None, :]
    w = F.interpolate(eye, size=(1, n_out), mode="bilinear",
                      align_corners=False, antialias=True)
    return w[:, 0, 0, :].T.contiguous().to(device)


def resize_images(images: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) as ``jax.image.resize(...,
    'bilinear')`` resizes: half-pixel centres, antialiased when it
    shrinks. Computed in float32 and returned in the input's type, as two
    products with each axis's weights (``resize_weights``), so that the
    gradient is two products too: ``F.interpolate``'s antialiased backward
    adds with atomics on the card, in no fixed order."""
    B, H, W, C = images.shape
    x = images.float()
    x = torch.matmul(resize_weights(H, height, x.device),
                     x.reshape(B, H, W * C)).reshape(B, height, W, C)
    x = torch.matmul(x.permute(0, 1, 3, 2),
                     resize_weights(W, width, x.device).T)
    return x.permute(0, 1, 3, 2).to(images.dtype)


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
    # ISM's two-phase DDIM inversion: phase 1 inverts x0 -> x_{t - delta}
    # in xs_delta_t strides, phase 2 takes one step of the annealed delta
    # to t; delta anneals delta_t_start -> delta_t over the first
    # warmup_frac of the run
    ism_delta_t: int = 80
    ism_delta_t_start: int = 100
    ism_xs_delta_t: int = 200
    ism_xs_inv_steps: int = 5
    ism_warmup_frac: float = 0.3
    denoise_timesteps: int = 50       # the z0 / x0 modes' inference grid
    prediction_type: str = "epsilon"  # or 'v_prediction'
    latent_size: int = 64
    latent_input: bool = False        # 4-channel renders are the latents
    # False keeps a render whose size the UNet takes natively (the VAE's
    # input size, or a square 768) instead of resizing it
    input_interpolate: bool = True
    # the JAX package's types in the eps stack (module docstring)
    jax_promotion: bool = False

    def __post_init__(self):
        if self.loss_type not in LOSS_TYPES:
            raise NotImplementedError(
                f"unknown loss_type {self.loss_type!r}; known: {LOSS_TYPES}")
        if self.schedule is None:
            self.schedule = make_schedule()

    @property
    def is_denoising_mode(self) -> bool:
        return self.loss_type in DENOISE_TYPES

    def encode_images(self, params: GuidanceParams, images: torch.Tensor
                      ) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, h, w, 4) latents, with the graph
        kept. A render of another size than the VAE's input
        (``latent_size`` x the VAE's downsampling factor) is resized to it
        first, bilinearly and antialiased when it shrinks, as
        ``jax.image.resize`` does; with ``input_interpolate=False`` a
        square 768 render is kept and encodes to 96^2 latents. With
        ``latent_input`` the (B, H, W, 4) render is the latents: it is only
        resized to the latent grid (kept at a square ``latent_size`` or 96
        without ``input_interpolate``)."""
        B, H, W, C = images.shape
        if self.latent_input:
            if C != 4:
                raise ValueError("latent_input expects 4-channel renders, "
                                 f"got {C}")
            ls = self.latent_size
            if (H != ls or W != ls) and (
                    self.input_interpolate or H != W or H not in (ls, 96)):
                images = resize_images(images, ls, ls)
            return images
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

    def _noise(self, like: torch.Tensor, noise, generator) -> torch.Tensor:
        """``noise`` in ``like``'s type, or a standard normal draw of its
        shape from ``generator``: one ``torch.Generator`` for the batch, or
        a sequence of one a batch element (each view's own draw)."""
        if noise is None:
            if generator is None:
                raise ValueError("pass noise= or generator=")
            if not isinstance(generator, (list, tuple)):
                noise = torch.randn(like.shape, generator=generator,
                                    device=like.device, dtype=like.dtype)
            else:
                if len(generator) != like.shape[0]:
                    raise ValueError(f"{len(generator)} generators for a "
                                     f"batch of {like.shape[0]}")
                noise = torch.cat([torch.randn(
                    (1,) + like.shape[1:], generator=g, device=like.device,
                    dtype=like.dtype) for g in generator])
        return noise.to(like.device, like.dtype)

    def _noised(self, lat_sg, noise, t):
        """q(x_t | x_0) in float32, then in the embeddings' type unless
        ``jax_promotion`` (the JAX schedule's float32 promotion)."""
        x = self.schedule.add_noise(lat_sg.float(), noise.float(), t)
        return x if self.jax_promotion else x.to(lat_sg.dtype)

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
        neg_embeds: Optional[torch.Tensor] = None,   # csd / nfsd branch
        progress=None,                 # step / max_iteration in [0, 1]
    ) -> Dict[str, torch.Tensor]:
        """Returns 'loss' (a float32 scalar: backprop this), 'gradients',
        'latents' and 'target'. ``noise`` is the one draw the family uses
        (module docstring). The x0 modes' loss is on the (resized) input
        pixels against the decoded denoised latents: the VAE's encode and
        decode run without a graph."""
        dt = text_embeds.dtype
        t = t.to(images.device).long()
        if self.loss_type in ("x0", "x0_final"):
            B = images.shape[0]
            side = self.latent_size * 2 ** (
                len(params.vae.cfg.block_out_channels) - 1)
            inputs = images.to(dt)
            if inputs.shape[1:3] != (side, side):
                inputs = resize_images(inputs, side, side)
            with torch.no_grad():
                with record_function("sds.encode_images"):
                    latents = params.vae.encode(inputs)
                with record_function("sds.denoise"):
                    lat_sg = latents.to(dt)
                    x0 = self._denoised_latents(
                        params, lat_sg, text_embeds, uncond_embeds, t,
                        self._noise(lat_sg, noise, generator), cond_image,
                        guidance_scale)
                with record_function("sds.decode"):
                    target = params.vae.decode(x0).float()
            src = inputs.float()
            loss = 0.5 * torch.sum((src - target) ** 2) / B
            return {"loss": loss, "gradients": (src - target).detach(),
                    "latents": latents, "target": target}

        with record_function("sds.encode_images"):
            latents = self.encode_images(params, images.to(dt))
        if self.loss_type in ("z0", "z0_final"):
            with torch.no_grad(), record_function("sds.denoise"):
                lat_sg = latents.detach().to(dt)
                x0 = self._denoised_latents(
                    params, lat_sg, text_embeds, uncond_embeds, t,
                    self._noise(lat_sg, noise, generator), cond_image,
                    guidance_scale)
            target = x0.float()
            src = latents.float()
            loss = 0.5 * torch.sum((src - target) ** 2) / latents.shape[0]
            return {"loss": loss, "gradients": (src - target).detach(),
                    "latents": latents, "target": target}

        with record_function("sds.latent_gradients"):
            grad = self.latent_gradients(
                params, latents.detach(), text_embeds, uncond_embeds, t,
                noise=noise, cond_image=cond_image,
                guidance_scale=guidance_scale, generator=generator,
                neg_embeds=neg_embeds, progress=progress)
        loss = torch.sum(latents.float() * grad) / latents.shape[0]
        return {"loss": loss, "gradients": grad, "latents": latents,
                "target": latents.detach().float() - grad}

    @torch.no_grad()
    def _denoised_latents(self, params, lat_sg, text_embeds, uncond_embeds,
                          t, noise, cond_image, guidance_scale):
        """The denoise modes' target (float32): noise to t, a CFG eps at t
        snapped down to the ``denoise_timesteps`` grid, one DDIM step to
        the predicted x0; the ``*_final`` modes instead walk the rest of
        the grid down to t = 0 (masked, for each element, to the steps
        below its t). A grid step that no element of the batch takes is
        skipped: the JAX loop runs it and keeps every element as it was."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        latents_noisy = self._noised(lat_sg, noise, t)
        T = self.schedule.num_train_timesteps
        stride = T // self.denoise_timesteps
        t_grid = torch.div(t, stride, rounding_mode="floor") * stride
        with layers.jax_promotion(self.jax_promotion):
            eps_hat, _, _ = self._cfg_eps(
                params, latents_noisy, t_grid, text_embeds, uncond_embeds,
                cond_image, gs)
        x_t = latents_noisy.float()
        if not self.loss_type.endswith("_final"):
            return self.schedule.pred_x0_from_eps(x_t, eps_hat.float(),
                                                  t_grid)
        x = self.schedule.ddim_step(x_t, eps_hat.float(), t_grid,
                                    t_grid - stride)
        top = int(t_grid.max())
        for i in range(self.denoise_timesteps):
            cur = T - stride - i * stride    # T - s, T - 2s, ..., 0
            if cur >= top:
                continue
            cur_b = torch.full_like(t_grid, cur)
            with layers.jax_promotion(self.jax_promotion):
                eps, _, _ = self._cfg_eps(
                    params, self._model_in(x, text_embeds.dtype), cur_b,
                    text_embeds, uncond_embeds, cond_image, gs)
            x_next = self.schedule.ddim_step(x, eps.float(), cur_b,
                                             cur_b - stride)
            take = (cur_b < t_grid).reshape((-1,) + (1,) * (x.ndim - 1))
            x = torch.where(take, x_next, x)
        return x

    def _model_in(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """A float32 DDIM carry as the eps stack's input: in the
        embeddings' type unless ``jax_promotion``."""
        return x if self.jax_promotion else x.to(dt)

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
        neg_embeds: Optional[torch.Tensor] = None,
        progress=None,
    ) -> torch.Tensor:
        """The frozen forward-only half of SDS: eps predictions -> weighted,
        guarded latent gradient (float32). The noise is ``noise`` or, when
        that is None, a standard normal draw from ``generator``: the score
        families' (and ISM's) noise, or the ``z0`` modes' target noise.
        ``progress`` (step / max_iteration) drives csd's annealed mix and
        ISM's delta warm-up; ``neg_embeds`` is the negative prompt's
        branch of csd and nfsd. The x0 modes are pixel-space: use
        ``__call__``."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        dt = text_embeds.dtype
        lat_sg = lat_sg.to(dt)
        noise = self._noise(lat_sg, noise, generator)
        t = t.to(lat_sg.device).long()
        lt = self.loss_type
        if lt in ("x0", "x0_final"):
            raise ValueError("the x0 modes are pixel-space: use __call__, "
                             "not latent_gradients")
        if lt in ("z0", "z0_final"):
            x0 = self._denoised_latents(params, lat_sg, text_embeds,
                                        uncond_embeds, t, noise, cond_image,
                                        gs)
            return lat_sg.float() - x0

        def eps1(x, tt, ctx):
            with layers.jax_promotion(self.jax_promotion):
                return self._eps(params, self._model_in(x, dt), tt, ctx,
                                 cond_image)

        def cfg(x, tt):
            with layers.jax_promotion(self.jax_promotion):
                return self._cfg_eps(params, self._model_in(x, dt), tt,
                                     text_embeds, uncond_embeds, cond_image,
                                     gs)

        if lt == "ism":
            grad = self._ism(lat_sg, noise, t, progress, eps1, cfg,
                             uncond_embeds)
        else:
            latents_noisy = self._noised(lat_sg, noise, t)
            eps_hat, eps_uncond, eps_text = cfg(latents_noisy, t)
            if lt in ("sds", "sjc", "sjc-red"):
                if self.guidance_rescale > 0.0:
                    eps_hat = _rescale_noise_cfg(eps_hat, eps_text,
                                                 self.guidance_rescale)
                # sjc-red keeps the full CFG'd score as the gradient
                grad = eps_hat if lt == "sjc-red" else eps_hat - noise
            elif lt == "custom":
                # the raw condition delta, no CFG scale
                grad = eps_text - eps_uncond
                if self.guidance_rescale > 0.0:
                    grad = _rescale_noise_cfg(grad, eps_text,
                                              self.guidance_rescale)
            elif lt == "csd":
                if progress is None or neg_embeds is None:
                    grad = eps_text - eps_uncond
                else:
                    eps_neg = eps1(latents_noisy, t, neg_embeds)
                    # progress in the compute type, as the JAX package
                    p = torch.tensor(float(progress), dtype=dt)
                    a, b = float(-0.5 * p), float(-1.0 + 0.5 * p)
                    grad = eps_text + a * eps_uncond + b * eps_neg
            else:   # nfsd
                if neg_embeds is None:
                    raise ValueError("nfsd needs neg_embeds")
                eps_neg = eps1(latents_noisy, t, neg_embeds)
                late = (t >= 200).reshape(-1, 1, 1, 1)
                delta = torch.where(late, eps_uncond - eps_neg, eps_uncond)
                grad = delta + gs * (eps_text - eps_uncond)
        grad = grad.float() * self._weight(t)

        # latent-gradient guards
        if self.grad_latent_clip:
            # each batch element's own statistic: a batch of views clips
            # as the JAX package's per-view calls do
            g = torch.nan_to_num(grad)
            axes = tuple(range(1, g.ndim))
            nz = torch.clamp(torch.sum(g.abs() > 0, dim=axes, keepdim=True),
                             min=1)
            std = torch.sqrt(torch.sum(g * g, dim=axes, keepdim=True) / nz) \
                * self.grad_latent_clip_scale
            grad = torch.nan_to_num(torch.minimum(torch.maximum(grad, -std),
                                                  std))
        if self.grad_latent_norm:
            g = torch.nan_to_num(grad)
            n = torch.sqrt(torch.sum(g * g, dim=(1, 2, 3), keepdim=True))
            grad = g / torch.clamp(n, min=1e-8)
        if self.grad_latent_nan_to_num:
            grad = torch.nan_to_num(grad)
        return grad.float()

    def _ism(self, lat_sg, noise, t, progress, eps1, cfg, uncond_embeds):
        """Interval Score Matching's gradient: phase 1 noises the clean
        latents to ``start`` and DDIM-inverts them with the null branch in
        ``ism_xs_delta_t`` strides up to t_prev = t - delta (the strides
        past t_prev recompose x unchanged, as the JAX loop's do); phase 2
        takes one inversion step to t; grad = eps_cfg(x_t, t) -
        eps_uncond(x_{t_prev}, t_prev). delta anneals from
        ``ism_delta_t_start`` to ``ism_delta_t`` over the first
        ``ism_warmup_frac`` of the run (``progress``), computed in float32
        as the JAX package does."""
        p = torch.tensor(0.0 if progress is None else float(progress),
                         dtype=torch.float32)
        rate = 1.0 - torch.clamp(p / self.ism_warmup_frac, max=1.0)
        cur_delta = int(self.ism_delta_t + torch.ceil(
            rate * (self.ism_delta_t_start - self.ism_delta_t)))
        t_prev = torch.clamp(t - cur_delta, min=0)
        cur = torch.clamp(
            t_prev - self.ism_xs_delta_t * self.ism_xs_inv_steps, min=0)
        x = self.schedule.add_noise(lat_sg.float(), noise.float(), cur)
        for _ in range(self.ism_xs_inv_steps):
            eps_u = eps1(x, cur, uncond_embeds)
            nxt = torch.minimum(cur + self.ism_xs_delta_t, t_prev)
            x = self.schedule.ddim_step(x, eps_u.float(), cur, nxt)
            cur = nxt
        eps_prev = eps1(x, t_prev, uncond_embeds)
        xs_t = self.schedule.ddim_step(x, eps_prev.float(), t_prev, t)
        eps_hat, _, _ = cfg(xs_t, t)
        return eps_hat - eps_prev


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

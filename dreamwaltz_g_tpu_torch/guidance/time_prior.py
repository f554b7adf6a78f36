"""The diffusion noise schedule.

Port of ``DiffusionSchedule`` and ``make_schedule`` from
``dreamwaltz_g_tpu/guidance/time_prior.py``. The host-side timestep priors
(``TimePrioritizedScheduler``) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _expand(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    while a.ndim < like.ndim:
        a = a[..., None]
    return a


class DiffusionSchedule(NamedTuple):
    """DDPM schedule arrays (float32)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sigmas: torch.Tensor  # sqrt((1 - ac) / ac)

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*[x.to(device) for x in self])

    def add_noise(self, x0, noise, t):
        """q(x_t | x_0); t (B,) broadcasts over the batch dim."""
        ac = _expand(self.alphas_cumprod[t], x0)
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * noise

    def pred_x0_from_eps(self, x_t, eps, t):
        ac = _expand(self.alphas_cumprod[t], x_t)
        return (x_t - torch.sqrt(1.0 - ac) * eps) / torch.sqrt(ac)

    def ddim_step(self, x_t, eps, t, t_next):
        """Deterministic DDIM transition t -> t_next."""
        ac_t = _expand(self.alphas_cumprod[t], x_t)
        ac_n = torch.where(t_next >= 0,
                           self.alphas_cumprod[torch.clamp(t_next, min=0)],
                           torch.ones_like(self.alphas_cumprod[t]))
        ac_n = _expand(ac_n, x_t)
        x0 = (x_t - torch.sqrt(1 - ac_t) * eps) / torch.sqrt(ac_t)
        return torch.sqrt(ac_n) * x0 + torch.sqrt(1 - ac_n) * eps


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    device="cpu",
) -> DiffusionSchedule:
    """The SD1.5 'scaled_linear' schedule (diffusers' DDPMScheduler config),
    computed in float64 with numpy and stored as float32."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(beta_schedule)
    ac = np.cumprod(1.0 - betas)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(betas=t(betas), alphas_cumprod=t(ac),
                             sigmas=t(np.sqrt((1 - ac) / ac)))

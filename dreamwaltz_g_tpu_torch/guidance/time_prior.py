"""Timestep scheduling: the diffusion noise schedule and the DreamTime-style
timestep priors.

Port of ``dreamwaltz_g_tpu/guidance/time_prior.py``: the schedule's arrays
are torch tensors; timestep selection (``C``, ``PriorFunction``,
``WindowedAnnealing``, ``TimePrioritizedScheduler``) is host-side numpy,
copied so that the same seed and config give the same integers as the JAX
package; ``TimePrioritizedLR`` gives the 'ddpm' lr policy's per-timestep
weights; ``draw_curves`` plots the timestep schedule (matplotlib, imported
when it is called).
"""
from __future__ import annotations

import bisect
from functools import partial
from numbers import Number
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device


def C(value, current_step: int, max_iteration: Optional[int] = None) -> float:
    """Scalar-or-schedule: number, or (start_step, v0, v1, end_step)
    (3-tuples imply start_step 0; float steps scale by max_iteration)."""
    if isinstance(value, Number):
        return float(value)
    if not isinstance(value, Iterable):
        raise TypeError(
            f"scalar spec must be Number or Iterable, got {type(value)}")
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    start_step, v0, v1, end_step = value
    if max_iteration is not None and isinstance(start_step, float) \
            and isinstance(end_step, float):
        start_step = int(max_iteration * start_step)
        end_step = int(max_iteration * end_step)
    r = (current_step - start_step) / max(end_step - start_step, 1)
    r = min(max(r, 0.0), 1.0)
    return v0 + (v1 - v0) * r


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
    device="cuda",
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
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(betas=t(betas), alphas_cumprod=t(ac),
                             sigmas=t(np.sqrt((1 - ac) / ac)))


# ---------------------------------------------------------------------------
# DreamTime priors (host-side numpy)
# ---------------------------------------------------------------------------

class PriorFunction:
    """Iteration -> timestep mapping from a normalized weight prior."""

    WEIGHT_PRIORS = ("uniform", "normal", "ddpm", "p2")

    def __init__(self, weight_prior: str, annealing_args, t_min: int,
                 t_max: int, schedule: DiffusionSchedule,
                 num_train_timesteps: int = 1000):
        self.t_min, self.t_max = t_min, t_max
        self.T = num_train_timesteps
        ac = schedule.alphas_cumprod.cpu().numpy()
        betas = schedule.betas.cpu().numpy()
        basic = {
            "uniform": lambda: np.ones(self.T),
            "normal": partial(self._normal, annealing_args),
            "ddpm": lambda: np.sqrt((1 - ac) / ac),
            "p2": lambda: ((1 - betas) * (1 - ac) / betas)
            / (1.0 + (1.0 / (1 - ac) - 1.0)) ** 1.0,
        }
        if weight_prior.startswith("dreamtime"):
            parts = weight_prior.split("-")
            base = parts[1] if len(parts) > 1 else "ddpm"
            w = basic[base]() * basic["normal"]()
        else:
            w = basic[weight_prior]()
        w = w[t_min: t_max + 1]
        w = w / w.sum()
        self.weights = w
        self.weights_cumsum = np.cumsum(w[::-1])

    def _normal(self, args):
        if args and len(args) >= 2:
            m1, s1 = float(args[0]), float(args[1])
            m2, s2 = (float(args[2]), float(args[3])) if len(args) >= 4 \
                else (m1, s1)
        else:
            # DreamTime defaults
            m1, s1, m2, s2 = 800.0, 300.0, 500.0, 100.0
        t = np.arange(self.T, dtype=np.float64)
        w = np.ones(self.T)
        hi = t > m1
        lo = t < m2
        w[hi] = np.exp(-((t[hi] - m1) ** 2) / (2 * s1 ** 2))
        w[lo] = np.exp(-((t[lo] - m2) ** 2) / (2 * s2 ** 2))
        return w

    def __call__(self, train_step: int, max_iteration: int) -> int:
        d = bisect.bisect_left(self.weights_cumsum, train_step / max_iteration)
        return max(self.t_max - d, self.t_min)


class WindowedAnnealing:
    """Annealed timestep with optional sampling window."""

    def __init__(self, time_annealing: str, time_annealing_window: str,
                 t_min: int, t_max: int, schedule: DiffusionSchedule,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng(0)
        self.t_min, self.t_max = t_min, t_max
        self.annealing_type, *a_args = time_annealing.split(",")
        self.window_type, *w_args = time_annealing_window.split(",")
        self.window_direction = w_args[0] if w_args else "middle"
        self.window_size = int(w_args[1]) if len(w_args) == 2 else None

        if self.annealing_type in PriorFunction.WEIGHT_PRIORS \
                or self.annealing_type.startswith("dreamtime"):
            self.annealing = PriorFunction(self.annealing_type, a_args,
                                           t_min, t_max, schedule)
        else:
            p = {"linear": 1.0, "hifa": 0.5}.get(self.annealing_type)
            if len(a_args) >= 2:
                t_begin, t_end = int(a_args[0]), int(a_args[1])
                if len(a_args) == 3:
                    p = float(a_args[2])
            else:
                t_begin, t_end = t_max, t_min
            assert t_begin >= t_end and p is not None

            def annealing(i, max_iter, _b=t_begin, _e=t_end, _p=p):
                return int(_b - (_b - _e) * (i / max_iter) ** _p)

            self.annealing = annealing

    def _window(self, t: int) -> int:
        tmin, tmax, ws = self.t_min, self.t_max, self.window_size
        adaptive = ws is None
        d = self.window_direction
        if self.window_type == "impluse":  # (sic, the config's spelling)
            return t
        if self.window_type == "square":
            if d == "lower":
                lo = tmin if adaptive else max(tmin, t - ws)
                return int(self.rng.integers(lo, t + 1))
            if d == "upper":
                hi = tmax if adaptive else min(tmax, t + ws)
                return int(self.rng.integers(t, hi + 1))
            if d == "middle":
                if adaptive:
                    w = min(tmax - t, t - tmin)
                    return int(self.rng.integers(t - w, t + w + 1))
                return int(self.rng.integers(max(tmin, t - ws // 2),
                                             min(tmax, t + ws // 2) + 1))
            if d == "tail":
                hi = tmin + ws
                return int(self.rng.integers(tmin, hi + 1)) if t < hi else t
            raise ValueError(d)
        if self.window_type == "normal":
            if d == "middle":
                mean, sigma = t, min(tmax - t, t - tmin) / 6
            elif d == "lower":
                mean = (tmin + t) / 2 if adaptive else t - ws / 2
                sigma = (t - tmin) / 6
            elif d == "upper":
                mean = (tmax + t) / 2 if adaptive else t + ws / 2
                sigma = (tmax - t) / 6
            elif d == "tail":
                # below the window the draw spreads over [tmin, tmin+ws];
                # at or above it the mean is t itself, and the
                # non-adaptive sigma = ws/6 override below still applies,
                # so the draw is Normal(t, ws/6), not deterministic
                assert ws is not None, "normal,tail needs a window size"
                if t >= ws:
                    mean, sigma = t, 0.0
                else:
                    hi = tmin + ws
                    mean, sigma = (tmin + hi) / 2, (hi - tmin) / 6
            else:
                raise ValueError(d)
            if not adaptive:
                sigma = ws / 6
            for _ in range(100):
                s = int(self.rng.normal(mean, max(sigma, 1e-6)))
                if tmin <= s <= tmax:
                    return s
            return int(np.clip(mean, tmin, tmax))
        raise ValueError(self.window_type)

    def __call__(self, train_step, max_iteration, use_window=True) -> int:
        t = self.annealing(train_step, max_iteration)
        return self._window(t) if use_window else t


class TimePrioritizedScheduler:
    """Timestep and guidance-scale provider of the training loop."""

    def __init__(self, guide_cfg, schedule: Optional[DiffusionSchedule] = None,
                 num_train_timesteps: int = 1000, seed: int = 0,
                 device="cuda"):
        self.cfg = guide_cfg
        self.schedule = schedule or make_schedule(num_train_timesteps,
                                                  device=device)
        self.T = num_train_timesteps
        self.rng = np.random.default_rng(seed)
        self.time_sampling = guide_cfg.time_sampling
        self.num_stage = 2
        if self.time_sampling.startswith("stage"):
            parts = self.time_sampling.split("-")
            self.time_sampling = "stage"
            if len(parts) > 1:
                self.num_stage = int(parts[1])
        self._annealing_cache = None

    def min_step(self, train_step, max_iteration) -> int:
        return int(self.T * C(self.cfg.min_timestep, train_step,
                              max_iteration))

    def max_step(self, train_step, max_iteration) -> int:
        return int(self.T * C(self.cfg.max_timestep, train_step,
                              max_iteration))

    def _annealing(self, t_min, t_max) -> WindowedAnnealing:
        key = (t_min, t_max)
        if self._annealing_cache is None or self._annealing_cache[0] != key:
            wa = WindowedAnnealing(self.cfg.time_annealing,
                                   self.cfg.time_annealing_window,
                                   t_min, t_max, self.schedule, self.rng)
            self._annealing_cache = (key, wa)
        return self._annealing_cache[1]

    def get_timestep(self, batch_size: int, train_step: int,
                     max_iteration: int) -> np.ndarray:
        lo = self.min_step(train_step, max_iteration)
        hi = self.max_step(train_step, max_iteration)
        mode = self.time_sampling
        if mode == "uniform":
            t = self.rng.integers(lo, hi + 1, size=batch_size)
        elif mode == "constant":
            t = np.full(batch_size, (lo + hi) // 2)
        elif mode == "linear":
            delta = (hi - lo) / max(max_iteration - 1, 1)
            t = np.full(batch_size, int(hi - max(train_step - 1, 0) * delta))
        elif mode == "stage":
            per = (hi - lo) // self.num_stage
            iters_per = max_iteration // self.num_stage
            i_stage = min(train_step // max(iters_per, 1), self.num_stage - 1)
            # stages walk from high noise to low
            s_hi = lo + per * (self.num_stage - i_stage)
            t = self.rng.integers(lo, s_hi + 1, size=batch_size)
        elif mode == "annealed":
            wa = self._annealing(lo, hi)
            t = np.asarray([wa(train_step, max_iteration)
                            for _ in range(batch_size)])
        else:
            raise NotImplementedError(mode)
        return np.clip(t.astype(np.int32), 0, self.T - 1)

    def get_ism_timestep(self, batch_size: int, train_step: int,
                         max_iteration: int, min_step: int = 20,
                         max_step: int = 500, warmup_step: int = 480,
                         warmup_frac: float = 0.3) -> np.ndarray:
        """ISM's expanded-window uniform draw: t ~ U[min_step, max_step +
        warmup_step * warm_up_rate); the window shrinks from [20, 980) to
        [20, 500) over the first ``warmup_frac`` of training."""
        warmup_iter = max(int(max_iteration * warmup_frac), 1)
        warm_up_rate = 1.0 - min(train_step / warmup_iter, 1.0)
        hi = max_step + int(warmup_step * warm_up_rate)
        return self.rng.integers(min_step, hi,
                                 size=batch_size).astype(np.int32)

    def get_guidance_scale(self, train_step: int, max_iteration: int) -> float:
        """linear walks initial -> 7.5, linear_reverse 7.5 -> initial,
        uniform ~ U[7.5, gs]."""
        base = self.cfg.guidance_scale
        adjust = self.cfg.guidance_adjust
        if adjust == "constant":
            return float(base)
        if adjust == "uniform":
            return float(self.rng.uniform(min(7.5, base), base))
        delta = (base - 7.5) / max(max_iteration - 1, 1)
        if adjust == "linear":
            return float(base - (train_step - 1) * delta)
        if adjust == "linear_reverse":
            return float(7.5 + (train_step - 1) * delta)
        if adjust == "anneal":
            r = train_step / max(max_iteration, 1)
            return float(base * (1.0 - 0.5 * r))
        raise NotImplementedError(adjust)


class TimePrioritizedLR:
    """Timestep-dependent learning-rate weight, the 'ddpm' lr policy's:
    ``w(t) = sqrt((1 - ac_t) / ac_t) / max`` over the schedule (numpy);
    the stage-1 step multiplies its updates by ``weights[t]``
    (``tp_lr_weights``)."""

    def __init__(self, schedule: DiffusionSchedule):
        ac = schedule.alphas_cumprod.detach().cpu().numpy()   # float32
        w = np.sqrt((1 - ac) / ac)
        self.weights = w / w.max()

    def __call__(self, timestep) -> float:
        t = int(np.clip(int(timestep), 0, len(self.weights) - 1))
        return float(self.weights[t])


def draw_curves(tp_scheduler: TimePrioritizedScheduler, max_iteration: int,
                path: str, batch_probe: int = 1) -> str:
    """Plot the timestep-annealing curve over training: the mean of
    ``get_timestep`` at 200 steps (drawn from the scheduler's generator,
    as the JAX package draws). Saves a PNG and returns the path. Raises
    ``ImportError``, before any draw, when matplotlib is absent."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = np.linspace(1, max_iteration, 200).astype(int)
    ts = [tp_scheduler.get_timestep(batch_probe, int(s), max_iteration).mean()
          for s in steps]
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(steps, ts, lw=1.5)
    ax.set_xlabel("train step")
    ax.set_ylabel("sampled timestep t")
    ax.set_title(f"{tp_scheduler.time_sampling} timestep schedule")
    ax.set_ylim(0, tp_scheduler.T)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path

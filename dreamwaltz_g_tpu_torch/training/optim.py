"""Optimizers: the stage-2 avatar's Adam over per-attribute groups, and the
stage-1 NeRF's Adam / AdamW / Adan over its encoder, MLP and background
groups.

Port of ``dreamwaltz_g_tpu/training/optim.py`` but for
``build_gaussian_optimizer``. The JAX package partitions a parameter tree
into labelled groups with ``optax.multi_transform``.

* Stage 2: ``build_avatar_optimizer`` returns the labels with their
  learning rates, and ``AvatarOptimizer.init`` builds one
  ``torch.optim.Adam`` over the groups of an avatar's tensors and network
  weights. A group frozen by the config is left out: its tensors get no
  update at all.
* Stage 1: ``build_nerf_optimizer`` returns a ``NeRFOptimizer`` of one
  update rule a group (``adam`` / ``adamw`` as optax computes them,
  ``adan`` as the JAX package's transform does), optionally behind a
  ``global_norm_scale`` over every group; ``NeRFOptimizer.init(model)``
  labels the model's named parameters. The rules compute each update
  explicitly, in optax's order: AdamW's decay enters the same update,
  ``-lr (adam + wd p)``, and a parameter without a gradient takes a zero
  one, as optax's does (its moments decay, its count advances).

As in optax, an Adam learning-rate schedule is read at the update count
before the increment, so the first update uses ``schedule(0)``; the Adan
transform reads its schedule at the incremented count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs import RenderConfig

Schedule = Union[float, Callable[[int], float]]


def expon_lr(lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
             ) -> Callable[[int], float]:
    """3DGS log-lerp learning rate with an optional delayed warmup. A run
    of 0 steps (``--optim.iters 0``: construction only) never takes a rate;
    its schedule is read as a 1-step one's."""

    def schedule(step) -> float:
        t = min(max(float(step) / max(max_steps, 1), 0.0), 1.0)
        log_lerp = math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                            + math.log(max(lr_final, 1e-30)) * t)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(float(step) / lr_delay_steps, 0.0),
                                    1.0))
        else:
            delay = 1.0
        return delay * log_lerp

    return schedule


def avatar_param_groups(params, model) -> Dict[str, List[torch.Tensor]]:
    """The optimizer label of every avatar tensor and network weight, as
    the JAX package's ``label_fn`` assigns them: {label: [tensors]}."""
    groups: Dict[str, List[torch.Tensor]] = {}

    def add(label, tensors):
        groups.setdefault(label, []).extend(tensors)

    add("pos", [params.positions])
    add("scale", [params.log_scales])
    add("quat", [params.quats])
    add("lbs", [params.lbs_weights])
    add("nerf", list(params.encoder) + list(model.color_mlp.parameters()))
    add("deform", list(model.sq_net.parameters()))
    for mp in params.mesh.values():
        add("mesh_bary", [mp.bary_coords])
        add("mesh_vertex", [mp.vertex_coords])
        add("mesh_scale", [mp.scales])
    add("betas", [params.extra_betas])
    for k, v in params.smpl_learn.items():
        add("smpl_vt" if k == "v_template" else "smpl_tpl", [v])
    return groups


@dataclass
class AvatarOptState:
    """One Adam over the trainable groups, and the update count."""

    adam: torch.optim.Adam
    schedules: List[Schedule]
    count: int = 0

    def step(self) -> None:
        for group, lr in zip(self.adam.param_groups, self.schedules):
            group["lr"] = lr(self.count) if callable(lr) else lr
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)


@dataclass
class AvatarOptimizer:
    """Learning rate (a float or a schedule over the update count) of every
    label; ``None`` freezes the label's tensors."""

    lrs: Dict[str, Optional[Schedule]]

    def init(self, params, model) -> AvatarOptState:
        groups, schedules = [], []
        for label, tensors in avatar_param_groups(params, model).items():
            lr = self.lrs[label]
            if lr is None or not tensors:
                continue
            first = lr(0) if callable(lr) else lr
            groups.append({"params": tensors, "lr": first, "name": label})
            schedules.append(lr)
        adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)
        return AvatarOptState(adam=adam, schedules=schedules)


def build_avatar_optimizer(cfg: RenderConfig, max_steps: int,
                           spatial_scale: float = 1.0) -> AvatarOptimizer:
    """The avatar's groups: positions (exponential decay x spatial_scale),
    scales, quaternions, LBS weights, the field encoder + color MLP at a
    small lr ("nerf"), the deform net, the mesh-binding params, the extra
    betas and the learnable SMPL-X template copies."""
    pos_lr = expon_lr(cfg.position_lr_init * spatial_scale,
                      cfg.position_lr_final * spatial_scale, max_steps)

    def maybe_frozen(enabled, lr):
        return lr if enabled else None

    return AvatarOptimizer({
        "pos": maybe_frozen(cfg.learn_positions, pos_lr),
        "scale": maybe_frozen(cfg.learn_scales, cfg.scaling_lr),
        "quat": maybe_frozen(cfg.learn_quaternions, cfg.rotation_lr),
        "lbs": maybe_frozen(cfg.learn_lbs_weights, cfg.lbs_lr),
        "nerf": 1e-3,
        "deform": 1e-4,
        "mesh_vertex": maybe_frozen(cfg.learn_mesh_vertex_coords,
                                    cfg.position_lr_init),
        "mesh_bary": maybe_frozen(cfg.learn_mesh_bary_coords,
                                  cfg.position_lr_init),
        "mesh_scale": maybe_frozen(cfg.learn_mesh_scales, cfg.scaling_lr),
        "betas": maybe_frozen(cfg.learn_hand_betas or cfg.learn_face_betas,
                              cfg.betas_lr),
        "smpl_tpl": cfg.lbs_lr,
        "smpl_vt": cfg.lbs_lr * 10.0,
    })


# ---------------------------------------------------------------------------
# Stage 1: update rules, schedules and the NeRF's groups
# ---------------------------------------------------------------------------

def _lr_at(lr: Schedule, count: int) -> float:
    return lr(count) if callable(lr) else lr


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it on the device (at
    b2 = 0.999 float32's rounding of the decay alone moves it by 1.3e-5
    relative)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@dataclass
class Adam:
    """optax's ``adam`` (``weight_decay == 0``) or ``adamw``: bias-corrected
    moments, ``u = m_hat / (sqrt(v_hat) + eps) + wd p``, update ``-lr u``
    with ``lr`` read at the count before the increment."""

    lr: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params) -> List[torch.Tensor]:
        lr = _lr_at(self.lr, state["count"])
        state["count"] += 1
        c1 = _bias_correction(self.b1, state["count"])
        c2 = _bias_correction(self.b2, state["count"])
        out = []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            out.append(-lr * u)
        return out


@dataclass
class Adan:
    """Adan (adaptive Nesterov momentum), the JAX package's transform:
    m = EMA_b1(g), v = EMA_b2(g_t - g_{t-1}), n = EMA_b3((g + b2 dg)^2);
    ``u = (m / c1 + b2 v / c2) / (sqrt(n / c3) + eps)``, update ``-lr u``,
    with proximal decoupled decay ``(p - lr u) / (1 + lr wd) - p``. The
    gradients are first scaled by ``min(1, max_grad_norm / (|g| + eps))``
    over the group when ``max_grad_norm > 0``."""

    lr: Schedule
    b1: float = 0.98
    b2: float = 0.92
    b3: float = 0.99
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 0.0

    def init(self, params: List[torch.Tensor]) -> dict:
        z = [torch.zeros_like(p) for p in params]
        return {"m": z, "v": [torch.zeros_like(p) for p in params],
                "n": [torch.zeros_like(p) for p in params],
                "g_prev": [torch.zeros_like(p) for p in params], "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params) -> List[torch.Tensor]:
        state["count"] += 1
        count = state["count"]
        if self.max_grad_norm > 0.0:
            grads = GlobalNormScale(self.max_grad_norm, self.eps)(grads)
        b1, b2, b3 = self.b1, self.b2, self.b3
        c1, c2, c3 = (_bias_correction(b, count) for b in (b1, b2, b3))
        lr = _lr_at(self.lr, count)
        out = []
        for i, (g, p) in enumerate(zip(grads, params)):
            dg = torch.zeros_like(g) if count == 1 \
                else g - state["g_prev"][i]
            m = state["m"][i].mul_(b1).add_(g, alpha=1 - b1)
            v = state["v"][i].mul_(b2).add_(dg, alpha=1 - b2)
            n = state["n"][i].mul_(b3).add_((g + b2 * dg) ** 2,
                                            alpha=1 - b3)
            step = (m / c1 + b2 * v / c2) / (torch.sqrt(n / c3) + self.eps)
            u = -lr * step
            if self.weight_decay > 0.0:
                u = (p + u) / (1.0 + lr * self.weight_decay) - p
            out.append(u)
            state["g_prev"][i] = g.clone()
        return out


def adan(learning_rate, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99,
         eps: float = 1e-8, weight_decay: float = 0.0,
         max_grad_norm: float = 0.0) -> Adan:
    return Adan(learning_rate, b1, b2, b3, eps, weight_decay, max_grad_norm)


@dataclass
class GlobalNormScale:
    """Gradients scaled by ``min(1, max_norm / (|g| + eps))``, ``|g|`` the
    norm over every tensor given (a device scalar: no host sync)."""

    max_norm: float
    eps: float = 1e-8

    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.clamp(self.max_norm / (gnorm + self.eps), max=1.0)
        return [g * scale for g in grads]


def global_norm_scale(max_norm: float, eps: float = 1e-8) -> GlobalNormScale:
    return GlobalNormScale(max_norm, eps)


def make_optimizer(kind: str, lr, **kwargs):
    """'adam' (b1 0.9, b2 0.99, eps 1e-15), 'adamw' (optax's defaults: b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4, or ``kwargs``) or
    'adan'."""
    if kind == "adam":
        return Adam(lr, b1=0.9, b2=0.99, eps=1e-15)
    if kind == "adamw":
        return Adam(lr, **{"weight_decay": 1e-4, **kwargs})
    if kind == "adan":
        return adan(lr, **kwargs)
    raise ValueError(f"unknown optimizer {kind!r}")


def nerf_lr_schedule(policy: str, base: float, max_steps: int,
                     alphas_cumprod=None) -> Callable[[int], float]:
    """Stage-1 learning-rate policies: 'none' / 'constant' / 'ddpm' (flat;
    'ddpm' weights the updates by timestep inside the step), 'cosine'
    (optax's cosine decay to 0 over ``max_steps``), 'step' (x0.1 from 0.7
    max), 'multistep' (x0.1 at s0, s0 + s0 / 2, s0 + 3 s0 / 4, s0 = 0.7
    max), 'warmup' (a linear 1000-step warmup, then 'multistep'), 'lambda'
    (1 - alphas_cumprod[(1 - s / max) T])."""
    if policy in ("none", "constant", "ddpm"):
        return lambda s: base
    if policy == "cosine":
        def cosine(s):
            frac = min(float(s), max_steps) / max_steps
            return base * 0.5 * (1.0 + math.cos(math.pi * frac))
        return cosine
    if policy == "step":
        k = int(max_steps * 0.7)
        return lambda s: base * (0.1 if s >= k else 1.0)
    if policy in ("multistep", "multi_step", "warmup"):
        s0 = int(max_steps * 0.7)
        ms = (s0, s0 + s0 // 2, s0 + s0 // 2 + s0 // 4)
        warmup_iter = 1000 if policy == "warmup" else 0

        def sched(s):
            lr = base * 0.1 ** sum(s >= m for m in ms)
            if warmup_iter > 0:
                lr = lr * min(max((s + 1.0) / warmup_iter, 0.0), 1.0)
            return lr

        return sched
    if policy == "lambda":
        if alphas_cumprod is None:
            raise ValueError("lr_policy='lambda' needs the diffusion "
                             "alphas_cumprod")
        ac = np.asarray(alphas_cumprod, np.float32)
        T = ac.shape[0]
        f32 = np.float32

        def sched(s):
            # float32 index arithmetic, truncated, as the JAX schedule's
            idx = int((f32(1.0) - f32(s) / f32(max_steps)) * f32(T))
            return base * (1.0 if idx >= T
                           else float(1.0 - ac[min(max(idx, 0), T - 1)]))

        return sched
    raise ValueError(f"unknown nerf lr_policy {policy!r}")


def nerf_param_groups(model) -> Dict[str, List[torch.Tensor]]:
    """{label: [parameters]} of a ``NeRFModel``: the plane tables
    "encoder", the heads and ``sigma_scale`` "mlp", the background MLP
    "bg"."""
    groups: Dict[str, List[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        label = "encoder" if name.startswith("planes") else \
            "bg" if name.startswith("bg_mlp.") else "mlp"
        groups.setdefault(label, []).append(p)
    return groups


@dataclass
class NeRFOptState:
    """Each group's parameters, rule and state; the optional global clip."""

    groups: Dict[str, tuple]
    clip: Optional[GlobalNormScale] = None

    @torch.no_grad()
    def step(self, scale=None) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0);
        ``scale`` (a number or a device scalar) multiplies every update,
        as the 'ddpm' policy's timestep weight does."""
        grads = {label: [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params]
                 for label, (params, _, _) in self.groups.items()}
        if self.clip is not None:
            flat = self.clip([g for gs in grads.values() for g in gs])
            it = iter(flat)
            grads = {k: [next(it) for _ in gs] for k, gs in grads.items()}
        for label, (params, rule, state) in self.groups.items():
            for p, u in zip(params, rule.update(grads[label], state,
                                                params)):
                p.add_(u if scale is None else u * scale)

    def zero_grad(self) -> None:
        for params, _, _ in self.groups.values():
            for p in params:
                p.grad = None


@dataclass
class NeRFOptimizer:
    """One update rule a label, and an optional global gradient clip."""

    rules: Dict[str, object]
    clip: Optional[GlobalNormScale] = None

    def init(self, model) -> NeRFOptState:
        groups = {label: (params, self.rules[label],
                          self.rules[label].init(params))
                  for label, params in nerf_param_groups(model).items()}
        return NeRFOptState(groups=groups, clip=self.clip)


def build_nerf_optimizer(cfg, max_steps: int,
                         alphas_cumprod=None) -> NeRFOptimizer:
    """The encoder at lr x ``encoder_lr_scale`` (AdamW with
    ``triplane_weight_decay`` on the planes), the MLPs at the base lr, the
    background at ``bg_lr``; Adam b1 0.9, b2 0.99, eps 1e-15.
    ``cfg.optimizer = 'adan'`` takes Adan (eps 1e-8, weight decay 2e-5) at
    5x the learning rates, behind a global norm clip at 5 over every
    group."""
    use_adan = cfg.optimizer == "adan"
    base = cfg.lr * (5.0 if use_adan else 1.0)
    bg_lr = cfg.bg_lr * (5.0 if use_adan else 1.0)
    sched = nerf_lr_schedule(cfg.lr_policy, base, max_steps,
                             alphas_cumprod=alphas_cumprod)

    def opt(lr, weight_decay: float = 0.0):
        if use_adan:
            return adan(lr, eps=1e-8, weight_decay=2e-5)
        return Adam(lr, b1=0.9, b2=0.99, eps=1e-15,
                    weight_decay=weight_decay)

    enc_wd = cfg.triplane_weight_decay if cfg.backbone == "triplane" \
        and getattr(cfg, "triplane_weight_decay", 0.0) else 0.0
    return NeRFOptimizer(
        rules={"encoder": opt(lambda s: sched(s) * cfg.encoder_lr_scale,
                              weight_decay=enc_wd),
               "mlp": opt(sched),
               "bg": opt(bg_lr)},
        clip=GlobalNormScale(5.0, 1e-8) if use_adan else None)

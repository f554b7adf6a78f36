"""Optimizer of the stage-2 avatar: Adam over per-attribute groups.

Port of ``expon_lr`` and ``build_avatar_optimizer`` from
``dreamwaltz_g_tpu/training/optim.py``. The JAX package partitions the
avatar's parameter tree into labelled groups with ``optax.multi_transform``;
here ``build_avatar_optimizer`` returns the same labels with their learning
rates, and ``AvatarOptimizer.init`` builds one ``torch.optim.Adam`` over the
groups of an avatar's tensors and network weights. A group frozen by the
config is left out: its tensors get no update at all. As in optax, a
scheduled learning rate is read at the update count before the increment,
so the first update uses ``schedule(0)``. ``adan`` and the NeRF optimizer
are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch

from ..configs import RenderConfig

Schedule = Union[float, Callable[[int], float]]


def expon_lr(lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
             ) -> Callable[[int], float]:
    """3DGS log-lerp learning rate with an optional delayed warmup."""

    def schedule(step) -> float:
        t = min(max(float(step) / max_steps, 0.0), 1.0)
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

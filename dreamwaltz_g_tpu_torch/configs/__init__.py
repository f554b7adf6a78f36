"""Configuration of the ported paths.

The port keeps its own copy of the parts of ``dreamwaltz_g_tpu/configs``
that it reads (it imports nothing of the JAX package). ``RenderConfig``
holds the learning rates, the learn switches and the densification
settings of the stage-2 avatar optimisation; ``GuideConfig`` holds what the
timestep scheduler and the pixel-gradient hooks read. Defaults are the JAX
package's; the JAX dataclasses' other fields are not read by any ported
path yet.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Optional


def _schedule(v) -> Any:
    """A scalar-or-schedule field: a number or a (start_step, v0, v1,
    end_step) tuple, possibly written as a string."""
    if isinstance(v, str):
        return ast.literal_eval(v)
    return v


@dataclass
class RenderConfig:
    """3DGS avatar optimisation settings."""

    lbs_lr: float = 1e-4
    betas_lr: float = 1e-2
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    scaling_lr: float = 0.0025
    rotation_lr: float = 0.001

    learn_positions: bool = True
    learn_scales: bool = True
    learn_quaternions: bool = True
    learn_lbs_weights: bool = False
    learn_hand_betas: bool = False
    learn_face_betas: bool = False
    learn_mesh_bary_coords: bool = True
    learn_mesh_scales: bool = True
    learn_mesh_vertex_coords: bool = False

    # densification (masked clone / split / prune in fixed-capacity buffers)
    use_densifier: bool = False
    densify_from_iter: Optional[int] = None
    densify_until_iter: Optional[int] = None
    densification_interval: Optional[int] = None
    densify_min_opacity: float = 0.005
    densify_grad_threshold: float = 100.0
    densify_disable_clone: bool = False
    densify_disable_split: bool = False
    densify_disable_prune: bool = False
    enable_grad_prune: bool = False


@dataclass
class GuideConfig:
    """Diffusion guidance settings read by the ported paths."""

    # multiply the RGB pixel-gradient clip / norm by the render's mask
    grad_rgb_clip_mask_guidance: bool = False

    guidance_scale: float = 50.0
    guidance_adjust: str = "constant"

    min_timestep: Any = 0.02
    max_timestep: Any = 0.98
    time_sampling: str = "annealed"
    time_annealing: str = "linear"
    time_annealing_window: str = "impluse"

    input_interpolate: bool = True

    grad_rgb_clip: bool = False
    grad_rgb_clip_scale: float = 3.0
    grad_rgb_norm: bool = False
    pgc_clip_rgb: float = -1.0
    pgc_suppress_type: int = 0
    lambda_guidance: float = 1.0

    def __post_init__(self):
        self.min_timestep = _schedule(self.min_timestep)
        self.max_timestep = _schedule(self.max_timestep)

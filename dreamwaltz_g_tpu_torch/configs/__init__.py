"""Configuration of the ported paths.

The port keeps its own copy of the parts of ``dreamwaltz_g_tpu/configs``
that it reads (it imports nothing of the JAX package). ``RenderConfig``
holds the learning rates, the learn switches and the densification
settings of the stage-2 avatar optimisation; ``GuideConfig`` holds what the
timestep scheduler and the pixel-gradient hooks read; ``NeRFConfig`` the
stage-1 field, renderer, regularizer and optimizer settings. Defaults are
the JAX package's; the JAX dataclasses' other fields are not read by any
ported path yet.
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


@dataclass
class NeRFConfig:
    """Stage-1 NeRF settings (the triplane backbone; the hash / tiled grid
    is not ported)."""

    density_activation: str = "exp"  # {'exp', 'softplus', 'scaling'}

    # ray marching: num_steps static samples a ray, of which at most
    # compact_steps occupied ones reach the field in training renders
    grid_size: int = 128
    num_steps: int = 96
    compact_steps: int = 32
    upsample_steps: int = 0
    update_extra_interval: int = 16
    # the training render's checkpointed ray chunk
    max_ray_batch: int = 4096
    density_thresh: float = 10.0

    bound: float = 2.0
    min_near: float = 0.1

    backbone: str = "triplane"
    triplane_resolution: int = 256
    triplane_dim: int = 32
    # decoupled weight decay on the plane tables (triplane only)
    triplane_weight_decay: float = 0.1
    # Cauchy volume-sparsity prior at random AABB points (triplane only)
    triplane_volume_sparsity: float = 3e-3
    grid_dtype: str = "f32"      # {'f32', 'bf16'} plane gather type
    nerf_type: str = "rgb"       # {'rgb', 'latent'}
    structure: str = "shared_mlp"  # {'shared_mlp', 'dual_mlp', 'dual_enc'}
    density_prior: str = "none"  # {'none', 'gaussian', 'sqrt'}
    bg_mode: str = "gray"
    bg_radius: float = 3.0
    rand_bg_prob: Optional[float] = None

    optimizer: str = "adam"
    lr: float = 1e-3
    bg_lr: float = 1e-3
    lr_policy: str = "constant"
    encoder_lr_scale: float = 10.0

    # sparsity constraints
    lambda_opacity: float = 0.0
    lambda_entropy: float = 0.0
    lambda_emptiness: float = 0.0
    sparsity_multiplier: float = 20.0
    sparsity_step: float = 1.0

    # stop-gradient on weights_sum when compositing the background
    detach_bg_weights_sum: bool = False

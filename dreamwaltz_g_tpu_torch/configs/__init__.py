"""Configuration of the ported paths.

The port keeps its own copy of the parts of ``dreamwaltz_g_tpu/configs``
that it reads (it imports nothing of the JAX package). ``RenderConfig``
holds the learning rates and the learn switches of the stage-2 avatar
optimizer, with the JAX package's defaults; the JAX dataclass's other
fields are not read by any ported path yet.
"""
from __future__ import annotations

from dataclasses import dataclass


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

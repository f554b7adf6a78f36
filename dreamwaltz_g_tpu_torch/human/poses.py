"""Canonical pose library and random pose sampling.

Port of ``dreamwaltz_g_tpu/human/poses.py``: the canonical T / A / Y poses
with their '-adjust' hip variants, the randomised rest pose 'canonical-R',
and the scaled-normal body / hand / expression sampler. The JAX package
draws from ``jax.random`` keys; here the draws come from a
``torch.Generator`` or are handed in (``uniform`` for canonical-R, the
normals dict for ``sample_random_pose``), so tests can give both packages
the same draws.

SMPL-X body joint indices used (0-based within the 21 body joints):
0 = left_hip, 1 = right_hip, 15 = left_shoulder, 16 = right_shoulder.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from .smplx_model import (
    NUM_BODY_JOINTS,
    SMPLXModelData,
    SMPLXParams,
    default_params,
)

L_HIP, R_HIP = 0, 1
L_SHOULDER, R_SHOULDER = 15, 16


def canonical_body_pose(pose_type: str,
                        generator: Optional[torch.Generator] = None,
                        batch_size: int = 1, device="cuda",
                        uniform: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, 63) axis-angle body pose. 'canonical-R' draws the shoulder
    angle in [-pi/4, pi/4] and the hip angle in [pi/30, pi/4] from two
    uniform [0, 1) draws (``uniform`` (2,), or from ``generator``)."""
    device = resolve_device(device)
    pose = np.zeros((batch_size, NUM_BODY_JOINTS, 3), np.float32)

    def set_hips(angle):
        pose[:, L_HIP, 2] = +angle
        pose[:, R_HIP, 2] = -angle

    def set_shoulders(angle):
        pose[:, L_SHOULDER, 2] = +angle
        pose[:, R_SHOULDER, 2] = -angle

    q = np.pi / 4
    adj = np.pi / 30
    if pose_type == "canonical-T":
        set_hips(q)
    elif pose_type == "canonical-T-adjust":
        set_hips(adj)
    elif pose_type == "canonical-Y":
        set_shoulders(q)
        set_hips(q)
    elif pose_type == "canonical-Y-adjust":
        set_shoulders(q)
        set_hips(adj)
    elif pose_type == "canonical-A":
        set_shoulders(-q)
        set_hips(q)
    elif pose_type in ("canonical-A-adjust", "canonical"):
        set_shoulders(-q)
        set_hips(adj)
    elif pose_type == "canonical-R":
        if uniform is None:
            if generator is None:
                raise ValueError("canonical-R needs uniform= or generator=")
            uniform = torch.rand((2,), generator=generator, device=device)
        u = torch.as_tensor(uniform, dtype=torch.float32, device=device)
        sh = -q + (q - -q) * u[0]
        hip = adj + (q - adj) * u[1]
        p = torch.as_tensor(pose, device=device)
        p[:, L_SHOULDER, 2] = -sh
        p[:, R_SHOULDER, 2] = sh
        p[:, L_HIP, 2] = hip
        p[:, R_HIP, 2] = -hip
        return p.reshape(batch_size, -1)
    else:
        raise ValueError(f"unknown canonical pose {pose_type!r}")
    return torch.as_tensor(pose.reshape(batch_size, -1), device=device)


def sample_random_pose(
    model: SMPLXModelData,
    generator: Optional[torch.Generator] = None,
    parts: tuple = ("body", "hand", "expr"),
    batch_size: int = 1,
    body_scale: float = 0.3,
    hand_scale: float = 0.3,
    expr_scale: float = 1.5,
    base_body: Optional[torch.Tensor] = None,
    normals: Optional[Dict[str, torch.Tensor]] = None,
) -> SMPLXParams:
    """Scaled-normal body / hand / expression poses (the JAX package's
    fallback prior when no VPoser is present). ``normals`` holds standard
    normal draws under 'body' (B, 63), 'left_hand' / 'right_hand' (B, 45)
    and 'expr' (B, n_expr); missing ones are drawn from ``generator`` in
    that order."""
    dev = model.device
    normals = dict(normals or {})

    def draw(name, shape):
        if name not in normals:
            if generator is None:
                raise ValueError(f"pass normals[{name!r}] or generator=")
            normals[name] = torch.randn(shape, generator=generator,
                                        device=dev)
        return torch.as_tensor(normals[name], dtype=torch.float32,
                               device=dev)

    p = default_params(model, batch_size)
    if "body" in parts:
        body = body_scale * draw("body", (batch_size, NUM_BODY_JOINTS * 3))
        if base_body is not None:
            body = body + base_body
        p = p._replace(body_pose=body)
    if "hand" in parts:
        p = p._replace(
            left_hand_pose=hand_scale * draw("left_hand", (batch_size, 45)),
            right_hand_pose=hand_scale * draw("right_hand", (batch_size, 45)))
    if "expr" in parts:
        p = p._replace(expression=expr_scale * draw(
            "expr", (batch_size, model.num_expr)))
    return p


def flat_hands(model: SMPLXModelData, p: SMPLXParams) -> SMPLXParams:
    """Cancel the model's hand pose mean, so canonical hands are flat."""
    if model.pose_mean.shape[0] < 90:
        return p
    B = p.body_pose.shape[0]
    lh = -model.pose_mean[-90:-45].reshape(1, 45)
    rh = -model.pose_mean[-45:].reshape(1, 45)
    return p._replace(left_hand_pose=lh.expand(B, 45).clone(),
                      right_hand_pose=rh.expand(B, 45).clone())


def centralized(model: SMPLXModelData, p: SMPLXParams) -> SMPLXParams:
    """Translate the body so the template's pelvis sits at the origin."""
    pelvis = torch.einsum("v,vc->c", model.J_regressor[0], model.v_template)
    return p._replace(transl=(-pelvis[None]).expand(
        p.body_pose.shape[0], 3).clone())


def canonical_params(
    model: SMPLXModelData,
    pose_type: str = "canonical-A-adjust",
    batch_size: int = 1,
    generator: Optional[torch.Generator] = None,
    centralize_pelvis: bool = True,
    flat_hand: bool = True,
) -> SMPLXParams:
    """Full canonical SMPLXParams, with pelvis centring and the hand-mean
    cancellation."""
    p = default_params(model, batch_size)
    p = p._replace(body_pose=canonical_body_pose(
        pose_type, generator, batch_size, device=model.device))
    if flat_hand:
        p = flat_hands(model, p)
    if centralize_pelvis:
        p = centralized(model, p)
    return p

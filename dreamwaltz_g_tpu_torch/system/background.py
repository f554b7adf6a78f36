"""Backgrounds.

Port of ``dreamwaltz_g_tpu/system/background.py``: the named solid colors
(``COLOR_PRESETS``, ``PureColorBackground``), the learned ray-direction
MLP (``BackgroundMLPNet``, ``MLPBackground``; ``--render.use_mlp_background``),
the frame stack of the reenactment path (``VideoBackground``) and the
frozen 3DGS scene read from a PLY (``load_gaussian_background``;
``--render.use_gs_background``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data.camera import get_rays
from ..nerf.network import BackgroundMLP

COLOR_PRESETS = {
    "black": (0.0, 0.0, 0.0),
    "white": (1.0, 1.0, 1.0),
    "gray": (0.5, 0.5, 0.5),
}


class PureColorBackground(NamedTuple):
    color: torch.Tensor  # (3,)

    @staticmethod
    def make(color="black", device="cuda") -> "PureColorBackground":
        if isinstance(color, str):
            color = COLOR_PRESETS[color]
        return PureColorBackground(torch.as_tensor(
            color, dtype=torch.float32, device=resolve_device(device)))

    def __call__(self, cam, frame_idx: Optional[int] = None) -> torch.Tensor:
        return self.color.expand(cam.image_height, cam.image_width, 3)


class BackgroundMLPNet(BackgroundMLP):
    """Ray direction -> RGB in (0, 1): the frequency encoding (``degree``
    octaves and the input), ``num_layers`` dense layers with ReLU between
    them (Flax's names ``dense_i``), a sigmoid."""

    def __init__(self, hidden: int = 32, num_layers: int = 2,
                 degree: int = 4, device=None):
        super().__init__(hidden, num_layers, 3, degree, device=device)

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(super().forward(dirs))


def mlp_background_image(net: BackgroundMLPNet, c2w: torch.Tensor,
                         intrinsics: torch.Tensor, H: int, W: int
                         ) -> torch.Tensor:
    """(H, W, 3): ``net`` at the unit ray directions of one camera (c2w
    (4, 4), intrinsics (3, 3))."""
    _, rays_d = get_rays(c2w[None], intrinsics[None], H, W)
    return net(rays_d[0]).reshape(H, W, 3)


class MLPBackground:
    """The net with its camera ray setup; the weights live in ``net``."""

    def __init__(self, net: Optional[BackgroundMLPNet] = None,
                 device="cuda"):
        self.net = net or BackgroundMLPNet(device=resolve_device(device))

    def init(self, generator: torch.Generator) -> BackgroundMLPNet:
        """Flax's initialisers (truncated LeCun kernels, zero biases),
        drawn from ``generator``."""
        self.net.reset_parameters(generator)
        return self.net

    def __call__(self, cam, frame_idx=None) -> torch.Tensor:
        return mlp_background_image(self.net, cam.c2w[0], cam.intrinsics[0],
                                    cam.image_height, cam.image_width)


class VideoBackground:
    """A preloaded frame stack indexed per eval frame (the reenactment
    compositing path)."""

    def __init__(self, frames: np.ndarray, device="cuda"):
        """frames: (T, H, W, 3) float32 in [0, 1], moved to ``device``."""
        self.frames = torch.as_tensor(np.asarray(frames, np.float32),
                                      device=resolve_device(device))

    def __call__(self, cam, frame_idx: int = 0) -> torch.Tensor:
        f = self.frames[frame_idx % self.frames.shape[0]]
        if f.shape[0] != cam.image_height or f.shape[1] != cam.image_width:
            raise ValueError("video background resolution mismatch: "
                             f"{tuple(f.shape[:2])} vs "
                             f"({cam.image_height}, {cam.image_width})")
        return f


def load_gaussian_background(path: str, device="cuda"):
    """A trained-3DGS PLY as a frozen ``GaussiansOut``: DC-only SH colors
    (degree 0, so direction-independent), sigmoid opacities, exp scales and
    normalised quaternions, all alive, none densified."""
    from ..ops.sh import C0
    from ..utils.point_cloud import load_gaussian_ply
    from .avatar import GaussiansOut

    device = resolve_device(device)
    d = load_gaussian_ply(path)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    n = d["positions"].shape[0]
    quats = t(d["quats"])
    return GaussiansOut(
        positions=t(d["positions"]),
        colors=torch.clamp(t(d["sh_dc"]) * C0 + 0.5, 0.0, 1.0),
        opacities=torch.sigmoid(t(d["opacity_logit"])),
        scales=torch.exp(t(d["log_scales"])),
        quats=quats / torch.clamp(torch.linalg.norm(quats, dim=-1,
                                                    keepdim=True), min=1e-8),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        densify_mask=torch.zeros((n,), dtype=torch.bool, device=device),
    )

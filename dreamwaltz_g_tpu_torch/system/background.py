"""Backgrounds.

Port of ``COLOR_PRESETS`` and ``VideoBackground`` from
``dreamwaltz_g_tpu/system/background.py``: the named solid colors of the
stage-1 background and the eval renders, and the frame stack of the
reenactment path. The MLP and Gaussian-scene backgrounds are not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

COLOR_PRESETS = {
    "black": (0.0, 0.0, 0.0),
    "white": (1.0, 1.0, 1.0),
    "gray": (0.5, 0.5, 0.5),
}


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

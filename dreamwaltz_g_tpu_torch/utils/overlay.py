"""Mask-aware overlay compositing for reenactment exports.

Port of ``dreamwaltz_g_tpu/utils/overlay.py`` (numpy + OpenCV on the host):
alpha-blend rendered avatar frames onto the inpainted source video,
resizing both to the smaller common size, and export the composited mp4
(and optionally its frames as PNGs); ``overlay_pngs_on_video`` does the
same from a folder of RGBA PNGs and an mp4 on disk.

The render path composites the video background *into* the render
(``image + (1 - alpha) * bg``); this module goes the other way: it takes
transparent avatar renders at render resolution and lays them over the
source video at the video's own size.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np


def _to_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[0] == h and img.shape[1] == w:
        return img
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def overlay_rgba_on_frame(rgba: np.ndarray, frame: np.ndarray,
                          premultiplied: bool = False) -> np.ndarray:
    """Alpha-blend one (H, W, 4) render over one (H', W', 3) frame at the
    smaller common size.

    ``premultiplied``: the RGB is already alpha-weighted (a splat
    renderer's ``sum w c`` output): blend as rgb + (1 - a) frame."""
    rgba = _to_float(rgba)
    frame = _to_float(frame)
    h = min(rgba.shape[0], frame.shape[0])
    w = min(rgba.shape[1], frame.shape[1])
    rgba = _resize(rgba, h, w)
    frame = _resize(frame, h, w)
    a = np.clip(rgba[..., 3:4], 0.0, 1.0)
    rgb = rgba[..., :3] if premultiplied else a * rgba[..., :3]
    return rgb + (1.0 - a) * frame


def overlay_frames_on_video(
    rgba_frames: Sequence[np.ndarray],
    video_frames: Sequence[np.ndarray],
    output_path: str,
    fps: int = 30,
    save_images: bool = False,
    premultiplied: bool = False,
) -> str:
    """Blend a rendered RGBA sequence over video frames and write the
    composited mp4 (and, with ``save_images``, its frames under
    ``overlay_frames/`` beside it). Returns the mp4 path."""
    from .media import save_image, write_video

    n = min(len(rgba_frames), len(video_frames))
    out_frames = [overlay_rgba_on_frame(rgba_frames[i], video_frames[i],
                                        premultiplied=premultiplied)
                  for i in range(n)]
    if save_images:
        d = osp.join(osp.dirname(output_path) or ".", "overlay_frames")
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(out_frames):
            save_image(osp.join(d, f"{i:06d}.png"), f)
    write_video(output_path, out_frames, fps=fps)
    return output_path



def overlay_pngs_on_video(
    image_folder: str,
    video_path: str,
    output_path: str,
    fps: Optional[int] = None,
    save_images: bool = True,
) -> str:
    """The folder's RGBA PNGs, in name order, over the mp4's frames
    (``overlay_frames_on_video``; 30 fps unless ``fps``). Returns the mp4
    path."""
    from PIL import Image

    from .media import read_video

    pngs = sorted(f for f in os.listdir(image_folder) if f.endswith(".png"))
    rgba = [np.asarray(Image.open(osp.join(image_folder, f)).convert("RGBA"))
            for f in pngs]
    return overlay_frames_on_video(rgba, list(read_video(video_path)),
                                   output_path, fps=fps or 30,
                                   save_images=save_images)

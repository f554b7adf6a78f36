"""Image and video IO.

A copy of ``dreamwaltz_g_tpu/utils/media.py`` (numpy on the host): PNG and
gif through PIL, mp4 through OpenCV's ``mp4v`` writer and reader. A writer
that cannot be opened raises; nothing swaps the codec or the format.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional, Sequence

import numpy as np


def to_uint8(image) -> np.ndarray:
    """float [0,1] (H, W, C) / (H, W) -> uint8 RGB (H, W, 3)."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    if a.shape[-1] == 4:
        a = a[..., :3]
    return a


def save_image(path: str, image) -> str:
    from PIL import Image

    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(image)).save(path)
    return path


def load_image(path: str, size: Optional[tuple] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size)
    return np.asarray(img, np.float32) / 255.0


class VideoWriterCV2:
    """Streaming mp4 writer (reference: VideoWriterOpenCV,
    utils/video.py:74-118)."""

    def __init__(self, path: str, fps: int = 30):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame) -> None:
        import cv2

        frame = to_uint8(frame)
        if self._writer is None:
            os.makedirs(osp.dirname(self.path) or ".", exist_ok=True)
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
            if not self._writer.isOpened():
                self._writer = None
                raise RuntimeError(f"OpenCV cannot open an mp4v writer for "
                                   f"{self.path}")
        self._writer.write(frame[..., ::-1])  # RGB -> BGR

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: str, frames: Sequence, fps: int = 30) -> str:
    with VideoWriterCV2(path, fps=fps) as w:
        for f in frames:
            w.write(f)
    return path


def write_gif(path: str, frames: Sequence, fps: int = 30) -> str:
    """(reference: VideoWriterPIL gif path, utils/video.py:121-158)"""
    from PIL import Image

    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(to_uint8(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 1), loop=0)
    return path


def read_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(T, H, W, 3) float32 frames in [0, 1] (reference: VideoBackground
    preload, core/system/background.py:92-160)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok or (max_frames is not None and len(frames) >= max_frames):
            break
        frames.append(frame[..., ::-1].astype(np.float32) / 255.0)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.float32)

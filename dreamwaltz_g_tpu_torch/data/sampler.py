"""Camera samplers: random training views and cyclical eval tracks.

Port of ``dreamwaltz_g_tpu/data/sampler.py``: the draws are numpy
``Generator`` draws in the JAX package's order, so one seed gives both
packages the same cameras; the ``CameraBatch`` is built on ``device``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .._device import resolve_device
from ..configs import DataConfig
from .camera import CameraBatch, make_camera_batch

# body-18 coco keypoint names in the 128-keypoint layout
KEYPOINT_NAMES = {
    "nose": 0, "neck": 1,
    "right_shoulder": 2, "right_elbow": 3, "right_wrist": 4,
    "left_shoulder": 5, "left_elbow": 6, "left_wrist": 7,
    "right_hip": 8, "right_knee": 9, "right_ankle": 10,
    "left_hip": 11, "left_knee": 12, "left_ankle": 13,
    "right_eye": 14, "left_eye": 15, "right_ear": 16, "left_ear": 17,
    # hand blocks: lhand 18..38, rhand 39..59 (wrist, then 5 fingers x 4)
    "left_wrist_new": 18,
    "left_middle1": 27, "left_middle2": 28, "left_middle3": 29,
    "left_middle": 30,
    "right_wrist_new": 39,
    "right_middle1": 48, "right_middle2": 49, "right_middle3": 50,
    "right_middle": 51,
}


def _sample_interval(rng: np.random.Generator, intervals, size: int):
    """Uniform draw from one of several (lo, hi) intervals, chosen with
    probability proportional to interval length."""
    intervals = list(intervals)
    if len(intervals) == 1:
        a, b = intervals[0]
    else:
        lengths = np.asarray([b - a + 1e-12 for a, b in intervals])
        a, b = intervals[rng.choice(len(intervals), p=lengths / lengths.sum())]
    return rng.uniform(a, b, size=size).astype(np.float32)


class RandomCamera:
    """"""

    def __init__(self, cfg: DataConfig, image_height: int, image_width: int,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.image_height = image_height
        self.image_width = image_width
        self.rng = np.random.default_rng(seed)
        self.radius_range: Tuple[float, float] = tuple(cfg.radius_range)
        self.fovy_range = tuple(cfg.fovy_range)
        self.azimuth_range = cfg.azimuth_range
        self.elevation_range = cfg.elevation_range
        self.z_near, self.z_far = cfg.z_near, cfg.z_far
        self.vertical_jitter = cfg.vertical_jitter
        self.camera_offset = cfg.camera_offset
        self.progressive_radius = cfg.progressive_radius
        self.progressive_radius_ranges = None
        if cfg.progressive_radius_ranges is not None:
            import ast
            self.progressive_radius_ranges = ast.literal_eval(
                str(cfg.progressive_radius_ranges))
        self.training_ratio: float = 0.0

    def _radius(self, size: int):
        if self.progressive_radius and self.progressive_radius_ranges:
            (s0, s1), (e0, e1) = self.progressive_radius_ranges
            lo = s0 + self.training_ratio * (e0 - s0)
            hi = s1 + self.training_ratio * (e1 - s1)
        else:
            lo, hi = self.radius_range
        return self.rng.uniform(lo, hi, size=size).astype(np.float32)

    def _at_vector(self, size: int):
        at = np.zeros((size, 3), np.float32)
        if self.camera_offset is not None:
            at += np.asarray(self.camera_offset, np.float32)
        if self.vertical_jitter is not None:
            at[:, 1] += self.rng.uniform(*self.vertical_jitter)
        return at

    def __call__(self, size: int) -> CameraBatch:
        radius = self._radius(size)
        azimuth = _sample_interval(self.rng, self.azimuth_range, size)
        elevation = _sample_interval(self.rng, self.elevation_range, size)
        fov = self.rng.uniform(*self.fovy_range, size=size).astype(np.float32)
        return make_camera_batch(
            radius, azimuth, elevation, fov,
            self.image_height, self.image_width,
            z_near=self.z_near, z_far=self.z_far,
            at_vector=self._at_vector(size), device=self.device,
        )


class RandomCamera4Avatar(RandomCamera):
    """Body-part-aware camera sampling: each draw picks a body part by
    probability, moving the look-at target to keypoint-derived offsets."""

    def __init__(self, cfg: DataConfig, image_height: int, image_width: int,
                 seed: int = 0, device="cuda"):
        super().__init__(cfg, image_height, image_width, seed, device)
        z3 = np.zeros(3, np.float32)
        self.parts: Dict[str, dict] = {
            "body": dict(prob=cfg.body_prob, azim=self.azimuth_range,
                         elev=self.elevation_range, radius=self.radius_range,
                         offset=None if self.camera_offset is None
                         else np.asarray(self.camera_offset, np.float32)),
            "head": dict(prob=cfg.head_prob, azim=cfg.head_azimuth_range,
                         elev=cfg.head_elevation_range,
                         radius=tuple(cfg.head_radius_range), offset=z3),
            "face": dict(prob=cfg.face_prob, azim=cfg.face_azimuth_range,
                         elev=cfg.face_elevation_range,
                         radius=tuple(cfg.face_radius_range), offset=z3),
            "hand_left": dict(prob=cfg.hand_prob / 2,
                              azim=cfg.hand_left_azimuth_range,
                              elev=cfg.hand_elevation_range,
                              radius=tuple(cfg.hand_radius_range), offset=z3),
            "hand_right": dict(prob=cfg.hand_prob / 2,
                               azim=cfg.hand_right_azimuth_range,
                               elev=cfg.hand_elevation_range,
                               radius=tuple(cfg.hand_radius_range), offset=z3),
            "foot_left": dict(prob=cfg.foot_prob / 2,
                              azim=cfg.foot_left_azimuth_range,
                              elev=cfg.foot_elevation_range,
                              radius=tuple(cfg.foot_radius_range), offset=z3),
            "foot_right": dict(prob=cfg.foot_prob / 2,
                               azim=cfg.foot_right_azimuth_range,
                               elev=cfg.foot_elevation_range,
                               radius=tuple(cfg.foot_radius_range), offset=z3),
            "arm_left": dict(prob=cfg.arm_prob / 2, azim=((0, 360),),
                             elev=((75, 105),), radius=(0.5, 1.0), offset=z3),
            "arm_right": dict(prob=cfg.arm_prob / 2, azim=((0, 360),),
                              elev=((75, 105),), radius=(0.5, 1.0), offset=z3),
        }
        self.keys = sorted(self.parts)
        self.use_human_vertical_jitter = cfg.use_human_vertical_jitter
        self._base_vertical_jitter = self.vertical_jitter
        self._base_progressive = self.progressive_radius

    def setup_camera_offset(self, keypoints: np.ndarray):
        """Derive per-part look-at offsets from the canonical body's 3D
        keypoints (N>=1, K>=18, 3)."""
        kp = np.asarray(keypoints)[0]
        K = KEYPOINT_NAMES
        if self.use_human_vertical_jitter:
            self._base_vertical_jitter = (
                float((kp[K["left_ankle"], 1] + kp[K["right_ankle"], 1]) / 2),
                float((kp[K["left_shoulder"], 1] + kp[K["right_shoulder"], 1]) / 2),
            )
        head = (kp[K["left_ear"]] + kp[K["right_ear"]]) / 2.0
        self.parts["head"]["offset"] = head
        self.parts["face"]["offset"] = head
        self.parts["arm_left"]["offset"] = (
            kp[K["left_elbow"]] / 3 + kp[K["left_wrist"]] * 2 / 3)
        self.parts["arm_right"]["offset"] = (
            kp[K["right_elbow"]] / 3 + kp[K["right_wrist"]] * 2 / 3)
        down = np.asarray([0.0, -0.05, 0.0], np.float32)
        self.parts["foot_left"]["offset"] = kp[K["left_ankle"]] + down
        self.parts["foot_right"]["offset"] = kp[K["right_ankle"]] + down
        if kp.shape[0] > 60:  # smplx: mid-hand from wrist + middle chain
            self.parts["hand_left"]["offset"] = np.mean(kp[[
                K["left_wrist_new"], K["left_middle1"], K["left_middle2"],
                K["left_middle3"], K["left_middle"]]], axis=0)
            self.parts["hand_right"]["offset"] = np.mean(kp[[
                K["right_wrist_new"], K["right_middle1"], K["right_middle2"],
                K["right_middle3"], K["right_middle"]]], axis=0)
        else:
            self.parts["hand_left"]["offset"] = kp[K["left_wrist"]] \
                + np.asarray([0.0, -0.1, 0.0], np.float32)
            self.parts["hand_right"]["offset"] = kp[K["right_wrist"]] \
                + np.asarray([0.0, -0.1, 0.0], np.float32)

    def choice_body_part(self) -> str:
        w = np.asarray([self.parts[k]["prob"] + 1e-12 for k in self.keys])
        return self.keys[self.rng.choice(len(self.keys), p=w / w.sum())]

    def __call__(self, size: int, body_part: Optional[str] = None,
                 ) -> Tuple[CameraBatch, str]:
        part = body_part or self.choice_body_part()
        spec = self.parts[part]
        self.azimuth_range = spec["azim"]
        self.elevation_range = spec["elev"]
        self.radius_range = spec["radius"]
        self.camera_offset = spec["offset"]
        if part == "body":
            self.progressive_radius = self._base_progressive
            self.vertical_jitter = self._base_vertical_jitter
        else:
            self.progressive_radius = False
            self.vertical_jitter = None
        return super().__call__(size), part


def sample_camera_trajectory(p: float, azimuth: float = 0.0,
                             elevation: float = 90.0,
                             trajectory: str = "circle"):
    """"""
    if trajectory == "fixed":
        return azimuth, elevation
    if trajectory == "circle":
        return p * 360.0, elevation
    if trajectory == "wave-elev":
        return p * 360.0, np.sin(p * 2 * np.pi) * 30.0
    if trajectory == "wave":
        return ((azimuth + np.sin(p * 4 * np.pi) * 20.0) % 360.0,
                (elevation + np.cos(p * 4 * np.pi) * 10.0) % 360.0)
    raise ValueError(f"unknown trajectory {trajectory!r}")


class CyclicalCamera:
    """Eval-track camera at progress p in [0, 1]."""

    def __init__(self, cfg: DataConfig, image_height: int, image_width: int,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.image_height = image_height
        self.image_width = image_width
        self.radius = cfg.eval_radius if cfg.eval_radius \
            else max(cfg.radius_range) * cfg.eval_radius_rate
        self.azimuth = cfg.eval_azimuth
        self.elevation = cfg.eval_elevation
        self.fov = (cfg.fovy_range[0] + cfg.fovy_range[1]) / 2
        self.camera_offset = None if cfg.eval_camera_offset is None \
            else np.asarray(cfg.eval_camera_offset, np.float32)
        self.trajectory = cfg.eval_camera_track

    def __call__(self, p: float, **overrides) -> CameraBatch:
        azim, elev = sample_camera_trajectory(
            p, overrides.get("azimuth", self.azimuth),
            overrides.get("elevation", self.elevation),
            overrides.get("trajectory", self.trajectory))
        at = np.zeros((1, 3), np.float32)
        if self.camera_offset is not None:
            at += self.camera_offset
        return make_camera_batch(
            overrides.get("radius", self.radius), azim, elev,
            overrides.get("fov", self.fov),
            self.image_height, self.image_width,
            z_near=self.cfg.z_near, z_far=self.cfg.z_far, at_vector=at,
            device=self.device)


class CyclicalCamera4Avatar(CyclicalCamera):
    """Eval camera that can orbit a specific body part."""

    def __init__(self, cfg: DataConfig, image_height: int, image_width: int,
                 device="cuda"):
        super().__init__(cfg, image_height, image_width, device)
        self.default_body_part = cfg.eval_body_part
        self._default_offset = np.zeros(3, np.float32) \
            if self.camera_offset is None else self.camera_offset.copy()

    def setup_camera_offset(self, keypoints: np.ndarray,
                            body_part: Optional[str] = None):
        part = body_part or self.default_body_part
        if part in (None, "body"):
            return
        kp = np.asarray(keypoints)[0]
        K = KEYPOINT_NAMES
        if part in ("head", "face"):
            off = (kp[K["left_ear"]] + kp[K["right_ear"]]) / 2.0
        elif part in ("left_hand", "right_hand"):
            side = "left" if part == "left_hand" else "right"
            if kp.shape[0] > 60:
                off = np.mean(kp[[
                    K[f"{side}_wrist_new"], K[f"{side}_middle1"],
                    K[f"{side}_middle2"], K[f"{side}_middle3"],
                    K[f"{side}_middle"]]], axis=0)
            else:
                off = kp[K[f"{side}_wrist"]] + np.asarray([0.0, -0.1, 0.0])
        elif part in KEYPOINT_NAMES:
            off = kp[KEYPOINT_NAMES[part]]
        else:
            raise ValueError(f"unknown body part {part!r}")
        self.camera_offset = self._default_offset + np.asarray(off, np.float32)

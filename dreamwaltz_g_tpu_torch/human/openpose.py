"""OpenPose-style skeleton map drawing for the pose ControlNet.

The port's own copy of ``dreamwaltz_g_tpu/human/openpose.py`` (host-side
numpy / cv2, no device code): the colors, limb sequence and stroke geometry
ControlNet v1.1-openpose was trained on. Body limbs are alpha-blended
ellipses on an 18-color wheel, hands HSV-colored sticks with red joints,
the face white dots; strokes scale with the canvas away from 512^2.

Keypoints arrive as a (K, 2) float array normalized to [0, 1], with NaN
marking absent or occluded points.
"""
from __future__ import annotations

import colorsys
import math
from typing import Optional, Sequence

import cv2
import numpy as np

# 1-based limb pairs over the 18 coco keypoints and the matching color wheel
_BODY_LIMBS = [
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18),
]
_BODY_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
    (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
    (255, 0, 170), (255, 0, 85),
]
# left-right keypoint swap: shoulders/arms, hips/legs, eyes and ears all
# swap sides (eyes at [15], [14] and ears at [17], [16] are both exchanged)
_FLIP_ORDER = [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]

_HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
    (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
]

_EPS = 0.01


def _ok(p) -> bool:
    return bool(np.all(np.isfinite(p)))


def draw_body(canvas: np.ndarray, kps: np.ndarray, radius: int = 4,
              stickwidth: int = 4, flip_lr: bool = False) -> np.ndarray:
    """18 coco keypoints (normalized xy, NaN = absent)."""
    H, W = canvas.shape[:2]
    if flip_lr:
        kps = kps[_FLIP_ORDER]
    for p, color in zip(kps, _BODY_COLORS):
        if not _ok(p):
            continue
        x, y = int(p[0] * W), int(p[1] * H)
        if x > _EPS and y > _EPS:
            cv2.circle(canvas, (x, y), radius, color, thickness=-1)
    for (i, j), color in zip(_BODY_LIMBS, _BODY_COLORS):
        p1, p2 = kps[i - 1], kps[j - 1]
        if not (_ok(p1) and _ok(p2)):
            continue
        y1, y2 = p1[1] * H, p2[1] * H
        x1, x2 = p1[0] * W, p2[0] * W
        mx, my = (x1 + x2) / 2, (y1 + y2) / 2
        length = math.hypot(x1 - x2, y1 - y2)
        angle = math.degrees(math.atan2(y1 - y2, x1 - x2))
        poly = cv2.ellipse2Poly(
            (int(mx), int(my)), (int(length / 2), stickwidth), int(angle),
            0, 360, 1)
        overlay = canvas.copy()
        cv2.fillConvexPoly(overlay, poly, color)
        canvas = cv2.addWeighted(canvas, 0.4, overlay, 0.6, 0)
    return canvas


def draw_hand(canvas: np.ndarray, kps: Optional[np.ndarray], radius: int = 4,
              thickness: int = 2) -> np.ndarray:
    """21 hand keypoints: red joint dots first, HSV-wheel sticks drawn over
    them, so lines cover the dots at every joint."""
    if kps is None:
        return canvas
    H, W = canvas.shape[:2]
    for p in kps:
        if not _ok(p):
            continue
        x, y = int(p[0] * W), int(p[1] * H)
        if x > _EPS and y > _EPS:
            cv2.circle(canvas, (x, y), radius, (0, 0, 255), thickness=-1)
    for ie, (i, j) in enumerate(_HAND_EDGES):
        p1, p2 = kps[i], kps[j]
        if not (_ok(p1) and _ok(p2)):
            continue
        x1, y1 = int(p1[0] * W), int(p1[1] * H)
        x2, y2 = int(p2[0] * W), int(p2[1] * H)
        if min(x1, y1, x2, y2) <= _EPS:
            continue
        # float color, as the OpenPose annotator passes it to cv2
        # (hsv_to_rgb * 255)
        rgb = colorsys.hsv_to_rgb(ie / len(_HAND_EDGES), 1.0, 1.0)
        color = tuple(c * 255.0 for c in rgb)
        cv2.line(canvas, (x1, y1), (x2, y2), color, thickness=thickness)
    return canvas


def draw_face(canvas: np.ndarray, kps: Optional[np.ndarray],
              radius: int = 3) -> np.ndarray:
    """Face landmarks as white dots."""
    if kps is None:
        return canvas
    H, W = canvas.shape[:2]
    for p in kps:
        if not _ok(p):
            continue
        x, y = int(p[0] * W), int(p[1] * H)
        if x > _EPS and y > _EPS:
            cv2.circle(canvas, (x, y), radius, (255, 255, 255), thickness=-1)
    return canvas


def draw_openpose_map(
    keypoints: Sequence[np.ndarray],
    height: int,
    width: int,
    draw_body_kp: bool = True,
    draw_hand_kp: bool = True,
    draw_face_kp: bool = False,
    flip_lr: bool = False,
) -> np.ndarray:
    """Render the full 128-keypoint skeleton map.

    Args:
        keypoints: per-person (128, 2) normalized-xy arrays (NaN = absent);
            layout body 18 | lhand 21 | rhand 21 | face 68.
    Returns (H, W, 3) uint8 canvas (black background).
    """
    canvas = np.zeros((height, width, 3), np.uint8)
    # stroke scaling away from the 512^2 training resolution
    r = (height + width) / 2.0 / 512.0
    body_radius = max(int(4 * r), 1)
    stickwidth = max(int(4 * r), 1)
    hand_radius = max(int(4 * r), 1)
    hand_thickness = max(int(2 * r), 1)
    face_radius = max(int(3 * r), 1)

    for kp in keypoints:
        kp = np.asarray(kp, np.float32)
        body = kp[:18]
        lhand = kp[18:39] if kp.shape[0] > 18 else None
        rhand = kp[39:60] if kp.shape[0] > 39 else None
        face = kp[60:128] if kp.shape[0] > 60 else None
        if draw_body_kp:
            canvas = draw_body(canvas, body, body_radius, stickwidth, flip_lr)
        if draw_hand_kp:
            canvas = draw_hand(canvas, lhand, hand_radius, hand_thickness)
            canvas = draw_hand(canvas, rhand, hand_radius, hand_thickness)
        if draw_face_kp:
            canvas = draw_face(canvas, face, face_radius)
    return canvas

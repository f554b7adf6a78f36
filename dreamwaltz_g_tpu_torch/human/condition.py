"""ControlNet condition rendering from posed SMPL-X bodies.

Port of ``dreamwaltz_g_tpu/human/condition.py``. The condition images the
ControlNet sees each step:

* ``pose``: the OpenPose skeleton of the projected 128 keypoints, with
  per-part occlusion culling (camera -> keypoint ray casts against the
  posed mesh, ``ops/raycast.py:cast_rays``);
* ``depth``: inverse-normalised mesh depth; ``depth_raw``: metric depth
  and mask; ``normal``: a world-normal map; ``mesh``: a shaded mesh
  (``ops/raycast.py:rasterize_mesh``).

The projection and the ray casts run on the body's device; one host pull
per batch brings the keypoints to the skeleton drawing
(``human/openpose.py``, host numpy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.raycast import cast_rays, rasterize_mesh
from .keypoints import (
    BODY_KP_INDICES,
    FACE_KP_INDICES,
    HAND_KP_INDICES,
    LandmarkData,
    openpose_keypoints,
    project_keypoints,
)
from .openpose import draw_openpose_map
from .smplx_model import SMPLXModelData, SMPLXOutput


@dataclass(frozen=True)
class OcclusionCullingConfig:
    thres_body: float = 0.2
    thres_face: float = 0.02
    thres_hand: float = 0.2
    ignore_body_self_occlusion: bool = True


def occlusion_cull(
    campos: torch.Tensor,          # (3,)
    keypoints: torch.Tensor,       # (N, K, 3) world
    vertices: torch.Tensor,        # (N*V, 3) all persons' vertices, stacked
    faces,                         # (N*F, 3) with per-person vertex offsets
    cfg: OcclusionCullingConfig = OcclusionCullingConfig(),
    n_person: int = 1,
):
    """Per-keypoint occlusion test: a keypoint is occluded when the first
    hit of the camera -> keypoint ray is closer than the keypoint by more
    than its part's threshold. Body keypoints ignore hits on their own
    person when ``cfg.ignore_body_self_occlusion``.

    Returns (occluded (N, K) bool, distances (N, K))."""
    N, K, _ = keypoints.shape
    dev = keypoints.device
    kp = keypoints.reshape(-1, 3)
    d = kp - campos
    t_far = torch.linalg.norm(d, dim=-1)
    dirs = d / torch.clamp(t_far[:, None], min=1e-12)
    faces = torch.as_tensor(faces, device=dev)
    F_per = faces.shape[0] // n_person
    t_hit, geom = cast_rays(campos.expand(kp.shape), dirs, vertices, faces,
                            geometry_sizes=(F_per,) * n_person)
    gap = (t_far - t_hit).reshape(N, K)
    geom = geom.reshape(N, K)

    thres = torch.full((K,), cfg.thres_body, device=dev)
    thres[torch.as_tensor(FACE_KP_INDICES, device=dev).long()] = cfg.thres_face
    thres[torch.as_tensor(HAND_KP_INDICES, device=dev).long()] = cfg.thres_hand
    occluded = gap > thres[None, :]
    if cfg.ignore_body_self_occlusion:
        self_hit = geom == torch.arange(N, device=dev)[:, None]
        body = torch.zeros((K,), dtype=torch.bool, device=dev)
        body[torch.as_tensor(BODY_KP_INDICES, device=dev).long()] = True
        occluded = occluded & ~(self_hit & body[None, :])
    return occluded, t_far.reshape(N, K)


def _camera_position(extrinsic: torch.Tensor) -> torch.Tensor:
    return -extrinsic[:3, :3].T @ extrinsic[:3, 3]


def _pose_cull_project_batch(extrinsics, intrinsics, kp3d, vertices, faces,
                             cfg: OcclusionCullingConfig, n_person: int,
                             use_cull: bool) -> torch.Tensor:
    """All B views' keypoint projections (B, N, K, 2), occluded keypoints
    NaN; ``kp3d`` (B, N, K, 3) and ``vertices`` (B, N*V, 3) per view."""
    out = []
    for extr, intr, kp, verts in zip(extrinsics, intrinsics, kp3d,
                                     vertices):
        kp2d = project_keypoints(kp, extr, intr)
        if use_cull:
            occluded, _ = occlusion_cull(_camera_position(extr), kp, verts,
                                         faces, cfg=cfg, n_person=n_person)
            kp2d = torch.where(occluded[..., None],
                               torch.full_like(kp2d, float("nan")), kp2d)
        out.append(kp2d)
    return torch.stack(out)


class ConditionRenderer:
    """Renders ControlNet conditions for one or more posed persons."""

    def __init__(
        self,
        model: SMPLXModelData,
        landmarks: Optional[LandmarkData] = None,
        use_occlusion_culling: bool = True,
        culling: OcclusionCullingConfig = OcclusionCullingConfig(),
        draw_body_keypoints: bool = True,
        draw_hand_keypoints: bool = True,
        draw_face_landmarks: bool = False,
        openpose_left_right_flip: bool = False,
    ):
        self.model = model
        self.landmarks = landmarks
        self.use_occlusion_culling = use_occlusion_culling
        self.culling = culling
        self.draw_body = draw_body_keypoints
        self.draw_hand = draw_hand_keypoints
        self.draw_face = draw_face_landmarks
        self.flip_lr = openpose_left_right_flip

    def _stacked_mesh(self, output: SMPLXOutput):
        """All persons as one soup with per-person vertex offsets."""
        N, V, _ = output.vertices.shape
        verts = output.vertices.reshape(-1, 3)
        f = torch.as_tensor(self.model.faces, device=verts.device)
        faces = torch.cat([f + i * V for i in range(N)], dim=0)
        return verts, faces

    def _draw(self, kp2d: np.ndarray, image_height: int, image_width: int):
        return draw_openpose_map(
            list(kp2d), image_height, image_width,
            draw_body_kp=self.draw_body, draw_hand_kp=self.draw_hand,
            draw_face_kp=self.draw_face, flip_lr=self.flip_lr)

    @staticmethod
    def _normalized(kp2d: torch.Tensor, image_height: int,
                    image_width: int) -> np.ndarray:
        kp2d = kp2d.cpu().numpy().astype(np.float32)
        kp2d[..., 0] /= float(image_width)
        kp2d[..., 1] /= float(image_height)
        return kp2d

    def pose_keypoints(self, output: SMPLXOutput, extrinsic, intrinsics,
                       image_height: int, image_width: int) -> np.ndarray:
        """(N, 128, 2) normalised pixel keypoints, NaN = absent / occluded."""
        kp3d = openpose_keypoints(self.model, output, self.landmarks)
        kp2d = project_keypoints(kp3d, extrinsic, intrinsics)
        if self.use_occlusion_culling:
            verts, faces = self._stacked_mesh(output)
            occluded, _ = occlusion_cull(
                _camera_position(extrinsic), kp3d, verts, faces,
                cfg=self.culling, n_person=output.vertices.shape[0])
            kp2d = torch.where(occluded[..., None],
                               torch.full_like(kp2d, float("nan")), kp2d)
        return self._normalized(kp2d, image_height, image_width)

    def render_pose(self, output, extrinsic, intrinsics,
                    image_height: int, image_width: int) -> np.ndarray:
        """(H, W, 3) uint8 OpenPose map."""
        kp = self.pose_keypoints(output, extrinsic, intrinsics,
                                 image_height, image_width)
        return self._draw(kp, image_height, image_width)

    def render_pose_batch(self, outputs: Sequence[SMPLXOutput], extrinsics,
                          intrinsics, image_height: int,
                          image_width: int) -> list:
        """B views' OpenPose maps, ``outputs`` one SMPLXOutput a view (the
        same object B times to share a pose); one host pull for all
        views' keypoints."""
        B = int(extrinsics.shape[0])
        if len(outputs) != B:
            raise ValueError(f"{len(outputs)} poses for {B} views")
        kp3d = torch.stack([openpose_keypoints(self.model, o, self.landmarks)
                            for o in outputs])
        n_person = outputs[0].vertices.shape[0]
        verts = torch.stack([o.vertices.reshape(-1, 3) for o in outputs])
        _, faces = self._stacked_mesh(outputs[0])
        kp2d = _pose_cull_project_batch(
            extrinsics, intrinsics, kp3d, verts, faces, cfg=self.culling,
            n_person=n_person, use_cull=self.use_occlusion_culling)
        kp2d = self._normalized(kp2d, image_height, image_width)
        return [self._draw(kp2d[i], image_height, image_width)
                for i in range(B)]

    def _raster(self, output, extrinsic, intrinsics, image_height,
                image_width):
        verts, faces = self._stacked_mesh(output)
        return rasterize_mesh(verts, faces, extrinsic, intrinsics,
                              image_height, image_width)

    def render_depth(self, output, extrinsic, intrinsics,
                     image_height: int, image_width: int, raw: bool = False):
        """Inverse-normalised uint8 depth, or (metric depth (H, W), mask)
        when ``raw``."""
        render = self._raster(output, extrinsic, intrinsics, image_height,
                              image_width)
        depth = render.depth.cpu().numpy()
        mask = render.mask.cpu().numpy()
        if raw:
            return np.where(mask, depth, 0.0), mask
        inv = np.where(mask, 1.0 / np.maximum(depth, 1e-6), 0.0)
        lo, hi = inv.min(), inv.max()
        inv = (inv - lo) / max(hi - lo, 1e-12)
        img = (inv * 255.0).astype(np.uint8)
        return np.stack([img] * 3, axis=-1)

    def render_normal(self, output, extrinsic, intrinsics,
                      image_height: int, image_width: int) -> np.ndarray:
        """(H, W, 3) uint8 world-normal map."""
        render = self._raster(output, extrinsic, intrinsics, image_height,
                              image_width)
        n = render.normal.cpu().numpy()
        img = ((n * 0.5 + 0.5) * 255.0).astype(np.uint8)
        img[~render.mask.cpu().numpy()] = 0
        return img

    def render_mesh(self, output, extrinsic, intrinsics,
                    image_height: int, image_width: int,
                    light_dir=(0.3, 0.8, 0.5)) -> np.ndarray:
        """Lambertian gray over the z-buffer, white background."""
        render = self._raster(output, extrinsic, intrinsics, image_height,
                              image_width)
        n = render.normal.cpu().numpy()
        light = np.asarray(light_dir, np.float32)
        light = light / np.linalg.norm(light)
        shade = 0.25 + 0.75 * np.abs(n @ light)
        img = (np.clip(shade, 0, 1) * 255.0).astype(np.uint8)
        img[~render.mask.cpu().numpy()] = 255
        return np.stack([img] * 3, axis=-1)

    def __call__(self, output: SMPLXOutput, extrinsic, intrinsics,
                 condition_type: str, condition_height: int,
                 condition_width: int):
        """uint8 (H, W, 3) for image conditions; 'depth_raw' gives
        (depth (H, W) float, mask (H, W) bool)."""
        args = (output, extrinsic, intrinsics, condition_height,
                condition_width)
        if condition_type in ("pose", "openpose"):
            return self.render_pose(*args)
        if condition_type == "depth":
            return self.render_depth(*args)
        if condition_type == "depth_raw":
            return self.render_depth(*args, raw=True)
        if condition_type == "normal":
            return self.render_normal(*args)
        if condition_type == "mesh":
            return self.render_mesh(*args)
        raise NotImplementedError(condition_type)


def conditions_to_batch(images: Sequence[np.ndarray],
                        device="cuda") -> torch.Tensor:
    """uint8 condition images -> (B, H, W, 3) float32 in [0, 1] on
    ``device``."""
    from .._device import resolve_device

    arr = np.stack([np.asarray(im, np.float32) / 255.0 for im in images])
    return torch.as_tensor(arr, device=resolve_device(device))

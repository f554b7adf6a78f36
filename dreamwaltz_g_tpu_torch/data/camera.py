"""Camera math with the reference's coordinate conventions.

Port of ``dreamwaltz_g_tpu/data/camera.py``; the camera wireframe
drawings (``camera_wireframes``, ``draw_camera_viz``) are debugging aids
that stay on the host in numpy and OpenCV. Conventions:

* world is y-up; the spherical camera position is
  ``(r sin(elev) sin(azim), r cos(elev), r sin(elev) cos(azim))`` with the
  elevation measured from +y,
* c2w columns are (right, up, lookat): camera-space +z looks at the scene,
* intrinsics carry a negative fy (y-flip) and cx = cy = H // 2,
* the projection matrix is OpenGL-style with y negated.

All functions are batched over a leading B dim.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .._device import resolve_device
from ..utils.transforms import look_at_rotation


def angle_to_position(radius, elevation, azimuth):
    """Spherical (degrees) -> Cartesian, y-up, elevation from +y."""
    azimuth = torch.deg2rad(azimuth)
    elevation = torch.deg2rad(elevation)
    return torch.stack(
        [
            radius * torch.sin(elevation) * torch.sin(azimuth),
            radius * torch.cos(elevation),
            radius * torch.sin(elevation) * torch.cos(azimuth),
        ],
        dim=-1,
    )


def to_extrinsic(
    radius: torch.Tensor,
    azimuth: torch.Tensor,
    elevation: torch.Tensor,
    at_vector=((0.0, 0.0, 0.0),),
    up_vector=((0.0, 1.0, 0.0),),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (extrinsic w2c (B, 4, 4), c2w (B, 4, 4))."""
    B = radius.shape[0]
    kw = dict(dtype=torch.float32, device=radius.device)
    at = torch.as_tensor(at_vector, **kw).expand(B, 3)
    up = torch.as_tensor(up_vector, **kw).expand(B, 3)
    pos_rel = angle_to_position(radius, elevation, azimuth)
    campos = at + pos_rel
    lookat = -pos_rel / torch.clamp(
        torch.linalg.norm(pos_rel, dim=-1, keepdim=True), min=1e-20)
    rot = look_at_rotation(lookat, up)  # columns: right, up, lookat
    c2w = torch.zeros((B, 4, 4), **kw)
    c2w[:, :3, :3] = rot
    c2w[:, :3, 3] = campos
    c2w[:, 3, 3] = 1.0
    rt = rot.transpose(-1, -2)
    w2c = torch.zeros_like(c2w)
    w2c[:, :3, :3] = rt
    w2c[:, :3, 3] = -(rt @ campos[..., None])[..., 0]
    w2c[:, 3, 3] = 1.0
    return w2c, c2w


def to_intrinsics(tanfov: torch.Tensor, image_height: int,
                  image_width: int) -> torch.Tensor:
    """(B,) tanfov -> (B, 3, 3) pinhole intrinsics with negative fy."""
    B = tanfov.shape[0]
    f = image_height / (2.0 * tanfov)
    K = torch.zeros((B, 3, 3), dtype=torch.float32, device=tanfov.device)
    K[:, 0, 0] = f
    K[:, 1, 1] = -f
    K[:, 0, 2] = image_height // 2
    K[:, 1, 2] = image_width // 2
    K[:, 2, 2] = 1.0
    return K


def to_projection(tanfov: torch.Tensor, z_near: float, z_far: float,
                  aspect_wh: float = 1.0) -> torch.Tensor:
    """OpenGL-style projection, y negated, NDC z in (-1, 1)."""
    B = tanfov.shape[0]
    max_y = tanfov * z_near
    max_x = max_y * aspect_wh
    P = torch.zeros((B, 4, 4), dtype=torch.float32, device=tanfov.device)
    P[:, 0, 0] = z_near / max_x
    P[:, 1, 1] = -z_near / max_y
    P[:, 2, 2] = (z_far + z_near) / (z_far - z_near)
    P[:, 2, 3] = -(2 * z_far * z_near) / (z_far - z_near)
    P[:, 3, 2] = 1.0
    return P


def to_screen(batch: int, image_height: int, image_width: int,
              with_xyflip: bool = False, device="cuda") -> torch.Tensor:
    """NDC -> pixel matrix, (batch, 4, 4)."""
    device = resolve_device(device)
    s = -1.0 if with_xyflip else 1.0
    K = torch.zeros((batch, 4, 4), dtype=torch.float32, device=device)
    K[:, 0, 0] = s * (image_width - 1.0) / 2.0
    K[:, 1, 1] = s * (image_height - 1.0) / 2.0
    K[:, 0, 3] = (image_width - 1.0) / 2.0
    K[:, 1, 3] = (image_height - 1.0) / 2.0
    K[:, 2, 2] = 1.0
    K[:, 3, 3] = 1.0
    return K


def depth_to_ndc_depth(depth, z_near: float, z_far: float):
    return (z_near + z_far - 2 * z_near * z_far / depth) / (z_far - z_near)


def ndc_depth_to_depth(ndc_depth, z_near: float, z_far: float):
    return 2 * z_near * z_far / (z_near + z_far - ndc_depth * (z_far - z_near))


def get_rays(c2w: torch.Tensor, intrinsics: torch.Tensor, H: int, W: int):
    """Per-pixel rays: (rays_o (B, H*W, 3), rays_d (B, H*W, 3)). Pixel
    centres at +0.5; the negative fy in the intrinsics flips image y into
    camera-up; directions are unit length."""
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    kw = dict(dtype=torch.float32, device=c2w.device)
    jj, ii = torch.meshgrid(torch.arange(H, **kw) + 0.5,
                            torch.arange(W, **kw) + 0.5, indexing="ij")
    i = ii.reshape(1, H * W)
    j = jj.reshape(1, H * W)
    xs = (i - cx[:, None]) / fx[:, None]
    ys = (j - cy[:, None]) / fy[:, None]
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-20)
    rays_d = torch.einsum("bnk,bik->bni", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


class CameraBatch(NamedTuple):
    """The camera bundle handed to renderers."""

    extrinsic: torch.Tensor   # (B, 4, 4) w2c
    c2w: torch.Tensor         # (B, 4, 4)
    intrinsics: torch.Tensor  # (B, 3, 3)
    projection: torch.Tensor  # (B, 4, 4)
    tanfov: torch.Tensor      # (B,)
    radius: torch.Tensor      # (B,)
    azimuth: torch.Tensor     # (B,) degrees
    elevation: torch.Tensor   # (B,) degrees, polar-from-+y
    image_height: int
    image_width: int

    @property
    def full_projection(self) -> torch.Tensor:
        """world -> NDC: P @ w2c, (B, 4, 4), column-vector convention."""
        return self.projection @ self.extrinsic

    @property
    def campos(self) -> torch.Tensor:
        return self.c2w[:, :3, 3]


def make_camera_batch(
    radius,
    azimuth,
    elevation,
    fov_degrees,
    image_height: int,
    image_width: int,
    z_near: float = 0.01,
    z_far: float = 100.0,
    at_vector=((0.0, 0.0, 0.0),),
    device="cuda",
) -> CameraBatch:
    device = resolve_device(device)

    def vec(x):
        return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32,
                                                device=device))

    radius, azimuth, elevation = vec(radius), vec(azimuth), vec(elevation)
    tanfov = torch.tan(vec(fov_degrees) * (math.pi / 180.0) / 2.0)
    w2c, c2w = to_extrinsic(radius, azimuth, elevation, at_vector=at_vector)
    return CameraBatch(
        extrinsic=w2c,
        c2w=c2w,
        intrinsics=to_intrinsics(tanfov, image_height, image_width),
        projection=to_projection(tanfov, z_near, z_far,
                                 aspect_wh=image_width / image_height),
        tanfov=tanfov,
        radius=radius,
        azimuth=azimuth,
        elevation=elevation,
        image_height=image_height,
        image_width=image_width,
    )


# frustum wire colour by view direction index (default, front, side, back,
# side, overhead, bottom)
_DIR_COLORS = (
    (0, 0, 0), (255, 0, 0), (0, 255, 0), (0, 0, 255),
    (255, 255, 0), (255, 0, 255), (0, 255, 255),
)


def camera_wireframes(c2w, dirs=None, size: float = 0.2,
                      draw_axis: bool = True):
    """Line segments drawing a batch of camera poses: an 8-segment frustum
    pyramid a camera, coloured by its view direction index (``dirs``, (B,)
    into the 7 colours; none: 0), and with ``draw_axis`` its local x, y and
    z axes at lengths 0.5, 0.5 and 5 in red, green and blue. ``c2w``:
    (B, 4, 4) or (4, 4), array-like. Returns (segments (S, 2, 3) float32,
    colours (S, 3) uint8)."""
    import numpy as np

    c2w = np.asarray(c2w, np.float32)
    if c2w.ndim == 2:
        c2w = c2w[None]
    if dirs is None:
        dirs = np.zeros((c2w.shape[0],), np.int8)
    segs, colors = [], []
    for pose, d in zip(c2w, np.asarray(dirs)):
        pos = pose[:3, 3]
        r, u, f = pose[:3, 0], pose[:3, 1], pose[:3, 2]
        a = pos + size * r + size * u + size * f
        b = pos - size * r + size * u + size * f
        c = pos - size * r - size * u + size * f
        e = pos + size * r - size * u + size * f
        quad = [[pos, a], [pos, b], [pos, c], [pos, e],
                [a, b], [b, c], [c, e], [e, a]]
        segs += quad
        colors += [_DIR_COLORS[int(d) % 7]] * len(quad)
        if draw_axis:
            for axis, scale, col in ((0, 0.5, (255, 0, 0)),
                                     (1, 0.5, (0, 255, 0)),
                                     (2, 5.0, (0, 0, 255))):
                segs.append([pos, pos + scale * pose[:3, axis]])
                colors.append(col)
    return np.asarray(segs, np.float32), np.asarray(colors, np.uint8)


def draw_camera_viz(c2w, dirs=None, smpl_vertices=None, size: float = 0.2,
                    image_size: int = 512, plane: str = "xz"):
    """The camera rig of ``camera_wireframes`` (and, when given, the body's
    vertices as grey dots) drawn orthographically onto a white square
    canvas, projected onto the world axes ``plane`` names ('xz' from
    above, 'xy' from the front). Returns (image_size, image_size, 3) uint8
    RGB; reverse the channels before ``cv2.imwrite``."""
    import cv2
    import numpy as np

    segs, colors = camera_wireframes(c2w, dirs=dirs, size=size)
    ax = {"x": 0, "y": 1, "z": 2}
    i, j = ax[plane[0]], ax[plane[1]]
    pts = segs.reshape(-1, 3)[:, [i, j]]
    sv = None
    if smpl_vertices is not None:
        sv = np.asarray(smpl_vertices, np.float32).reshape(-1, 3)[:, [i, j]]
        pts = np.concatenate([pts, sv], axis=0)
    lo = pts.min(axis=0) - 0.2
    hi = pts.max(axis=0) + 0.2
    scale = (image_size - 1) / max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        q = (p - lo) * scale
        return (int(round(float(q[0]))),
                image_size - 1 - int(round(float(q[1]))))

    img = np.full((image_size, image_size, 3), 255, np.uint8)
    if sv is not None:
        for p in sv:
            cv2.circle(img, to_px(p), 1, (80, 80, 80), -1)
    for (p0, p1), col in zip(segs[:, :, [i, j]], colors):
        cv2.line(img, to_px(p0), to_px(p1), tuple(int(x) for x in col), 1,
                 cv2.LINE_AA)
    return img

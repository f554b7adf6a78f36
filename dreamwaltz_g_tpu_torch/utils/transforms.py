"""Quaternion / rotation / SE(3) algebra on torch tensors.

Port of ``dreamwaltz_g_tpu/utils/transforms.py``; conventions are the same:

* quaternions are (w, x, y, z), unit-norm, acting on column points,
* ``RigidTransform`` holds a batch of SE(3) transforms as (rot, trans);
  ``compose(a, b)`` applies ``a`` first then ``b``,
* ``weight`` linearly blends SE(3) matrices with per-point weights (LBS),
* ``transform_quaternions`` supports the flipped-axis conjugation.

Every function is shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device


def quat_identity(shape=(), dtype=torch.float32, device="cuda"
                  ) -> torch.Tensor:
    """(*shape, 4) identity quaternions."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype,
                    device=resolve_device(device))
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def safe_normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize through a clamped square norm (finite at ||v|| -> 0)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(sq, min=eps * eps))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) wxyz."""
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """The conjugate (w, -x, -y, -z): the inverse of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = torch.unbind(q, dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, branch-free: the best-conditioned of the
    four candidate decompositions per element, canonical sign w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = _sqrt(1.0 + m00 + m11 + m22)  # 2*w
    qx = _sqrt(1.0 + m00 - m11 - m22)  # 2*x
    qy = _sqrt(1.0 - m00 + m11 - m22)  # 2*y
    qz = _sqrt(1.0 - m00 - m11 + m22)  # 2*z

    cand_w = torch.stack([qw * qw, m21 - m12, m02 - m20, m10 - m01], -1) / (2 * qw[..., None])
    cand_x = torch.stack([m21 - m12, qx * qx, m01 + m10, m02 + m20], -1) / (2 * qx[..., None])
    cand_y = torch.stack([m02 - m20, m01 + m10, qy * qy, m12 + m21], -1) / (2 * qy[..., None])
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz * qz], -1) / (2 * qz[..., None])

    best = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)  # (..., 4cand, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def axis_angle_to_quat(aa: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4) wxyz, with the Taylor
    branch near the zero angle."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = sq < eps * eps
    safe = torch.sqrt(torch.clamp(sq, min=eps * eps))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * safe) / safe)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * safe))
    return torch.cat([w, aa * k], dim=-1)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3)."""
    return quat_to_matrix(axis_angle_to_quat(aa))


def quat_flip_axis_rotate(R: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate quaternions q by R under the flipped-axis convention:
    matrix_to_quat(F @ R @ F @ quat_to_matrix(q)) with F = diag(1, -1, -1)."""
    F = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=R.dtype,
                                device=R.device))
    return matrix_to_quat(F @ (R @ (F @ quat_to_matrix(q))))


def _apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('...ij,...j->...i') with broadcasting over the batch dims."""
    return (rot @ v[..., None])[..., 0]


class RigidTransform(NamedTuple):
    """A batch of SE(3) transforms: rot (..., 3, 3), trans (..., 3)."""

    rot: torch.Tensor
    trans: torch.Tensor

    @staticmethod
    def from_trans(trans: torch.Tensor) -> "RigidTransform":
        eye = torch.eye(3, dtype=trans.dtype, device=trans.device)
        return RigidTransform(eye.expand(trans.shape[:-1] + (3, 3)), trans)

    @staticmethod
    def from_se3(mat: torch.Tensor) -> "RigidTransform":
        return RigidTransform(mat[..., :3, :3], mat[..., :3, 3])

    def inverse(self) -> "RigidTransform":
        rt = self.rot.transpose(-1, -2)
        return RigidTransform(rt, -_apply(rt, self.trans))

    def compose(self, *others: "RigidTransform") -> "RigidTransform":
        """self applied first, then each of ``others`` in order."""
        rot, trans = self.rot, self.trans
        for o in others:
            trans = _apply(o.rot, trans) + o.trans
            rot = o.rot @ rot
        return RigidTransform(rot, trans)

    def index(self, indices: torch.Tensor) -> "RigidTransform":
        return RigidTransform(self.rot[indices], self.trans[indices])

    def weight(self, weights: torch.Tensor) -> "RigidTransform":
        """Blend a (J,)-batch of transforms with (N, J) weights -> (N,)-batch
        (linear blend of the matrices: standard LBS)."""
        J = weights.shape[-1]
        rot = (weights @ self.rot.reshape(J, 9)).reshape(-1, 3, 3)
        trans = weights @ self.trans
        return RigidTransform(rot, trans)

    def transform_points(
        self,
        points: torch.Tensor,
        indices: Optional[torch.Tensor] = None,
        weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        t = self
        if indices is not None:
            t = t.index(indices)
        if weights is not None:
            t = t.weight(weights)
        return _apply(t.rot, points) + t.trans

    def transform_quaternions(
        self,
        quaternions: torch.Tensor,
        indices: Optional[torch.Tensor] = None,
        weights: Optional[torch.Tensor] = None,
        flip_rotation_axis: bool = False,
        rotation_mode: str = "quaternion",
    ) -> torch.Tensor:
        """Rotate orientation quaternions by this transform's rotation part;
        'quaternion' multiplies by the rotation's quaternion, 'matrix'
        round-trips through matrices. Ignored when ``flip_rotation_axis``."""
        t = self
        if indices is not None:
            t = t.index(indices)
        if weights is not None:
            t = t.weight(weights)
        if flip_rotation_axis:
            return quat_flip_axis_rotate(t.rot, quaternions)
        if rotation_mode == "matrix":
            return matrix_to_quat(t.rot @ quat_to_matrix(quaternions))
        if rotation_mode != "quaternion":
            raise ValueError(f"unknown rotation_mode {rotation_mode!r}")
        return quat_multiply(matrix_to_quat(t.rot), quaternions)


def transform_points_homogeneous(mat: torch.Tensor, points: torch.Tensor):
    """(..., 4, 4) applied to (..., 3) points. Returns (the divided points
    (..., 3), w (...,)); a |w| below 1e-8 divides by 1e-8 of w's sign."""
    p = torch.einsum("...ij,...j->...i", mat[..., :3, :3], points) \
        + mat[..., :3, 3]
    w = torch.einsum("...j,...j->...", mat[..., 3, :3], points) \
        + mat[..., 3, 3]
    tiny = torch.where(w < 0, -1e-8, 1e-8).to(w.dtype)
    w_safe = torch.where(w.abs() < 1e-8, tiny, w)
    return p / w_safe[..., None], w


def look_at_rotation(forward: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Rows-are-axes camera rotation from forward/up (both (..., 3))."""
    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-12)

    f = unit(forward)
    r = unit(torch.linalg.cross(f, up))
    u = unit(torch.linalg.cross(r, f))
    return torch.stack([r, u, f], dim=-1)

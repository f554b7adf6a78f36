"""Pose-conditioned non-rigid deformation network.

Port of ``dreamwaltz_g_tpu/human/deform.py``: an MLP over (position features
(+) body_pose[63]) emitting per-gaussian (offset, scale, quaternion) deltas,
with leaky-ReLU (slope 0.01), the optional skip-concat layout and the
optional 6-DoF screw-axis offset head. Layer names are Flax's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nerf.encoder import frequency_encode
from ..nerf.network import init_dense


def skew(w: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[:, 0])
    rows = torch.stack([z, -w[:, 2], w[:, 1],
                        w[:, 2], z, -w[:, 0],
                        -w[:, 1], w[:, 0], z], dim=-1)
    return rows.reshape(-1, 3, 3)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (N, 3) axis + (N, 1) angle -> (N, 3, 3)."""
    W = skew(w)
    W2 = W @ W
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye[None] + s * W + (1.0 - c) * W2


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw-axis exponential, (N, 6) + (N, 1) -> (N, 4, 4)."""
    w, v = S[:, :3], S[:, 3:]
    W = skew(w)
    W2 = W @ W
    R = exp_so3(w, theta)
    th = theta.reshape(-1, 1, 1)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    G = th * eye[None] + (1.0 - torch.cos(th)) * W + (th - torch.sin(th)) * W2
    p = G @ v[..., None]
    top = torch.cat([R, p], dim=-1)                                 # (N, 3, 4)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=S.dtype,
                          device=S.device).expand(S.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


class DeformNetwork(nn.Module):
    """MLP (``depth`` layers, ``width``) with three output heads.

    ``xyz_input_ch=None`` frequency-encodes raw (N, 3) positions
    (``freq_degree`` 10) inside the net; otherwise the input is the field
    encoding of that width."""

    def __init__(self, xyz_input_ch: Optional[int] = 32, depth: int = 4,
                 width: int = 64, pose_ch: int = 63, freq_degree: int = 10,
                 residual: bool = False, is_6dof: bool = False, device=None):
        super().__init__()
        self.xyz_input_ch = xyz_input_ch
        self.depth = depth
        self.pose_ch = pose_ch
        self.freq_degree = freq_degree
        self.residual = residual
        self.is_6dof = is_6dof
        xyz_dim = 3 * (2 * freq_degree + 1) if xyz_input_ch is None \
            else xyz_input_ch
        in_dim = xyz_dim + pose_ch
        h_dim = in_dim
        for i in range(depth):
            self.add_module(f"dense_{i}", nn.Linear(h_dim, width, device=device))
            h_dim = width
            if residual and i == depth // 2:
                h_dim = in_dim + width
        for name in self._heads():
            out = 4 if name == "head_quat" else 3
            self.add_module(name, nn.Linear(h_dim, out, device=device))

    def _heads(self):
        heads = ("branch_w", "branch_v") if self.is_6dof else ("head_offset",)
        return heads + ("head_scale", "head_quat")

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.depth):
            init_dense(getattr(self, f"dense_{i}"), generator)
        for name in self._heads():
            init_dense(getattr(self, name), generator, std=1e-4)

    def forward(self, xyz_feats: torch.Tensor, body_pose: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = xyz_feats.shape[0]
        if self.xyz_input_ch is None:
            xyz_feats = frequency_encode(xyz_feats, degree=self.freq_degree)
        pose = body_pose.reshape(1, -1).expand(n, self.pose_ch)
        inp = torch.cat([xyz_feats, pose], dim=-1)
        h = inp
        for i in range(self.depth):
            h = nn.functional.leaky_relu(getattr(self, f"dense_{i}")(h), 0.01)
            if self.residual and i == self.depth // 2:
                h = torch.cat([inp, h], dim=-1)
        if self.is_6dof:
            w = self.branch_w(h)
            v = self.branch_v(h)
            theta = torch.linalg.norm(w, dim=-1, keepdim=True)
            # the reference adds the epsilon AFTER normalizing (kept as is)
            w = w / theta + 1e-5
            v = v / theta + 1e-5
            offsets = exp_se3(torch.cat([w, v], dim=-1), theta)
        else:
            offsets = self.head_offset(h)
        return offsets, self.head_scale(h), self.head_quat(h)

"""VPoser v2 body-pose prior: the decoder.

Port of ``dreamwaltz_g_tpu/human/vposer.py``. Only the decoder is needed
(sampling): z (B, 32) -> 6D rotations per joint -> axis-angle (B, 63).
Weights come from the released V02_05 snapshot (``vposer_from_torch`` takes
its ``decoder_net.{1,3,5}`` state dict as it is; ``load_vposer`` reads a
pre-converted ``.npz`` or the ``.ckpt``). ``VPoser.sample_body_fn`` is the
adapter for ``SMPLPrompt(sample_body_fn=...)``; the trainer, like the JAX
trainer, does not hand one in.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

NUM_JOINTS = 21
LATENT_DIM = 32


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation -> (..., 3, 3), the columns
    the Gram-Schmidt frame of the two 3-vectors (Zhou et al.)."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    b2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True),
                          min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) axis-angle."""
    tr = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2,
                     -1 + 1e-7, 1 - 1e-7)
    angle = torch.arccos(tr)
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-8)
    return axis * angle[..., None]


class VPoserDecoder(nn.Module):
    """V02_05 decoder: 32 -> 512 -> 512 -> 21 * 6 (6D rotations), leaky
    ReLU 0.2 between; ``net.{1,3,5}`` are the snapshot's
    ``decoder_net.{1,3,5}``."""

    def __init__(self, hidden: int = 512, device=None):
        super().__init__()
        self.net = nn.ModuleDict({
            "1": nn.Linear(LATENT_DIM, hidden, device=device),
            "3": nn.Linear(hidden, hidden, device=device),
            "5": nn.Linear(hidden, NUM_JOINTS * 6, device=device)})

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.net["1"](z), 0.2)
        x = F.leaky_relu(self.net["3"](x), 0.2)
        x = self.net["5"](x)
        R = rot6d_to_matrix(x.reshape(-1, NUM_JOINTS, 6))
        return matrix_to_axis_angle(R).reshape(-1, NUM_JOINTS * 3)


class VPoser:
    """The decoder and its latent prior."""

    def __init__(self, decoder: Optional[VPoserDecoder] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.decoder = decoder if decoder is not None \
            else VPoserDecoder(device=self.device)
        self.decoder.requires_grad_(False)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.device, torch.float32))

    def sample(self, generator: torch.Generator, batch_size: int = 1
               ) -> torch.Tensor:
        """(B, 63) body pose from the latent prior: z a standard normal
        draw from ``generator``."""
        z = torch.randn((batch_size, LATENT_DIM), generator=generator,
                        device=self.device)
        return self.decode(z)

    def sample_body_fn(self):
        """Adapter for ``SMPLPrompt(sample_body_fn=...)``."""
        return lambda generator, batch_size: self.sample(generator,
                                                         batch_size)


def vposer_from_torch(state_dict, device="cuda") -> VPoser:
    """The released VPoser V02_05 decoder (``decoder_net.{1,3,5}.{weight,
    bias}``, human_body_prior's names) as a ``VPoser``."""
    device = resolve_device(device)
    dec = VPoserDecoder(device=device)
    with torch.no_grad():
        for i in ("1", "3", "5"):
            for k in ("weight", "bias"):
                getattr(dec.net[i], k).copy_(torch.as_tensor(
                    np.asarray(state_dict[f"decoder_net.{i}.{k}"],
                               np.float32)))
    return VPoser(dec, device=device)


def load_vposer(path: Optional[str] = None, device="cuda"
                ) -> Optional[VPoser]:
    """Load from a pre-converted ``.npz`` or the torch ``.ckpt`` (read with
    ``weights_only=True``); None when the path is absent."""
    if path is None or not osp.exists(path):
        return None
    if path.endswith(".npz"):
        with np.load(path) as data:
            sd = {k: data[k] for k in data.files}
        return vposer_from_torch(sd, device=device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.replace("vp_model.", ""): v.numpy() for k, v in sd.items()
          if "decoder" in k}
    return vposer_from_torch(sd, device=device)

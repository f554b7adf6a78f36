"""CLIP R-Precision: the paper's quantitative eval protocol.

Port of ``dreamwaltz_g_tpu/utils/r_precision.py``: given N rendered frames
and N prompts, embed both with CLIP and count how often an image's own
prompt ranks first. The image tower is a ViT on the port's CLIP layer
(``guidance/clip_text.CLIPLayer``), the text tower the port's
``CLIPTextModel`` with its EOS pooling and a projection. Both run in
float32 with plain einsum attention, as in the JAX package, where no TPU
kernel computes them.

Module and parameter names are transformers' ``CLIPModel``'s
(``vision_model.embeddings.patch_embedding``, ``vision_model.pre_layrnorm``,
``visual_projection``, ``text_model.*``, ``text_projection``), so the
weights load from a transformers CLIP directory (``model.safetensors`` or
``pytorch_model.bin``, ``vocab.json``, ``merges.txt``) through the port's
own readers (``load_r_precision``). The towers' sizes are the JAX
package's defaults: ViT-B/32 (224^2, patch 32, 768 wide, 12 layers,
projection 512) and ``CLIPTextConfig()`` with a 512 projection.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..guidance.clip_text import (
    CLIPLayer,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTokenizer,
    tiny_text_config,
)
from ..guidance.sds import resize_images

# openai CLIP pixel normalization
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


class CLIPVisionConfig(NamedTuple):
    image_size: int = 224
    patch_size: int = 32         # ViT-B/32; 16 for B/16, 14 for L/14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    projection_dim: int = 512
    activation: str = "quick_gelu"

    @property
    def text_like(self) -> CLIPTextConfig:
        """The text encoder's layer configuration at this width."""
        return CLIPTextConfig(hidden_size=self.hidden_size,
                              num_layers=self.num_layers,
                              num_heads=self.num_heads,
                              activation=self.activation)


def tiny_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                            num_layers=2, num_heads=2, projection_dim=16)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, d)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg)
                                    for _ in range(cfg.num_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = _Encoder(cfg.text_like)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """ViT image tower -> projected embedding (B, projection_dim)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size,
                                           cfg.projection_dim, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: Linear and patch weights
        N(0, 1/fan_in), biases 0, norm scales 1, the class and position
        embeddings N(0, 0.02^2) (the JAX package's initialiser)."""
        def randn(t, std):
            return torch.randn(t.shape, generator=generator, device=t.device,
                               dtype=t.dtype) * std

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    w = m.weight
                    w.copy_(randn(w, w[0].numel() ** -0.5))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            emb = self.vision_model.embeddings
            for t in (emb.class_embedding, emb.position_embedding.weight):
                t.copy_(randn(t, 0.02))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3) CLIP-normalized."""
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2))
        B, D = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(B, 1, D), x], dim=1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, 0.0)        # no mask
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


class CLIPTextTower(CLIPTextModel):
    """Text encoder + EOS pooling + projection (the retrieval side)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(),
                 projection_dim: int = 512):
        super().__init__(cfg._replace(projection_dim=projection_dim))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return super().forward(input_ids, mode="penultimate_pooled")[1]


def preprocess_images(images, size: int = 224, device="cuda"
                      ) -> torch.Tensor:
    """(B, H, W, 3) float [0, 1] (array-like or a tensor) -> CLIP-normalized
    (B, size, size, 3) on ``device``, resized as ``jax.image.resize(...,
    'bilinear')`` resizes (antialiased when it shrinks)."""
    if not isinstance(images, torch.Tensor):
        images = np.asarray(images)
    x = torch.as_tensor(images, dtype=torch.float32,
                        device=resolve_device(device))
    if x.shape[1] != size or x.shape[2] != size:
        x = resize_images(x, size, size)
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class RPrecision:
    """The two towers on one device (moved there at construction), and the
    tokenizer for prompts given as text."""

    def __init__(self, vision: CLIPVisionModel, text: CLIPTextTower,
                 tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.vision = vision.to(self.device).eval()
        self.text = text.to(self.device).eval()
        self.tokenizer = tokenizer

    @torch.no_grad()
    def image_features(self, images) -> torch.Tensor:
        x = preprocess_images(images, self.vision.cfg.image_size,
                              self.device)
        f = self.vision(x)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    @torch.no_grad()
    def text_features(self, texts_or_ids) -> torch.Tensor:
        if self.tokenizer is not None and isinstance(texts_or_ids[0], str):
            ids = self.tokenizer(list(texts_or_ids))
        else:
            ids = texts_or_ids
        f = self.text(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                      device=self.device))
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def retrieve(self, images, texts_or_ids, top_k: int = 1) -> float:
        """The fraction of images whose own prompt ranks in the top k."""
        sim = self.image_features(images) @ self.text_features(
            texts_or_ids).T                                  # (B, B)
        rank = torch.argsort(-sim, dim=-1, stable=True)[:, :top_k]
        own = torch.arange(sim.shape[0], device=sim.device)[:, None]
        return float(torch.any(rank == own, dim=-1).float().mean())


def make_tiny_r_precision(generator: torch.Generator, device="cuda"
                          ) -> RPrecision:
    """Random tiny towers (drawn from ``generator``, on ``device``), to
    exercise the pipeline: the score means nothing."""
    device = resolve_device(device)
    vc = tiny_vision_config()
    vision = CLIPVisionModel(vc).to(device)
    text = CLIPTextTower(tiny_text_config(), vc.projection_dim).to(device)
    vision.reset_parameters(generator)
    text.reset_parameters(generator)
    return RPrecision(vision, text, device=device)


def load_r_precision(directory, device="cuda") -> Optional[RPrecision]:
    """The towers of a transformers CLIP directory (one weights file with
    ``vision_model.*``, ``visual_projection.*``, ``text_model.*`` and
    ``text_projection.*``; ``vocab.json`` and ``merges.txt``) at the
    default sizes; None when the directory has no weights file. A file that
    does not match the towers raises."""
    from ..guidance.convert import (
        _weights_file,
        load_state_dict_into,
        load_torch_state_dict,
    )

    directory = Path(directory)
    try:
        path = _weights_file(str(directory))
    except FileNotFoundError:
        return None
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if k != "logit_scale"}
    vision, text = CLIPVisionModel(), CLIPTextTower()
    load_state_dict_into(vision, {
        k: v for k, v in sd.items()
        if k.startswith(("vision_model.", "visual_projection."))})
    load_state_dict_into(text, {
        k: v for k, v in sd.items()
        if k.startswith(("text_model.", "text_projection."))})
    tok = CLIPTokenizer(str(directory / "vocab.json"),
                        str(directory / "merges.txt"))
    return RPrecision(vision, text, tokenizer=tok, device=device)

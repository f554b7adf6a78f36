"""Shared building blocks of the Stable Diffusion stack.

Port of ``dreamwaltz_g_tpu/guidance/layers.py``: resnet blocks, the spatial
transformer with self and cross attention, up/down sampling and the
sinusoidal time embedding. Module and parameter names are diffusers' own
(``transformer_blocks.0.attn1.to_out.0``), so converted Flax weights and a
later diffusers checkpoint load by name.

Inside the stack activations are NCHW, as ``nn.Conv2d`` takes them; the
models' public ``forward``s (``unet.py``, ``controlnet.py``, ``vae.py``)
take and return the JAX package's NHWC.

The long self-attention layers go through the flash-attention kernel
(``flash.py``, TPU kernel B4) as ``FLASH_ATTENTION`` says: ``"auto"`` (the
default) takes it iff the tensors lie on a CUDA device, where the JAX
package takes it iff it runs on a TPU; ``"on"`` always (on CPU tensors that
is the kernel's plain version, which is how the CPU tests reach the path);
``"off"`` never. Cross-attention, layers shorter than ``FLASH_MIN_SEQ`` and
head dimensions outside the kernel's domain stay on the einsum path. There
is no compile probe: on a CUDA tensor the kernel launches or the call
raises.

Tensor parallelism (``parallel/tp.py``): an ``Attention`` or a GEGLU
feed-forward whose ``tp_group`` is set holds its rank's slice of the
weights. Its input enters through ``copy_to_model`` (forward identity,
backward all-reduce of the gradient over the model group) and its
row-parallel output leaves through ``reduce_from_model`` (forward
all-reduce, backward identity), the output bias added once after the sum:
the image gradient stays whole for the families that differentiate
through the stack. Self-attention then runs this rank's heads, through the
flash kernel where the gate takes it. With no group set nothing changes.

Types: by default a model runs in its weights' type, its inputs cast to it
(``model_input``). Under ``jax_promotion()`` the inputs keep their own
types and each ``Linear``, ``Conv2d``, ``GroupNorm`` and ``LayerNorm`` of
the stack, and the attention products, compute in the promotion of their
operands' types (``promote``), as Flax's ``promote_dtype`` and
``jnp.einsum`` do: a float32 activation against bf16 weights computes in
float32. That is the JAX package's arithmetic at bf16, for holding the port
to it; the card keeps the default.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .flash import MAX_HEAD_DIM, flash_self_attention

#: flash-attention policy of the long self-attention layers: "auto" (flash
#: iff the tensors are on a CUDA device), "on" or "off"
FLASH_ATTENTION = "auto"
FLASH_MIN_SEQ = 1024


def _flash_enabled(n_q: int, n_k: int, head_dim: int,
                   device: torch.device) -> bool:
    """The JAX package's gate: self-attention over at least
    ``FLASH_MIN_SEQ`` tokens, a multiple of 128, with a head dimension of
    at most 128 or a multiple of 128 (SD1.5's 160-wide layers are short).
    One difference by design: a head wider than the kernels'
    ``MAX_HEAD_DIM`` takes the einsum path, which computes the same
    function, where the JAX package runs its Pallas kernel."""
    if FLASH_ATTENTION == "off":
        return False
    if n_q < FLASH_MIN_SEQ or n_q % 128 or n_k != n_q:
        return False
    if (head_dim > 128 and head_dim % 128) or head_dim > MAX_HEAD_DIM:
        return False
    if FLASH_ATTENTION == "on":
        return True
    return torch.device(device).type == "cuda"


_JAX_PROMOTION = False


@contextlib.contextmanager
def jax_promotion(enabled: bool = True) -> Iterator[None]:
    """Within: the JAX package's types (module docstring), when
    ``enabled``."""
    global _JAX_PROMOTION
    old, _JAX_PROMOTION = _JAX_PROMOTION, bool(enabled)
    try:
        yield
    finally:
        _JAX_PROMOTION = old


def promote(*tensors: Optional[torch.Tensor]):
    """The tensors (None passes through) in their common promoted type under
    ``jax_promotion``, else as they are: a layer's input and parameters go
    through here."""
    if not _JAX_PROMOTION:
        return tensors
    dt = functools.reduce(torch.promote_types,
                          [t.dtype for t in tensors if t is not None])
    return tuple(None if t is None else t.to(dt) for t in tensors)


def model_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A model's input in the weights' ``dtype``; under ``jax_promotion`` in
    its own type, as the JAX package casts none."""
    return x if _JAX_PROMOTION else x.to(dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(*promote(x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(*promote(x, self.weight, self.bias))


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        return F.group_norm(x, self.num_groups, w, b, self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class _CopyToModel(torch.autograd.Function):
    """Forward identity; backward all-reduce over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward all-reduce over the model group; backward identity."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input (module docstring)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's summed output (module docstring)."""
    return _ReduceFromModel.apply(x, group)


def row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)`` of a row-parallel layer: this rank's partial product,
    all-reduced over ``group``, then the (replicated) bias, once."""
    x, w, b = promote(x, linear.weight, linear.bias)
    y = reduce_from_model(F.linear(x, w), group)
    return y if b is None else y + b


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embeddings, diffusers ``get_timestep_embedding``
    semantics; float32 (B, dim)."""
    half = dim // 2
    dev = timesteps.device
    exponent = -torch.log(torch.tensor(max_period, device=dev)) \
        * torch.arange(half, dtype=torch.float32, device=dev)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin], -1) if flip_sin_to_cos \
        else torch.cat([sin, cos], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _group_norm(channels: int, eps: float, groups: int = 32) -> GroupNorm:
    return GroupNorm(min(groups, channels), channels, eps=eps)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> conv, plus the projected time embedding, twice;
    a 1x1 shortcut when the channels change. ``temb_channels=None`` drops
    the time conditioning (the VAE's resnets); ``eps`` is the GroupNorm
    epsilon (1e-5 in the UNet, 1e-6 in the VAE)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = _group_norm(in_channels, eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = _group_norm(out_channels, eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over (B, N, C) tokens; cross-attention when
    ``context`` is given. Scores are softmaxed in float32 and cast back to
    the input type, as the JAX package does; gated self-attention takes the
    flash kernel on (B, N, H, D) views of the projections."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, inner)])
        self.tp_group = None

    def forward(self, x, context=None):
        tp = self.tp_group
        if tp is not None:
            x = copy_to_model(x, tp)
            if context is not None:
                context = copy_to_model(context, tp)
        context = x if context is None else context
        B, Nq, _ = x.shape
        Nk = context.shape[1]
        H, D = self.heads, self.head_dim
        q, k, v = promote(self.to_q(x).reshape(B, Nq, H, D),
                          self.to_k(context).reshape(B, Nk, H, D),
                          self.to_v(context).reshape(B, Nk, H, D))
        if _flash_enabled(Nq, Nk, D, x.device):
            out = flash_self_attention(q, k, v).reshape(B, Nq, H * D)
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(
                B, Nq, H * D)
        if tp is not None:
            return row_parallel(self.to_out[0], out, tp)
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward; the gate's GELU is the tanh approximation, as
    Flax's ``nn.gelu`` computes it by default."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])
        self.tp_group = None

    def forward(self, x):
        tp = self.tp_group
        if tp is not None:
            x = copy_to_model(x, tp)
        a, g = self.net[0].proj(x).chunk(2, dim=-1)
        h = a * F.gelu(g, approximate="tanh")
        if tp is not None:
            return row_parallel(self.net[2], h, tp)
        return self.net[2](h)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> 1x1 in -> transformer block(s) -> 1x1 out, residual."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = _group_norm(channels, 1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim)
            for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with symmetric padding 1 (the JAX package's; the
    diffusers VAE pads (0, 1) instead)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsampling, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class AttnBlockVAE(nn.Module):
    """Single-head spatial self-attention of the VAE mid block. On the
    einsum path its softmax runs in the input type; on the flash path the
    scores and the softmax are float32, as in the JAX package."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _group_norm(channels, 1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        if _flash_enabled(H * W, H * W, C, x.device):
            h = flash_self_attention(q[:, :, None, :], k[:, :, None, :],
                                     v[:, :, None, :])[:, :, 0]
        else:
            attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k)
                                 / math.sqrt(C), dim=-1)
            h = torch.einsum("bqk,bkc->bqc", attn, v)
        h = self.to_out[0](h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights in place, every draw from ``generator``: Linear and
    Conv2d weights N(0, 1/fan_in) (Flax's LeCun-normal scale), drawn in the
    parameter's own type and device, so a bf16 model on the card never holds
    a float32 copy; biases 0, norm scales 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype,
                                device=w.device))
            w.mul_(fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def build(make, device, dtype=torch.float32,
          generator: Optional[torch.Generator] = None) -> nn.Module:
    """Construct ``make()`` without allocating, then materialise it on
    ``device`` in ``dtype``, frozen (no parameter requires a gradient), and
    draw its weights from ``generator`` when one is given (else they stay
    uninitialised, for a loader to fill)."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype).to_empty(device=device)
    module.requires_grad_(False)
    if generator is not None:
        init_weights(module, generator)
    return module.eval()

"""Flash self-attention: softmax(Q K^T / sqrt(D)) V over (B, N, H, D) tensors
without the N x N scores in device memory.

Port of the kernel path of ``dreamwaltz_g_tpu/guidance/layers.py``
(``_flash_kernel`` / ``flash_self_attention``, TPU kernel B4). On CUDA
tensors ``flash_attn_fwd`` / ``flash_attn_bwd`` launch the hand-written
kernels of ``csrc/flash_attn.cu``, but for the bf16 forward at
``HOPPER_WIDTHS`` (SD1.5's 40-wide heads at its 64^2 latents and 80-wide
ones at 32^2, SDXL's and SD2.x's 64-wide ones), which ``_fwd_route`` sends
to ``flash_fwd_hopper`` (``csrc/flash_fwd_hopper.cu``: TMA copies and
wgmma products, the same roundings; a view at those widths that TMA cannot
describe raises). Each of the two forward wrappers counts its own
launches. bf16 runs through the tensor cores; float32 through them too,
each product as three TF32 products, whose plain twins are
``flash_attention_tf32_plain`` and ``flash_attention_tf32_plain_bwd``.
Scores and softmax stay in registers and K and V stream through a ring of
asynchronous copies, as the source's header note sets out. On CPU tensors
the wrappers take the plain versions below. There is no compile probe and
no fallback: a CUDA tensor launches the kernel or the call raises.

The bf16 forward at D > 128 (the VAE's mid block, D = 512) cuts the keys
into ``WIDE_KEY_SPLITS`` ranges, one block's work each, and merges their
partial outputs in a second kernel; ``flash_attention_split_plain`` and
``combine_key_splits`` are that merge's plain twin. The bf16 backward there
is a dK / dV pass that also writes dSᵀ to (B, H, N, N) bf16 scratch, then
the product dQ = scale dS K; ``flash_attention_wide_bwd_plain`` and
``dq_from_ds_plain`` are its plain twin.

The kernels' domain is the dispatch gate's (``layers._flash_enabled``):
self-attention, N a multiple of 128, D <= 128 or a multiple of 128, and
D <= ``MAX_HEAD_DIM`` (one block's shared memory). Tensors need unit stride
along D only: a (B, N, H, D) view of a projection's output is taken by its
strides, without a copy.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

#: key ranges of the bf16 forward at D > 128: at (1, 4096, 1, 512) its
#: 64-row blocks number 64, and two ranges give 128 blocks for the H100's
#: 132 SMs
WIDE_KEY_SPLITS = 2
#: the widest head the kernels take (a 512-wide tile of K and V fills one
#: block's shared memory); the modules' gate sends wider heads to einsum
MAX_HEAD_DIM = 512
#: the head widths of the bf16 forward on ``csrc/flash_fwd_hopper.cu``
HOPPER_WIDTHS = (40, 64, 80)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: float32 scores and softmax. Returns
    ``out`` (B, N, H, D) in q's type and ``lse`` (B, H, N) float32, the log
    of each row's sum of exp(scaled scores)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_attention_rounded_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """The plain forward with the bf16 kernels' two rounding points: the
    normalised probabilities rounded to q's type once, their product with
    V summed in float32, and the output rounded once. Only the roundings'
    error is in it, which is what the bf16 forwards' per-element limits
    bound (``tests/test_torch_flash_gpu.py``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_split_plain(q, k, v, splits: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version over ``splits`` equal key ranges, each on its own:
    float32 ``o_part`` (splits, B, N, H, D), each range's normalised output,
    and ``lse_part`` (splits, B, H, N), each range's lse; what the wide
    forward's blocks write before ``combine_key_splits``."""
    N = k.shape[1]
    if N % splits:
        raise ValueError(f"N = {N} does not split into {splits} ranges")
    n = N // splits
    parts = [flash_attention_plain(q.float(), k[:, i * n:(i + 1) * n].float(),
                                   v[:, i * n:(i + 1) * n].float())
             for i in range(splits)]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([lse for _, lse in parts]))


def combine_key_splits(o_part: torch.Tensor, lse_part: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-range softmax results: ``lse = log sum_s exp(lse_s)`` and
    ``out = sum_s exp(lse_s - lse) O_s`` (float32), as the wide forward's
    combine kernel does before it rounds ``out`` once."""
    lse = torch.logsumexp(lse_part, dim=0)
    w = torch.exp(lse_part - lse).permute(0, 1, 3, 2)[..., None]
    return (w * o_part).sum(0), lse


def _probs_and_ds(q, k, v, out, lse, d_out):
    """The backward's float32 ``P = exp(S - lse)`` and ``dS = P (dP -
    delta)``, ``delta = rowsum(d_out * out)``, both (B, H, N queries, N
    keys)."""
    scale = q.shape[-1] ** -0.5
    gf = d_out.float()
    delta = (gf * out.float()).sum(-1).permute(0, 2, 1)          # (B, H, N)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                  * scale - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_plain_bwd(q, k, v, out, lse, d_out
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward, from what the forward saved:
    ``delta = rowsum(d_out * out)``, ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P * (dP - delta)``, ``dQ = dS K * scale``,
    ``dK = dS^T Q * scale``; float32 throughout, results in q's type."""
    scale = q.shape[-1] ** -0.5
    p, ds = _probs_and_ds(q, k, v, out, lse, d_out)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, d_out.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_wide_bwd_plain(q, k, v, out, lse, d_out
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """The D > 128 bf16 backward's two stages, plain, with the kernels'
    rounding points: P and dS rounded to q's type once each; dV = Pᵀ dO and
    dK = scale dSᵀ Q from them (the dK / dV pass), and dSᵀ (B, H, N keys,
    N queries) as that pass writes it to scratch; then dQ from the scratch
    (``dq_from_ds_plain``). Returns (dq, dk, dv, ds_t)."""
    scale = q.shape[-1] ** -0.5
    p, ds = _probs_and_ds(q, k, v, out, lse, d_out)
    ds = ds.to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(),
                      d_out.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float()) * scale
    ds_t = ds.transpose(-1, -2).contiguous()
    return dq_from_ds_plain(ds_t, k), dk.to(q.dtype), dv.to(q.dtype), ds_t


def dq_from_ds_plain(ds_t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """dQ = scale dS K from the dK / dV pass's scratch ``ds_t`` (B, H,
    N keys, N queries), float32 sums, in k's type: the plain version of
    the D > 128 backward's product kernel."""
    scale = k.shape[-1] ** -0.5
    dq = torch.einsum("bhkq,bkhd->bqhd", ds_t.float(), k.float()) * scale
    return dq.to(k.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the 13
    dropped bits' range added to the magnitude, then those bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = ``tf32_round(x)``, lo = ``tf32_round(x - hi)``; hi + lo
    is x to within 2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _tf32_einsum(eq: str, a, b, passes: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` from TF32 pieces of the operands, float32 sums:
    ``passes`` 3 is the float32 kernels' lo·hi + hi·lo + hi·hi (lo·lo,
    below 2^-22 of each product, dropped), 1 a single TF32 product."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return torch.einsum(eq, a_hi, b_hi)
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, not {passes}")
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def flash_attention_tf32_plain(q, k, v, passes: int = 3
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the float32 forward with the kernel's products:
    S = Q Kᵀ and out = P V each from TF32 pieces (``_tf32_einsum``), the
    softmax in float32 as in ``flash_attention_plain``. ``passes=1`` is a
    single TF32 product, which the float32 tolerances tell apart from it.
    Returns float32 ``out`` (B, N, H, D) and ``lse`` (B, H, N)."""
    s = _tf32_einsum("bqhd,bkhd->bhqk", q, k, passes) * q.shape[-1] ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return _tf32_einsum("bhqk,bkhd->bqhd", p, v, passes), lse


def flash_attention_tf32_plain_bwd(q, k, v, out, lse, d_out, passes: int = 3
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version of the float32 backward with the kernels' products:
    S, dP, dV = Pᵀ dO, dQ = scale dS K and dK = scale dSᵀ Q each from TF32
    pieces, ``delta``, P and dS in float32 as in
    ``flash_attention_plain_bwd``. Returns float32 (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    gf = d_out.float()
    delta = (gf * out.float()).sum(-1).permute(0, 2, 1)
    p = torch.exp(_tf32_einsum("bqhd,bkhd->bhqk", q, k, passes) * scale
                  - lse[..., None])
    dp = _tf32_einsum("bqhd,bkhd->bhqk", gf, v, passes)
    ds = p * (dp - delta[..., None])
    dv = _tf32_einsum("bhqk,bqhd->bkhd", p, gf, passes)
    dq = _tf32_einsum("bhqk,bkhd->bqhd", ds, k, passes) * scale
    dk = _tf32_einsum("bhqk,bqhd->bkhd", ds, q, passes) * scale
    return dq, dk, dv


def _check(name: str, q, k, v) -> torch.device:
    """Raise on anything the kernels do not take; returns the device."""
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be (B, N, H, D), got "
                         f"{tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name}: self-attention only, q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} must have one shape")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: mixed types {q.dtype} {k.dtype} {v.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: bfloat16 or float32, not {q.dtype}")
    B, N, H, D = q.shape
    if N % 128:
        raise ValueError(f"{name}: N = {N} is not a multiple of 128")
    if D > 128 and D % 128:
        raise ValueError(f"{name}: D = {D} is above 128 and not a multiple "
                         "of 128")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: D = {D} is above {MAX_HEAD_DIM}, the "
                         "most one block's shared memory holds")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} is not contiguous along D "
                             f"(strides {t.stride()})")
    return dev


#: the kernel library of each launch function
_LIBRARY = {"flash_attn_fwd": "flash_attn", "flash_attn_bwd": "flash_attn",
            "flash_fwd_hopper": "flash_fwd_hopper"}


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    fn = getattr(kernels.load(_LIBRARY[fn_name]), fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() if torch.is_tensor(a) else a for a in args],
                stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _fwd_route(D: int, dtype: torch.dtype) -> str:
    """The forward kernel's launch function for head dimension ``D`` in
    ``dtype``: ``flash_fwd_hopper`` for bf16 at ``HOPPER_WIDTHS`` (the
    Hopper design, ``csrc/flash_fwd_hopper.cu``), ``flash_attn_fwd``
    (``csrc/flash_attn.cu``: the row-split, wide and float32 forwards) for
    every other pair."""
    return "flash_fwd_hopper" \
        if dtype == torch.bfloat16 and D in HOPPER_WIDTHS \
        else "flash_attn_fwd"


def _fwd_flash_attn(q, k, v, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/flash_attn.cu``'s forward for any (D, type) it takes (at
    D = 40, 64 and 80 in bf16 its row-split instantiations, off the main
    path), launched and not counted: ``flash_attn_fwd`` counts its own
    calls of it."""
    B, N, H, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    splits = WIDE_KEY_SPLITS if bf16 and D > 128 else 0
    o_part = lse_part = None
    if splits:
        o_part = torch.empty((splits, B, N, H, D), dtype=torch.float32,
                             device=dev)
        lse_part = torch.empty((splits, B, H, N), dtype=torch.float32,
                               device=dev)
    _launch("flash_attn_fwd", dev, q, k, v, out, lse, o_part, lse_part, B, N,
            H, D, *_strides(q, k, v), int(bf16), splits)
    return out, lse


def flash_fwd_hopper(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward at D = 40, 64 or 80 (``flash_attn_fwd``'s outputs)
    through ``csrc/flash_fwd_hopper.cu``; the plain version on CPU tensors.
    Raises on another type or width, and on a view whose base is not
    16-byte aligned or whose strides are not whole 16 bytes (what a TMA
    tensor map cannot describe): there is no other kernel to fall back
    to."""
    dev = _check("flash_fwd_hopper", q, k, v)
    B, N, H, D = q.shape
    if q.dtype != torch.bfloat16 or D not in HOPPER_WIDTHS:
        raise ValueError(f"flash_fwd_hopper: bf16 at D = 40, 64 or 80 only, "
                         f"not {q.dtype} at D = {D}")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v)
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_fwd_hopper: {n} (strides {t.stride()}, base "
                f"{t.data_ptr() % 16} bytes past 16) is not a view a TMA "
                "tensor map takes: a 16-byte aligned base and strides of "
                "whole 16 bytes")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    _launch("flash_fwd_hopper", dev, q, k, v, out, lse, B, N, H, D,
            *_strides(q, k, v))
    flash_fwd_hopper.launches += 1
    return out, lse


def flash_attn_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward: (out (B, N, H, D) in q's type, contiguous; lse (B, H, N)
    float32). Kernel on CUDA tensors, plain version on CPU tensors; bf16 at
    D = 40, 64 and 80 goes to ``flash_fwd_hopper`` (``_fwd_route``), which
    counts that launch, every other call to ``csrc/flash_attn.cu``, counted
    here."""
    dev = _check("flash_attn_fwd", q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v)
    if _fwd_route(q.shape[-1], q.dtype) == "flash_fwd_hopper":
        return flash_fwd_hopper(q, k, v)
    out, lse = _fwd_flash_attn(q, k, v, dev)
    flash_attn_fwd.launches += 1
    return out, lse


def flash_attn_bwd(q, k, v, out, lse, d_out
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's ``out`` and ``lse``: (dq, dk, dv),
    contiguous, in q's type. One call is one launch of the kernel group
    (delta, the dQ pass, the dK / dV pass; bf16 at D > 128: delta, the
    dK / dV pass writing dSᵀ to (B, H, N, N) bf16 scratch, 2 B H N² bytes,
    then the product dQ = scale dS K)."""
    dev = _check("flash_attn_bwd", q, k, v)
    B, N, H, D = q.shape
    for n, t, dtype in (("out", out, q.dtype), ("d_out", d_out, q.dtype)):
        if tuple(t.shape) != (B, N, H, D) or t.dtype != dtype \
                or t.device != dev:
            raise ValueError(f"flash_attn_bwd: {n} must be {(B, N, H, D)} "
                             f"{dtype} on {dev}")
    if tuple(lse.shape) != (B, H, N) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"flash_attn_bwd: lse must be {(B, H, N)} float32 "
                         f"on {dev}")
    if dev.type == "cpu":
        return flash_attention_plain_bwd(q, k, v, out, lse, d_out)
    for n, t in (("out", out), ("d_out", d_out), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attn_bwd: {n} must be contiguous")
    dq, dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=dev)
                  for _ in range(3))
    delta = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    bf16 = q.dtype == torch.bfloat16
    ds_t = torch.empty((B, H, N, N), dtype=q.dtype, device=dev) \
        if bf16 and D > 128 else None
    _launch("flash_attn_bwd", dev, q, k, v, out, lse, d_out, dq, dk, dv,
            delta, ds_t, B, N, H, D, *_strides(q, k, v), int(bf16))
    flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_fwd.launches = 0
flash_attn_bwd.launches = 0
flash_fwd_hopper.launches = 0


class FlashSelfAttention(torch.autograd.Function):
    """``flash_attn_fwd`` with ``flash_attn_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attn_bwd(q, k, v, out, lse, d_out.contiguous())


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """Fused attention over (B, N, H, D) tensors, differentiable; the
    scores are scaled by D^-1/2, with no mask."""
    return FlashSelfAttention.apply(q, k, v)

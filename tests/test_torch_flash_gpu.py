"""The flash-attention CUDA kernels (B4 forward and backward) against their
plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_flash_gpu.py -m gpu --noconftest -q

Tolerances, kernel vs plain version (float32 scores) on the same card
inputs:
* float32: 1e-5 absolute on the output and 1e-4 of each gradient's largest
  entry, the JAX package's own for its TPU kernel;
* bf16: the kernel rounds each probability and each output to bf16 once,
  at most 2^-8 relative a rounding. The output's rounding gives at most
  2^-8 |out|; the probabilities' roundings are independent over the keys
  and stay far inside their worst case 2^-8 sum_j p_j |v_j|. The limit is,
  per element, 2^-9 (sum_j p_j |v_j| + |out|): ~2e-3 where an output is
  ~0.03 to 0.25, so dropped keys or a wrong normalisation fail it. The
  gradients round P, dS and the result likewise and are held to 2^-6 of
  each gradient's largest entry.

The bf16 kernels have tile widths 48, 80, 128 and 512; the head dimensions
below cover each width exactly (80, 128, 512) and zero-padded (16 and 40 in
48, 64 in 80, 24 in 48 by the element-wise load, 256 in 512).
"""
import pytest
import torch

from dreamwaltz_g_tpu_torch.guidance import flash as FL
from dreamwaltz_g_tpu_torch.guidance import layers as TL

TOL_F32_OUT = 1e-5
TOL_F32_GRAD = 1e-4
TOL_BF16_OUT = 2.0 ** -9
TOL_BF16_GRAD = 2.0 ** -6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, shape, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def _hold(q, k, v, g):
    """Kernel forward and backward against the plain versions."""
    bf16 = q.dtype == torch.bfloat16
    out, lse = FL.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = FL.flash_attention_plain(q.float(), k.float(), v.float())
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    assert bool(torch.isfinite(out).all())
    if bf16:
        tol = TOL_BF16_OUT * (FL.flash_attention_plain(
            q.float(), k.float(), v.float().abs())[0] + ref.abs())
    else:
        tol = torch.full_like(ref, TOL_F32_OUT)
    assert bool(((out.float() - ref).abs() <= tol).all())
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    grads = FL.flash_attn_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    refs = FL.flash_attention_plain_bwd(q.float(), k.float(), v.float(),
                                        out.float(), lse, g.float())
    for got, want in zip(grads, refs):
        assert got.dtype == q.dtype and got.is_contiguous()
        rel = TOL_BF16_GRAD if bf16 else TOL_F32_GRAD
        assert float((got.float() - want).abs().max()) \
            <= rel * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 40, 64, 80, 128, 256, 512])
def test_kernel_matches_plain_over_head_dims(D, dtype):
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 1024, 2, D), dtype, seed=D)
    _hold(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,D", [(1152, 2, 40), (4096, 1, 80),
                                   (4096, 1, 512), (1152, 3, 24)])
def test_kernel_matches_plain_over_lengths(N, H, D, dtype):
    dev = _card()
    q, k, v, g = _qkv(dev, (2, N, H, D), dtype, seed=N + D)
    _hold(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_takes_views_of_a_fused_projection(dtype):
    """q, k, v as (B, N, H, D) views of one (B, N, 3 H D) projection: not
    contiguous, unit stride along D."""
    dev = _card()
    B, N, H, D = 2, 1024, 4, 40
    gen = torch.Generator(device=dev).manual_seed(3)
    fused = torch.randn((B, N, 3 * H * D), generator=gen,
                        device=dev).to(dtype)
    q, k, v = (x.reshape(B, N, H, D) for x in fused.chunk(3, dim=-1))
    assert not q.is_contiguous()
    g = torch.randn((B, N, H, D), generator=gen, device=dev).to(dtype)
    _hold(q, k, v, g)


@pytest.mark.gpu
def test_autograd_function_counts_launches_and_matches_einsum():
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 1024, 2, 64), torch.float32, seed=9)
    for t in (q, k, v):
        t.requires_grad_(True)
    FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
    out = FL.flash_self_attention(q, k, v)
    out.backward(g)
    assert (FL.flash_attn_fwd.launches, FL.flash_attn_bwd.launches) == (1, 1)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", a, v)
    ref.backward(g)
    assert float((out - ref).abs().max()) <= TOL_F32_OUT
    for a_, t in zip(got, (q, k, v)):
        assert float((a_ - t.grad).abs().max()) \
            <= TOL_F32_GRAD * float(t.grad.abs().max())


@pytest.mark.gpu
def test_modules_take_the_kernel_by_default_on_the_card():
    """FLASH_ATTENTION at its default: gated shapes launch the kernel on
    CUDA tensors, "off" never does, and the two paths agree."""
    dev = _card()
    assert TL.FLASH_ATTENTION == "auto"
    gen = torch.Generator(device=dev).manual_seed(1)
    attn = TL.build(lambda: TL.Attention(32, 2, 16), dev, generator=gen)
    vae = TL.build(lambda: TL.AttnBlockVAE(64), dev, generator=gen)
    x = torch.randn((1, 1024, 32), generator=gen, device=dev)
    img = torch.randn((1, 64, 32, 32), generator=gen, device=dev)
    ctx = torch.randn((1, 77, 32), generator=gen, device=dev)
    cross = TL.build(lambda: TL.Attention(32, 2, 16, 32), dev, generator=gen)
    FL.flash_attn_fwd.launches = 0
    a, b = attn(x), vae(img)
    assert FL.flash_attn_fwd.launches == 2
    cross(x, ctx)
    attn(x[:, :256])
    assert FL.flash_attn_fwd.launches == 2
    old = TL.FLASH_ATTENTION
    try:
        TL.FLASH_ATTENTION = "off"
        a_ref, b_ref = attn(x), vae(img)
    finally:
        TL.FLASH_ATTENTION = old
    assert FL.flash_attn_fwd.launches == 2
    assert float((a - a_ref).abs().max()) <= 1e-4 * float(a_ref.abs().max())
    assert float((b - b_ref).abs().max()) <= 1e-4 * float(b_ref.abs().max())


@pytest.mark.gpu
def test_wrapper_raises_outside_the_domain():
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 1024, 2, 40), torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        FL.flash_attn_fwd(q[:, :1000], k[:, :1000], v[:, :1000])
    with pytest.raises(ValueError, match="self-attention"):
        FL.flash_attn_fwd(q, k[:, :512], v[:, :512])
    with pytest.raises(ValueError, match="mixed types"):
        FL.flash_attn_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="several devices"):
        FL.flash_attn_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous along D"):
        FL.flash_attn_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        FL.flash_attn_fwd(q.half(), k.half(), v.half())
    big = torch.zeros((1, 128, 1, 160), device=dev)
    with pytest.raises(ValueError, match="not a multiple"):
        FL.flash_attn_fwd(big, big, big)

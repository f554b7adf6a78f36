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

The bf16 kernels of ``csrc/flash_attn.cu`` have tile widths 48, 64, 80,
128 and 512; the head dimensions below cover each width exactly (80, 128,
512) and zero-padded (16, 24 and 40 in 48, 256 and 384 in 512). D = 20
and a view that is not 16-byte aligned take the element-wise tile load
(the row-split forward called directly at D = 40 and 80). The bf16
forward at D = 40, 64 and 80 is the Hopper kernel's
(``csrc/flash_fwd_hopper.cu``: 128 query rows a block over two consumer
warpgroups, 128-key tiles through a TMA ring of 3 stages at D = 40 and 80
and 2 at D = 64; a tile's first 64 columns in one slab, zeros past
D = 40, and at D = 80 its last 16 in a second slab of 32-byte rows); it
raises on a view TMA cannot describe. At D = 40 N = 1152's 9 key tiles
end at the end of the ring and N = 1280's 10 part-way round it (at D = 64
N = 1152's end part-way round), at D = 80 N = 4096's 32 and N = 1024's 8
end part-way round it, N = 128 is one tile. The row-split forward
(D <= 128) streams 64-key tiles through a ring of 3 shared-memory stages
(2 at 64 and above 80): N = 128 has fewer key tiles than stages; every N
(a multiple of 128) gives an even count of tiles, and N = 1280's 20 end
part-way round the 3-stage ring, N = 1152's 18 at its end. The wide
forward (D > 128) takes 64 query rows a block, splits the keys in two
ranges of 32-key tiles through a 2-stage ring and merges the ranges in a
second kernel: N = 128
gives each range 2 tiles, N = 4096 64, and B H > 1 puts several heads and
batches in one grid. A late dominant key makes every row's maximum arrive
in the last tile (of the second key range, or of the first), and the
training step's own shapes fill the card from a cold cache. The wide
backward (D > 128) owns 32 keys a block and streams 32-query tiles of Q and
dO through a 2-stage ring, writing dSᵀ to scratch for a second kernel,
dQ = scale dS K, which walks the keys in 64-key steps through a 3-stage
ring: an upstream gradient on one query tile only, the last or the first,
shows a pass that skips or misreads a streamed tile; keys 4x as large in
one key tile, the last or the first, make that tile carry dQ.
"""
import pytest
import torch

from dreamwaltz_g_tpu_torch.guidance import flash as FL
from dreamwaltz_g_tpu_torch.guidance import layers as TL

TOL_F32_OUT = 1e-5
TOL_F32_GRAD = 1e-4
TOL_BF16_OUT = 2.0 ** -9
TOL_BF16_GRAD = 2.0 ** -6
# rows whose weight sits on a few keys: P's roundings do not spread over
# many keys, so the limit is their worst case with the output's, 2^-8
# (sum_j p_j |v_j| + |out|)
TOL_BF16_OUT_PEAKED = 2.0 ** -8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, shape, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def _hold_fwd(q, k, v, peaked=False, fwd=None):
    """Kernel forward (``fwd``, ``flash_attn_fwd`` by default) against the
    plain version; returns (out, lse). ``peaked``: rows whose weight sits
    on a few keys, held to the bf16 roundings' worst case
    (``TOL_BF16_OUT_PEAKED``)."""
    out, lse = (fwd or FL.flash_attn_fwd)(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = FL.flash_attention_plain(q.float(), k.float(), v.float())
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    assert bool(torch.isfinite(out).all())
    if q.dtype == torch.bfloat16:
        tol = (TOL_BF16_OUT_PEAKED if peaked else TOL_BF16_OUT) * (
            FL.flash_attention_plain(
                q.float(), k.float(), v.float().abs())[0] + ref.abs())
    else:
        tol = torch.full_like(ref, TOL_F32_OUT)
    assert bool(((out.float() - ref).abs() <= tol).all())
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    return out, lse


def _hold(q, k, v, g, fwd=None):
    """Kernel forward and backward against the plain versions."""
    _hold_bwd(q, k, v, g, *_hold_fwd(q, k, v, fwd=fwd))


def _hold_bwd(q, k, v, g, out, lse):
    """Kernel backward, from the forward's out and lse, against the plain
    version."""
    bf16 = q.dtype == torch.bfloat16
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
@pytest.mark.parametrize("D", [16, 40, 64, 80, 128, 256, 384, 512])
def test_kernel_matches_plain_over_head_dims(D, dtype):
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 1024, 2, D), dtype, seed=D)
    _hold(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,D", [(1152, 2, 40), (4096, 1, 80),
                                   (4096, 1, 512), (1152, 3, 24),
                                   (128, 2, 40), (128, 2, 80), (128, 1, 128),
                                   (1152, 2, 64), (1280, 2, 40),
                                   (1280, 1, 128), (1152, 2, 20),
                                   (128, 1, 512), (1024, 2, 512),
                                   (4096, 1, 256), (1152, 1, 384)])
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
@pytest.mark.parametrize("D", [40, 64, 80, 128])
def test_bf16_rescales_when_the_max_arrives_in_the_last_tile(D):
    """q scaled x8 with a positive first component, and the last key along
    that component: every row's largest score is its last, so each row's
    running maximum jumps in the last key tile and the output accumulated
    so far must be rescaled by 2^(m_old - m_new). The forward only: the
    last key takes nearly all of each row's weight, so the gradients
    cancel to ~1e-17 and say nothing of the kernel."""
    dev = _card()
    B, N, H = 1, 1024, 2
    q, k, v, _ = _qkv(dev, (B, N, H, D), torch.float32, seed=11 + D)
    q = 8 * q
    q[..., 0] = q[..., 0].abs() + 32
    k[:, -1] = 0
    k[:, -1, :, 0] = 2 * D ** 0.5
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    assert bool((s.argmax(-1) == N - 1).all())
    _hold_fwd(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("late", ["last", "first_range_last"])
def test_bf16_wide_rescales_when_the_max_arrives_late(late):
    """The wide forward at D = 512: the dominant key is the very last (the
    last tile of the second key range) or the last of the first range, so
    the running maximum jumps in a range's last tile, and in the second
    case the combine must give the first range nearly all the weight."""
    dev = _card()
    B, N, H, D = 1, 1024, 1, 512
    key = N - 1 if late == "last" else N // 2 - 1
    q, k, v, _ = _qkv(dev, (B, N, H, D), torch.float32, seed=13)
    q = 8 * q
    q[..., 0] = q[..., 0].abs() + 32
    k[:, key] = 0
    k[:, key, :, 0] = 2 * D ** 0.5
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    assert bool((s.argmax(-1) == key).all())
    _hold_fwd(q, k, v)


@pytest.mark.gpu
def test_bf16_wide_lse_and_the_backward_from_its_outputs():
    """At the VAE's (1, 4096, 1, 512): lse within 1e-5 of the plain
    version's (the kernel's ex2 and the combine's log add ~1e-6), and the
    backward, fed the wide forward's out and lse, within 2^-6 of each
    gradient's largest entry."""
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 4096, 1, 512), torch.bfloat16, seed=17)
    out, lse = FL.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    _, ref_lse = FL.flash_attention_plain(q.float(), k.float(), v.float())
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    _hold(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (2, 1024, 8, 80),
                                   (1, 4096, 1, 512), (2, 4096, 10, 64),
                                   (2, 1024, 20, 64), (2, 9216, 5, 64),
                                   (2, 2304, 10, 64), (8, 4096, 8, 40),
                                   (8, 1024, 8, 80)])
def test_bf16_at_the_training_steps_shapes_from_a_cold_cache(shape):
    """The UNet's, the ControlNet's and the VAE's shapes, the multi-view
    step's batch 8 at SD1.5's 64^2 and 32^2 levels, and SDXL's and
    SD2.1-768's 64-wide levels (the Hopper kernel's, as the 40- and 80-wide
    ones are), forward only. They
    fill the card with blocks, and the inputs are evicted from the 50 MB L2
    first, so the first copies of every resident block queue on device
    memory together: a read of a ring stage before its copies land shows
    here."""
    dev = _card()
    q, k, v, _ = _qkv(dev, shape, torch.bfloat16, seed=sum(shape))
    torch.empty(2 ** 26, dtype=torch.int32, device=dev).fill_(1)
    _hold_fwd(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 80, 512])
def test_bf16_takes_a_view_that_is_not_16_byte_aligned(D):
    """Views off the 16-byte grid through ``csrc/flash_attn.cu``'s forward
    (at D = 40 and 80 its row-split kernel, called directly: the main path
    sends bf16 D = 40 and 80 to the Hopper kernel, which raises on such
    views) and backward: their element-wise loads."""
    dev = _card()
    B, N, H = 2, 1024, 2
    gen = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randn(4 * B * N * H * D + 4, generator=gen,
                       device=dev).to(torch.bfloat16)
    q, k, v, g = (flat[4 + i * B * N * H * D:][:B * N * H * D]
                  .view(B, N, H, D) for i in range(4))
    assert q.data_ptr() % 16 != 0
    _hold(q, k, v, g.contiguous(),
          fwd=lambda a, b, c: FL._fwd_flash_attn(a, b, c, a.device))


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 128, 2, 512), (2, 1024, 2, 512),
                                   (1, 1024, 1, 256), (2, 1024, 2, 384),
                                   (1, 128, 1, 256)])
def test_bf16_wide_backward_over_shapes(shape):
    """The D > 128 backward at N = 128 and 1024, B and H above 1, and the
    zero-padded widths 256 and 384."""
    dev = _card()
    q, k, v, g = _qkv(dev, shape, torch.bfloat16, seed=sum(shape) + 1)
    _hold(q, k, v, g)


@pytest.mark.gpu
def test_bf16_wide_backward_from_a_cold_cache():
    """The VAE's (1, 4096, 1, 512), forward and backward, with the inputs
    evicted from the 50 MB L2 first: every block's first copies (K, V and
    query tile 0 of the dK / dV pass) queue on device memory together."""
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 4096, 1, 512), torch.bfloat16, seed=19)
    torch.empty(2 ** 26, dtype=torch.int32, device=dev).fill_(1)
    _hold(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["last", "first"])
@pytest.mark.parametrize("who", ["query", "key"])
def test_bf16_wide_backward_when_one_tile_carries_the_gradient(who, where):
    """"query": the upstream gradient is zero but on one 32-query tile, the
    last the dK / dV pass streams or the first (its first ring stage), so
    dK and dV come from that tile alone. "key": one 32-key tile, the last or
    the first, has keys 4x as large, so it takes most of each row's weight
    and carries dQ, whose product kernel walks the keys in 64-key steps.
    On the "key" inputs a few keys share each row's weight, so the forward
    is held to the limit derived for such rows, the roundings' worst case
    2^-8 (sum_j p_j |v_j| + |out|) (``test_bf16_wide_forward_on_peaked_
    rows_is_the_roundings``)."""
    dev = _card()
    B, N, H, D = 1, 1024, 1, 512
    rows = slice(N - 32, N) if where == "last" else slice(0, 32)
    q, k, v, g = _qkv(dev, (B, N, H, D), torch.float32, seed=23)
    if who == "query":
        keep = torch.zeros_like(g)
        keep[:, rows] = 1
        g = g * keep
    else:
        k[:, rows] *= 4
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    if who == "query":
        _hold(q, k, v, g)
    else:
        _hold_bwd(q, k, v, g, *_hold_fwd(q, k, v, peaked=True))


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["last", "first"])
def test_bf16_wide_forward_on_peaked_rows_is_the_roundings(where):
    """The D = 512 forward on rows whose weight sits on a few keys (one
    32-key tile's keys 4x as large, the last or the first): the plain
    version with P rounded to bf16 once, and the output once
    (``flash_attention_rounded_plain``), passes the 2^-9 (sum_j p_j |v_j| +
    |out|) limit there too, so the rounding alone accounts for the
    kernel's excess over it; both stay within the roundings' worst case,
    2^-8 (sum_j p_j |v_j| + |out|), the limit derived for such rows."""
    dev = _card()
    B, N, H, D = 1, 1024, 1, 512
    rows = slice(N - 32, N) if where == "last" else slice(0, 32)
    q, k, v, _ = _qkv(dev, (B, N, H, D), torch.float32, seed=23)
    k[:, rows] *= 4
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, _ = FL.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    rounded = FL.flash_attention_rounded_plain(q, k, v)
    ref = FL.flash_attention_plain(q.float(), k.float(), v.float())[0]
    lim = TOL_BF16_OUT * (FL.flash_attention_plain(
        q.float(), k.float(), v.float().abs())[0] + ref.abs())
    err_kernel = (out.float() - ref).abs()
    err_rounded = (rounded.float() - ref).abs()
    assert float((err_rounded / lim).max()) > 1.0
    for err in (err_kernel, err_rounded):
        assert bool((err <= TOL_BF16_OUT_PEAKED / TOL_BF16_OUT * lim).all())


@pytest.mark.gpu
def test_bf16_wide_backward_is_deterministic():
    """Two backward calls on the same inputs are bitwise equal: no float
    atomics, fixed summation order."""
    dev = _card()
    q, k, v, g = _qkv(dev, (1, 4096, 1, 512), torch.bfloat16, seed=29)
    out, lse = FL.flash_attn_fwd(q, k, v)
    first = FL.flash_attn_bwd(q, k, v, out, lse, g)
    second = FL.flash_attn_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_wide_backward_takes_a_view_that_is_not_16_byte_aligned():
    """D = 256 (zero-padded) from views off the 16-byte grid: both passes
    take their element-wise loads."""
    dev = _card()
    B, N, H, D = 1, 1024, 2, 256
    gen = torch.Generator(device=dev).manual_seed(31)
    flat = torch.randn(4 * B * N * H * D + 2, generator=gen,
                       device=dev).to(torch.bfloat16)
    q, k, v, g = (flat[2 + i * B * N * H * D:][:B * N * H * D]
                  .view(B, N, H, D) for i in range(4))
    assert q.data_ptr() % 16 != 0
    _hold(q, k, v, g.contiguous())


def _evict_l2(dev):
    """Write 256 MB, five times the 50 MB L2, so the next kernel's inputs
    come from device memory."""
    torch.empty(2 ** 26, dtype=torch.int32, device=dev).fill_(1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (2, 1024, 8, 80),
                                   (1, 4096, 1, 512)])
def test_f32_at_the_full_width_steps_shapes_from_a_cold_cache(shape):
    """The float32 guidance's shapes (the UNet's, the ControlNet's, the
    VAE's), forward and backward, each from a cold cache: every resident
    block's first ring copies queue on device memory together, so a read of
    a stage before its copies land shows here."""
    dev = _card()
    q, k, v, g = _qkv(dev, shape, torch.float32, seed=sum(shape) + 3)
    _evict_l2(dev)
    out, lse = _hold_fwd(q, k, v)
    _evict_l2(dev)
    _hold_bwd(q, k, v, g, out, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1024, 2, 16), (2, 1152, 2, 40),
                                   (1, 4096, 1, 512)])
def test_f32_backward_is_deterministic(shape):
    """Two float32 backward calls on the same inputs are bitwise equal: no
    atomics, and the D-split warps add their partial scores in one fixed
    order."""
    dev = _card()
    q, k, v, g = _qkv(dev, shape, torch.float32, seed=sum(shape) + 5)
    out, lse = FL.flash_attn_fwd(q, k, v)
    first = FL.flash_attn_bwd(q, k, v, out, lse, g)
    second = FL.flash_attn_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 80, 128, 512])
def test_f32_rescales_when_the_max_arrives_in_the_last_tile(D):
    """As the bf16 case above, in float32: every row's largest score is the
    last key's, so the running maximum jumps in the last key tile and the
    output so far is rescaled; held to 1e-5 absolute."""
    dev = _card()
    B, N, H = 1, 1024, 2
    q, k, v, _ = _qkv(dev, (B, N, H, D), torch.float32, seed=37 + D)
    q = 8 * q
    q[..., 0] = q[..., 0].abs() + 32
    k[:, -1] = 0
    k[:, -1, :, 0] = 2 * D ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    assert bool((s.argmax(-1) == N - 1).all())
    _hold_fwd(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 512])
def test_f32_takes_a_view_that_is_not_16_byte_aligned(D):
    """Views one float off the 16-byte grid: the float32 kernels take their
    element-wise loads, forward and backward."""
    dev = _card()
    B, N, H = 2, 1024, 2
    gen = torch.Generator(device=dev).manual_seed(41)
    flat = torch.randn(4 * B * N * H * D + 1, generator=gen, device=dev)
    q, k, v, g = (flat[1 + i * B * N * H * D:][:B * N * H * D]
                  .view(B, N, H, D) for i in range(4))
    assert q.data_ptr() % 16 != 0
    _hold(q, k, v, g.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 64, 80])
def test_hopper_forward_over_one_key_tile(D):
    """N = 128: one key tile, the Q tile's only one; the ring's first
    stage alone, every row's max in it."""
    dev = _card()
    q, k, v, _ = _qkv(dev, (2, 128, 3, D), torch.bfloat16, seed=21)
    _hold_fwd(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 64, 80])
def test_hopper_forward_takes_a_fused_projection_or_raises(D):
    """q, k, v as (B, N, H, D) views of one (B, N, 3 H D) projection
    (strides of whole 16 bytes, 16-byte aligned bases; at D = 40 a head's
    row is 80 bytes, and the tensor map's 40 columns keep the next head's
    values out of the 64-wide tile; at D = 80 the second slab's box starts
    at column 64 of the same row): the Hopper kernel takes them. The
    same views 8 bytes into their buffer are not 16-byte aligned, which a
    TMA tensor map cannot describe: the forward raises, with no other
    kernel to fall back to."""
    dev = _card()
    B, N, H = 2, 1024, 4
    gen = torch.Generator(device=dev).manual_seed(23)
    flat = torch.randn(B * N * 3 * H * D + 4, generator=gen,
                       device=dev).to(torch.bfloat16)
    fused = flat[:B * N * 3 * H * D].view(B, N, 3 * H * D)
    q, k, v = (x.reshape(B, N, H, D) for x in fused.chunk(3, dim=-1))
    assert not q.is_contiguous()
    before = FL.flash_fwd_hopper.launches
    _hold_fwd(q, k, v)
    assert FL.flash_fwd_hopper.launches == before + 1
    shifted = flat[4:].view(B, N, 3 * H * D)
    q, k, v = (x.reshape(B, N, H, D) for x in shifted.chunk(3, dim=-1))
    assert q.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="TMA"):
        FL.flash_attn_fwd(q, k, v)
    assert FL.flash_fwd_hopper.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 64, 80])
def test_hopper_launch_is_counted_under_its_own_name(D):
    """A bf16 forward at D = 40, 64 or 80 counts one launch on
    ``flash_fwd_hopper`` and none on ``flash_attn_fwd``, and the profiler
    sees one
    ``flash_fwd_hopper_kernel`` and no row-split kernel; the autograd
    function's backward stays ``flash_attn_bwd``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    q, k, v, g = _qkv(dev, (1, 1024, 2, D), torch.bfloat16, seed=25)
    for t in (q, k, v):
        t.requires_grad_(True)
    FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
    FL.flash_fwd_hopper.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = FL.flash_self_attention(q, k, v)
        torch.cuda.synchronize()
    out.backward(g)
    assert (FL.flash_fwd_hopper.launches, FL.flash_attn_fwd.launches,
            FL.flash_attn_bwd.launches) == (1, 0, 1)
    launched = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    assert sum(c for n, c in launched.items()
               if "flash_fwd_hopper_kernel" in n) == 1
    assert not any("flash_fwd_rows_kernel" in n for n in launched)


@pytest.mark.gpu
def test_hopper_rescales_when_the_max_arrives_in_the_last_tile_at_80():
    """The Hopper kernel at D = 80, called by name: q scaled x8 with a
    positive component 72, and the last key along it, so every row's
    largest score is its last and comes from D = 80's second slab (columns
    64-79) of Q and K; each row's running maximum jumps in the last of
    8 key tiles, part-way round the 3-stage ring, and the output
    accumulated so far, both slabs of it, must be rescaled."""
    dev = _card()
    B, N, H, D, col = 2, 1024, 3, 80, 72
    q, k, v, _ = _qkv(dev, (B, N, H, D), torch.float32, seed=27)
    q = 8 * q
    q[..., col] = q[..., col].abs() + 32
    k[:, -1] = 0
    k[:, -1, :, col] = 2 * D ** 0.5
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    assert bool((s.argmax(-1) == N - 1).all())
    before = FL.flash_fwd_hopper.launches
    _hold_fwd(q, k, v, fwd=FL.flash_fwd_hopper)
    assert FL.flash_fwd_hopper.launches == before + 1

"""Parity of the port's flash attention against the JAX package, on the CPU.

The JAX side runs its Pallas TPU kernel under the Mosaic interpreter
(``pltpu.force_tpu_interpret_mode()``), as ``tests/test_flash_attention.py``
does; the port's wrappers take their plain versions on CPU tensors, through
the same ``autograd.Function`` that launches the CUDA kernels on the card.
Inputs come from a numpy seed and go to both packages. Tolerances are the
JAX package's own for its kernel: 1e-5 absolute on the output, 1e-4 of each
gradient's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamwaltz_g_tpu.guidance import layers as JL
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.guidance import flash as FL
from dreamwaltz_g_tpu_torch.guidance import layers as TL
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL_OUT = 1e-5
TOL_GRAD = 1e-4


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _grads_close(got, want, tol):
    for a, b in zip(got, want):
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


@pytest.mark.parametrize("shape", [(1, 256, 2, 40), (1, 256, 1, 64),
                                   (1, 256, 2, 64), (1, 128, 1, 256)])
def test_flash_self_attention_matches_jax_kernel(shape):
    """Forward and the three gradients, port vs the interpreted TPU
    kernel."""
    q, k, v, g = _qkvg(shape, sum(shape))

    def loss(q, k, v):
        return (JL.flash_self_attention(q, k, v) * g).sum()

    with pltpu.force_tpu_interpret_mode():
        jout = JL.flash_self_attention(*map(jnp.asarray, (q, k, v)))
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    counts = (FL.flash_attn_fwd, FL.flash_attn_bwd, FL.flash_fwd_hopper)
    before = [f.launches for f in counts]
    out = FL.flash_self_attention(tq, tk, tv)
    (out * torch.as_tensor(g)).sum().backward()
    # CPU tensors take the plain versions: no launch is counted
    assert [f.launches for f in counts] == before
    assert float(np.abs(out.detach().numpy() - np.asarray(jout)).max()) \
        <= TOL_OUT
    _grads_close([tq.grad, tk.grad, tv.grad], jgrads, TOL_GRAD)


@pytest.mark.parametrize("shape", [(2, 128, 3, 24), (1, 256, 1, 128)])
def test_plain_backward_matches_autograd(shape):
    """``flash_attention_plain_bwd`` from the saved out and lse against
    ``torch.autograd`` through an attention that materialises its softmax:
    1e-5 of each gradient's largest entry."""
    q, k, v, g = (torch.as_tensor(x) for x in _qkvg(shape, 7))
    out, lse = FL.flash_attention_plain(q, k, v)
    got = FL.flash_attention_plain_bwd(q, k, v, out, lse, g)
    for t in (q, k, v):
        t.requires_grad_(True)
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / shape[-1] ** 0.5, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", a, v)
    assert float((out - ref.detach()).abs().max()) <= TOL_OUT
    assert float((lse - torch.logsumexp(
        torch.einsum("bqhd,bkhd->bhqk", q, k).detach() / shape[-1] ** 0.5,
        -1)).abs().max()) <= 1e-5
    ref.backward(g)
    _grads_close(got, [q.grad, k.grad, v.grad], 1e-5)


@pytest.mark.parametrize("shape,splits,late", [
    ((1, 256, 1, 512), 2, None), ((2, 128, 2, 256), 2, None),
    ((1, 256, 1, 384), 4, None), ((1, 256, 1, 512), 2, 127),
    ((1, 256, 1, 512), 2, 255)])
def test_combine_of_key_splits_matches_plain(shape, splits, late):
    """The wide forward's merge, plain: each key range's normalised output
    and lse, combined, give ``flash_attention_plain``'s out and lse within
    float32 rounding (1e-5 of the output, 1e-5 on lse). ``late``: one key
    dominates every row, the last of the first range (127) or of the second
    (255), so one range carries nearly all the weight."""
    q, k, v, _ = (torch.as_tensor(x) for x in _qkvg(shape, sum(shape)))
    if late is not None:
        q[..., 0] = q[..., 0].abs() + 4
        k[:, late] = 0
        k[:, late, :, 0] = 4 * shape[-1] ** 0.5
    ref, ref_lse = FL.flash_attention_plain(q, k, v)
    o_part, lse_part = FL.flash_attention_split_plain(q, k, v, splits)
    assert o_part.shape == (splits,) + shape
    assert lse_part.shape == (splits, shape[0], shape[2], shape[1])
    out, lse = FL.combine_key_splits(o_part, lse_part)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    if late is not None:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        assert bool((s.argmax(-1) == late).all())
        # the range without the key: its partial output is not the answer
        other = 1 - late // (shape[1] // splits)
        assert float((o_part[other] - ref).abs().max()) > 0.1


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 256, 1, 512), torch.float32, 1e-5),
    ((2, 128, 2, 256), torch.float32, 1e-5),
    ((1, 128, 2, 384), torch.float32, 1e-5),
    ((1, 256, 1, 512), torch.bfloat16, 2.0 ** -6),
    ((2, 128, 2, 256), torch.bfloat16, 2.0 ** -6)])
def test_wide_backward_plain_twin_matches_plain_bwd(shape, dtype, tol):
    """The D > 128 backward's two stages, plain (the dK / dV pass with its
    dSᵀ scratch, then dQ = scale dS K from the scratch), against
    ``flash_attention_plain_bwd``: float32 inputs within 1e-5 of each
    gradient's largest entry (the same sums in another order); bf16 inputs,
    where P and dS round once more, within 2^-6, the card's backward
    tolerance. The scratch is dSᵀ, keys by queries."""
    q, k, v, g = (torch.as_tensor(x).to(dtype)
                  for x in _qkvg(shape, sum(shape)))
    out, lse = FL.flash_attention_plain(q, k, v)
    *got, ds_t = FL.flash_attention_wide_bwd_plain(q, k, v, out, lse, g)
    want = FL.flash_attention_plain_bwd(q, k, v, out, lse, g)
    B, N, H, _ = shape
    assert ds_t.shape == (B, H, N, N) and ds_t.dtype == dtype
    for a, b in zip(got, want):
        assert a.dtype == dtype
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    # dSᵀ [key][query]: dK = scale dSᵀ Q from it
    dk = torch.einsum("bhkq,bqhd->bkhd", ds_t.float(), q.float()) \
        * shape[-1] ** -0.5
    assert float((dk - got[1].float()).abs().max()) \
        <= 2.0 ** -7 * float(dk.abs().max())


@pytest.mark.parametrize("mode,nq,nk,d,expect", [
    ("on", 4096, 4096, 40, True),      # 64^2 self-attention
    ("on", 1024, 1024, 80, True),      # 32^2 self-attention
    ("on", 4096, 77, 40, False),       # cross-attention to text tokens
    ("on", 256, 256, 160, False),      # short layer stays einsum
    ("on", 4096, 4096, 160, False),    # head_dim > 128, not a multiple
    ("on", 4096, 4096, 512, True),     # VAE mid-block, single head
    ("auto", 4096, 4096, 40, False),   # CPU tensor: einsum
    ("off", 4096, 4096, 40, False),
])
def test_flash_gate_matches_jax(monkeypatch, mode, nq, nk, d, expect):
    """The dispatch gate on a CPU tensor's device, equal to the JAX
    package's under the same setting (whose "auto" is False off a TPU)."""
    monkeypatch.setattr(TL, "FLASH_ATTENTION", mode)
    monkeypatch.setattr(JL, "FLASH_ATTENTION", mode)
    assert TL.FLASH_MIN_SEQ == JL.FLASH_MIN_SEQ == 1024
    got = TL._flash_enabled(nq, nk, d, torch.device("cpu"))
    assert got is expect
    assert got is JL._flash_enabled(nq, nk, d)


def test_flash_default_is_auto_and_sdpa_unused(monkeypatch):
    """The default setting is "auto"; on CPU tensors it is the einsum path,
    "on" reaches the plain flash version, "off" never touches flash; no
    path calls scaled_dot_product_attention."""
    assert TL.FLASH_ATTENTION == "auto"

    def forbidden(*a, **k):
        raise AssertionError("scaled_dot_product_attention called")

    calls = []
    plain = TL.flash_self_attention
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        forbidden)
    monkeypatch.setattr(TL, "flash_self_attention",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(TL, "FLASH_MIN_SEQ", 128)
    gen = torch.Generator().manual_seed(0)
    attn = TL.build(lambda: TL.Attention(32, 2, 16), "cpu", generator=gen)
    vae = TL.build(lambda: TL.AttnBlockVAE(32), "cpu", generator=gen)
    x = torch.randn((1, 128, 32), generator=gen)
    img = torch.randn((1, 32, 16, 8), generator=gen)
    outs = {}
    for mode, n_calls in (("auto", 0), ("off", 0), ("on", 2)):
        monkeypatch.setattr(TL, "FLASH_ATTENTION", mode)
        calls.clear()
        outs[mode] = (attn(x), vae(img))
        assert len(calls) == n_calls
    for a, b in zip(outs["on"], outs["off"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture
def flash_on(monkeypatch):
    """FLASH_ATTENTION = "on" with the length gate lowered to 256 in both
    packages, restored afterwards."""
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "FLASH_ATTENTION", "on")
        monkeypatch.setattr(mod, "FLASH_MIN_SEQ", 256)


def test_attention_module_flash_matches_jax(flash_on):
    """``Attention`` under "on" in both packages, converted weights: the
    output and the gradient to the input within 1e-4 of the largest."""
    B, N, H, D = 1, 256, 2, 40
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, N, H * D)).astype(np.float32)
    g = rng.normal(size=(B, N, H * D)).astype(np.float32)
    jmod = JL.Attention(heads=H, head_dim=D)
    assert JL._flash_enabled(N, N, D) and TL._flash_enabled(
        N, N, D, torch.device("cpu"))
    with pltpu.force_tpu_interpret_mode():
        params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
        jout = jmod.apply(params, jnp.asarray(x))
        jgrad = jax.grad(lambda x_: (jmod.apply(params, x_) * g).sum())(
            jnp.asarray(x))
    tmod = TL.build(lambda: TL.Attention(H * D, H, D), "cpu")
    tmod.load_state_dict(convert.flax_state_dict(_np_tree(params)))
    tx = torch.as_tensor(x).requires_grad_(True)
    tout = tmod(tx)
    (tout * torch.as_tensor(g)).sum().backward()
    _grads_close([tout, tx.grad], [jout, jgrad], 1e-4)


def test_vae_attention_block_flash_matches_jax(flash_on):
    """``AttnBlockVAE`` under "on" in both packages (float32 softmax on the
    flash path), with the gradient to the input."""
    B, S, C = 1, 16, 64
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    g = rng.normal(size=(B, S, S, C)).astype(np.float32)
    jmod = JL.AttnBlockVAE()
    with pltpu.force_tpu_interpret_mode():
        params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
        jout = jmod.apply(params, jnp.asarray(x))
        jgrad = jax.grad(lambda x_: (jmod.apply(params, x_) * g).sum())(
            jnp.asarray(x))
    tmod = TL.build(lambda: TL.AttnBlockVAE(C), "cpu")
    tmod.load_state_dict(convert.flax_state_dict(_np_tree(params)))
    tx = torch.as_tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    tout = tmod(tx)
    (tout * torch.as_tensor(g).permute(0, 3, 1, 2)).sum().backward()
    _grads_close([tout.permute(0, 2, 3, 1), tx.grad.permute(0, 2, 3, 1)],
                 [jout, jgrad], 1e-4)


def test_vae_attention_block_wider_than_the_kernels_matches_jax(flash_on):
    """``AttnBlockVAE(640)`` under "on": the JAX package runs its Pallas
    kernel (the interpreter here), the port's gate sends the head, wider
    than ``MAX_HEAD_DIM``, to the einsum path instead of the kernels, which
    refuse it. Output and input gradient within 1e-4 of the largest."""
    B, S, C = 1, 16, 640
    assert C > FL.MAX_HEAD_DIM
    assert JL._flash_enabled(S * S, S * S, C)
    assert not TL._flash_enabled(S * S, S * S, C, torch.device("cpu"))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    g = rng.normal(size=(B, S, S, C)).astype(np.float32)
    jmod = JL.AttnBlockVAE()
    with pltpu.force_tpu_interpret_mode():
        params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(x))
        jout = jmod.apply(params, jnp.asarray(x))
        jgrad = jax.grad(lambda x_: (jmod.apply(params, x_) * g).sum())(
            jnp.asarray(x))
    tmod = TL.build(lambda: TL.AttnBlockVAE(C), "cpu")
    tmod.load_state_dict(convert.flax_state_dict(_np_tree(params)))
    tx = torch.as_tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    before = FL.flash_attn_fwd.launches
    tout = tmod(tx)
    (tout * torch.as_tensor(g).permute(0, 3, 1, 2)).sum().backward()
    assert FL.flash_attn_fwd.launches == before
    _grads_close([tout.permute(0, 2, 3, 1), tx.grad.permute(0, 2, 3, 1)],
                 [jout, jgrad], 1e-4)


@pytest.mark.parametrize("bad,match", [
    ("length", "multiple of 128"),
    ("cross", "self-attention"),
    ("head_dim", "not a multiple"),
    ("wide", "above 512"),
    ("types", "mixed types"),
    ("half", "bfloat16 or float32"),
    ("strided", "contiguous along D"),
    ("rank", "must be"),
])
def test_wrapper_raises_outside_the_domain(bad, match):
    q = torch.zeros((1, 128, 2, 16))
    k = v = q
    if bad == "length":
        q = k = v = torch.zeros((1, 100, 2, 16))
    elif bad == "cross":
        k = v = torch.zeros((1, 256, 2, 16))
    elif bad == "head_dim":
        q = k = v = torch.zeros((1, 128, 1, 160))
    elif bad == "wide":
        q = k = v = torch.zeros((1, 128, 1, 640))
    elif bad == "types":
        k = k.to(torch.bfloat16)
    elif bad == "half":
        q = k = v = q.half()
    elif bad == "strided":
        q = torch.zeros((1, 128, 16, 2)).transpose(2, 3)
    elif bad == "rank":
        q = k = v = torch.zeros((128, 2, 16))
    with pytest.raises(ValueError, match=match):
        FL.flash_attn_fwd(q, k, v)
    if bad in ("length", "head_dim"):
        with pytest.raises(ValueError, match=match):
            FL.flash_attn_bwd(q, k, v, q, torch.zeros(q.shape[:1]), q)


@pytest.mark.parametrize("peaked", [False, True], ids=["spread", "peaked"])
def test_bf16_roundings_against_the_forward_limits(peaked):
    """The bf16 forwards' two rounding points alone
    (``flash_attention_rounded_plain``: P rounded once, out rounded once)
    at D = 512, N = 1024: on rows whose weight spreads over many keys they
    stay within 2^-9 (sum_j p_j |v_j| + |out|), the kernels' limit; with
    one 32-key tile's keys 4x as large, a few keys carry each row, P's
    roundings no longer average out and pass that limit, while staying
    within their worst case 2^-8 (sum_j p_j |v_j| + |out|), the limit the
    card tests hold such rows to."""
    gen = torch.Generator().manual_seed(23)
    q, k, v = (torch.randn((1, 1024, 1, 512), generator=gen)
               for _ in range(3))
    if peaked:
        k[:, -32:] *= 4
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    ref = FL.flash_attention_plain(q.float(), k.float(), v.float())[0]
    lim = 2.0 ** -9 * (FL.flash_attention_plain(
        q.float(), k.float(), v.float().abs())[0] + ref.abs())
    ratio = float(((FL.flash_attention_rounded_plain(q, k, v).float() - ref)
                   .abs() / lim).max())
    if peaked:
        assert 1.0 < ratio <= 2.0
    else:
        assert ratio <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [16, 40, 64, 80, 128, 512])
def test_forward_route_names_the_hopper_kernel_for_bf16_at_64_only(D, dtype):
    """``_fwd_route``: the bf16 forward at D = 40 and 80 (SD1.5's heads at
    its 64^2 and 32^2 latents) and D = 64 (SDXL's and SD2.x's heads) is
    ``flash_fwd_hopper``'s (``csrc/flash_fwd_hopper.cu``); every other
    (D, type), float32 at D = 40, 64 and 80 among them, stays with
    ``flash_attn_fwd`` (``csrc/flash_attn.cu``)."""
    hopper = D in (40, 64, 80) and dtype == torch.bfloat16
    assert FL._fwd_route(D, dtype) == (
        "flash_fwd_hopper" if hopper else "flash_attn_fwd")
    assert FL._LIBRARY[FL._fwd_route(D, dtype)] == (
        "flash_fwd_hopper" if hopper else "flash_attn")


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 40),
                                     (torch.bfloat16, 80),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 40),
                                     (torch.float32, 80)])
def test_hopper_wrapper_takes_the_plain_version_on_the_cpu_or_raises(dtype,
                                                                       D):
    """``flash_fwd_hopper`` on CPU tensors: the plain version at bf16
    D = 40, 64 and 80, a ValueError for any other pair; no launch
    counted."""
    q, k, v = (torch.as_tensor(x).to(dtype)
               for x in _qkvg((1, 128, 2, D), 3)[:3])
    before = FL.flash_fwd_hopper.launches
    if dtype == torch.bfloat16 and D in (40, 64, 80):
        out, lse = FL.flash_fwd_hopper(q, k, v)
        ref, ref_lse = FL.flash_attention_plain(q, k, v)
        assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    else:
        with pytest.raises(ValueError,
                           match="bf16 at D = 40, 64 or 80 only"):
            FL.flash_fwd_hopper(q, k, v)
    assert FL.flash_fwd_hopper.launches == before


@pytest.mark.parametrize("D", [40, 80])
def test_hopper_wrapper_matches_jax_kernel_at_sd15_width(D):
    """``flash_fwd_hopper`` on CPU tensors at (1, 256, 2, D), SD1.5's head
    widths (40 at its 64^2 latents, 80 at 32^2), against the interpreted
    TPU kernel on the same values (the bf16 inputs widened to float32 for
    the JAX side): ``TOL_OUT`` on top of the one rounding of the output to
    bf16 (half a bf16 unit, at most 2^-8 of the value), which the
    wrapper's output carries and the float32 JAX output does not; the lse
    within ``TOL_OUT`` of a float64 logsumexp of the scaled scores; no
    launch counted."""
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _qkvg((1, 256, 2, D), D)[:3])
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(JL.flash_self_attention(
            *(jnp.asarray(t.float().numpy()) for t in (q, k, v))))
    before = FL.flash_fwd_hopper.launches
    out, lse = FL.flash_fwd_hopper(q, k, v)
    assert FL.flash_fwd_hopper.launches == before
    assert out.dtype == torch.bfloat16 and tuple(lse.shape) == (1, 2, 256)
    err = np.abs(out.float().numpy() - jout)
    assert bool((err <= TOL_OUT + 2.0 ** -8 * np.abs(jout)).all())
    s = np.einsum("bqhd,bkhd->bhqk", *(t.float().numpy() for t in (q, k)),
                  dtype=np.float64) / np.sqrt(float(D))
    ref_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert float(np.abs(lse.numpy() - ref_lse).max()) <= TOL_OUT


@pytest.mark.parametrize("name", ["tree", "split_pv", "no_exp", "no_pv",
                                  "no_softmax", "no_loads",
                                  "no_loads_no_softmax", "one_tile"])
def test_hopper_variants_edit_the_kernel_source(name):
    """``scripts/flash_hopper_variants.py``'s variants each apply their
    edit to ``csrc/flash_fwd_hopper.cu`` as it stands (the script raises
    on an edit whose text the source lacks), and every variant but the
    tree's changes it."""
    from dreamwaltz_g_tpu_torch.scripts import flash_hopper_variants as FV

    text = FV.SOURCE.read_text()
    assert set(FV.VARIANTS) == {"tree", "split_pv", "no_exp", "no_pv",
                                "no_softmax", "no_loads",
                                "no_loads_no_softmax", "one_tile"}
    assert (FV.variant(name, text) == text) == (name == "tree")
    with pytest.raises(ValueError):
        FV.variant("no_such_variant", text)


@pytest.mark.parametrize("D", FL.HOPPER_WIDTHS)
def test_hopper_variants_hold_and_time_every_hopper_width(D):
    """``scripts/flash_hopper_variants.py`` holds each variant against the
    plain version at a shape of every width that ``_fwd_route`` sends to
    the Hopper kernel, and times it at four shapes of that width."""
    from dreamwaltz_g_tpu_torch.scripts import flash_hopper_variants as FV

    assert any(shape[-1] == D for shape in FV.HELD)
    assert sum(shape[-1] == D for shape in FV.SHAPES) == 4

"""The bf16 guidance of the port against the JAX package, on the CPU.

The tiny UNet, ControlNet and VAE carry the JAX package's weights rounded
to bf16 (the same values in both packages); the text embeddings are bf16,
the latents bf16-exact, the condition image float32. The noise is the JAX
package's own draw from the key (``jax.random.normal`` in bf16), handed to
the port as numpy. Guidance scale 50, as on the card.

At bf16 the two packages run the eps stack in different types:
* the JAX package adds the float32 schedule to the bf16 latents
  (``guidance/time_prior.py:add_noise``), and its float32 timestep
  embedding stays float32 through the bf16 ``Dense`` layers, so Flax
  promotes the UNet and the ControlNet to float32 activations against bf16
  weights;
* the port, by default, casts the noised latents, the time embedding and
  the condition to bf16 and computes in bf16 (the card's path).

(a) With ``jax_promotion=True`` the port copies the promotion, and
    ``latent_gradients`` agrees with the JAX package's to float32 rounding.
    The whole SDS call adds the VAE encode and its backward, which run in
    bf16 in both packages and round each layer's result once, but not
    always to the same neighbour: each package sums in its own order, and a
    sum that lies near a bf16 rounding boundary goes one way in one package
    and the other way in the other (one bf16 step, 2^-8 relative).
(b) With the default the gap is measured and held under a bound, so that
    it cannot grow unnoticed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.guidance import layers as TL
import tests.torch_threads  # noqa: F401  (per-worker threads)

LATENT = 8
GUIDANCE = 50.0
BF16 = jnp.bfloat16


def _bf16_exact(tree):
    """Float32 numpy leaves rounded to bf16 values."""
    if isinstance(tree, dict):
        return {k: _bf16_exact(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(np.asarray(tree, np.float32), BF16)
                      .astype(jnp.float32))


def _stacks():
    """(JAX ScoreDistillation, JAX bf16 params, port ScoreDistillation, port
    bf16 params) over the same bf16 weights; the ControlNet's zero convs
    carry values."""
    jsd, jgp = jts.tiny_guidance(jax.random.PRNGKey(0), with_controlnet=True,
                                 latent_size=LATENT)
    rng = np.random.default_rng(0)
    trees = {k: jax.tree_util.tree_map(np.asarray, getattr(jgp, k))
             for k in ("unet", "vae", "controlnet")}
    cn = trees["controlnet"]["params"]
    for name, mod in cn.items():
        if name.startswith("controlnet_down_blocks") or \
                name == "controlnet_mid_block":
            for k in mod:
                mod[k] = rng.normal(size=mod[k].shape) * 0.2
    for k in cn["controlnet_cond_embedding"]["conv_out"]:
        leaf = cn["controlnet_cond_embedding"]["conv_out"][k]
        cn["controlnet_cond_embedding"]["conv_out"][k] = \
            rng.normal(size=leaf.shape) * 0.2
    trees = {k: _bf16_exact(v) for k, v in trees.items()}
    jgp = JGP(**{k: jax.tree_util.tree_map(lambda a: jnp.asarray(a, BF16), v)
                 for k, v in trees.items()})
    jsd = dataclasses.replace(jsd, guidance_scale=GUIDANCE)
    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True, latent_size=LATENT,
                                 device="cpu", dtype=torch.bfloat16)
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    tsd = dataclasses.replace(tsd, guidance_scale=GUIDANCE)
    return jsd, jgp, tsd, tgp


@pytest.fixture(scope="module")
def stacks():
    return _stacks()


def _inputs(seed, t):
    rng = np.random.default_rng(seed)
    f = np.float32
    key = jax.random.PRNGKey(seed)
    lat = _bf16_exact(rng.normal(size=(1, LATENT, LATENT, 4)).astype(f))
    k_noise, _ = jax.random.split(key)
    return dict(
        key=key, lat=lat,
        noise=np.asarray(jax.random.normal(k_noise, lat.shape, dtype=BF16)
                         .astype(jnp.float32)),
        t=np.array([t], np.int32),
        ctx=_bf16_exact(rng.normal(size=(1, 4, 32)).astype(f)),
        unc=np.zeros((1, 4, 32), f),
        cond=rng.uniform(size=(1, 2 * LATENT, 2 * LATENT, 3)).astype(f),
        img=rng.uniform(size=(1, 2 * LATENT, 2 * LATENT, 3)).astype(f))


def _jax(jsd, jgp, x):
    """The JAX package's latent gradient, SDS call and image gradient."""
    ctx, unc = jnp.asarray(x["ctx"], BF16), jnp.asarray(x["unc"], BF16)
    grad = jsd.latent_gradients(jgp, jnp.asarray(x["lat"], BF16), ctx, unc,
                                x["t"], x["key"], cond_image=x["cond"])

    def loss(img):
        return jsd(jgp, img, ctx, unc, x["t"], x["key"],
                   cond_image=x["cond"])["loss"]

    out = jsd(jgp, jnp.asarray(x["img"]), ctx, unc, x["t"], x["key"],
              cond_image=x["cond"])
    img_grad = jax.grad(loss)(jnp.asarray(x["img"]))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        latent_gradients=grad, loss=out["loss"], latents=out["latents"],
        gradients=out["gradients"], image_gradient=img_grad).items()}


def _port(tsd, tgp, x, jax_promotion):
    tsd = dataclasses.replace(tsd, jax_promotion=jax_promotion)
    T = torch.as_tensor
    ctx, unc = T(x["ctx"]).bfloat16(), T(x["unc"]).bfloat16()
    grad = tsd.latent_gradients(tgp, T(x["lat"]).bfloat16(), ctx, unc,
                                T(x["t"]), noise=T(x["noise"]),
                                cond_image=T(x["cond"]))
    img = T(x["img"]).requires_grad_(True)
    out = tsd(tgp, img, ctx, unc, T(x["t"]), noise=T(x["noise"]),
              cond_image=T(x["cond"]))
    out["loss"].backward()
    return {k: v.detach().float().numpy() for k, v in dict(
        latent_gradients=grad, loss=out["loss"], latents=out["latents"],
        gradients=out["gradients"], image_gradient=img.grad).items()}


CASES = {"seed3_t500": (3, 500), "seed4_t950": (4, 950)}


@pytest.fixture(scope="module")
def results(stacks):
    """{case: (JAX, port with jax_promotion, port by default)}."""
    jsd, jgp, tsd, tgp = stacks
    out = {}
    for name, (seed, t) in CASES.items():
        x = _inputs(seed, t)
        out[name] = (_jax(jsd, jgp, x), _port(tsd, tgp, x, True),
                     _port(tsd, tgp, x, False))
    return out


def _gap(got, want):
    """The largest difference over the largest entry of the reference."""
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _loss_gap(got, j):
    """The loss's difference over sum |latents grad|, the size of the sum
    before its terms cancel."""
    return abs(float(got["loss"]) - float(j["loss"])) / float(
        np.abs(j["latents"] * j["gradients"]).sum())


def _ulps(got, want):
    """The largest difference in bf16 steps of the reference entry (2^-8
    |want|, floored at the smallest normal step of the largest entry)."""
    step = np.maximum(np.abs(want), 2.0 ** -8 * np.abs(want).max()) * 2.0 ** -8
    return float((np.abs(got - want) / step).max())


# (a) float32 arithmetic on the same bf16 weights, latents, embeddings and
# noise, the two frameworks summing in their own orders: the float32 step's
# ~3e-6 of the largest entry (measured 2.6e-6 and 3.4e-6), held at 2e-5
TOL_PROMOTED = 2e-5
# the bf16 VAE encode: each package's latents lie ~1.2e-2 of the largest
# entry from the float32 encode of the same weights (measured), each with
# its own rounding, so the two differ by up to ~2.4e-2 (measured 1.0e-2 and
# 1.5e-2)
TOL_ENCODE = 3e-2
# what the eps stack makes of those latents: the call's latent gradient
# (measured 4e-4 and 2.4e-3 of the largest) and loss (1.6e-3 and 2.0e-3 of
# sum |latents grad|)
TOL_CALL = 1e-2
# the bf16 backward through the VAE encoder, rounded at every layer in both
# packages (measured 2.2e-2 and 2.9e-2 of the largest)
TOL_IMAGE_GRAD = 6e-2
# (b) the default against the JAX package, bounded at 2x the measured gap:
# latent gradient 2.8e-2 and 3.1e-2 of the largest, the call's 3.2e-2 and
# 3.8e-2, the image gradient 4.8e-2 and 5.7e-2
BOUND_DEFAULT_LATENT = 6e-2
BOUND_DEFAULT_CALL = 8e-2
BOUND_DEFAULT_IMAGE_GRAD = 1.2e-1


@pytest.mark.parametrize("case", CASES)
def test_promoted_latent_gradients_match_jax(results, case):
    """(a) The eps stack under ``jax_promotion``: the JAX package's types,
    its result to float32 rounding."""
    j, on, _ = results[case]
    assert _gap(on["latent_gradients"], j["latent_gradients"]) <= TOL_PROMOTED


@pytest.mark.parametrize("case", CASES)
def test_promoted_sds_call_matches_jax(results, case):
    """(a) The whole SDS call under ``jax_promotion``: the VAE encode stays
    bf16 in both packages, its latents within the bf16 encode's rounding;
    the call's latent gradient and loss, and the image gradient through the
    VAE's bf16 backward, within what that rounding gives."""
    j, on, _ = results[case]
    assert _gap(on["latents"], j["latents"]) <= TOL_ENCODE
    assert _gap(on["gradients"], j["gradients"]) <= TOL_CALL
    assert _loss_gap(on, j) <= TOL_CALL
    assert _gap(on["image_gradient"], j["image_gradient"]) <= TOL_IMAGE_GRAD


@pytest.mark.parametrize("case", CASES)
def test_default_bf16_gap_to_jax_is_bounded(results, case):
    """(b) The default (bf16 noised latents, time embedding and activations,
    the card's path) against the JAX package: the gap stays under twice
    what was measured, and it is the types' gap, a thousand times the
    promoted one's, not rounding noise."""
    j, on, off = results[case]
    gap = _gap(off["latent_gradients"], j["latent_gradients"])
    assert 100 * TOL_PROMOTED < gap <= BOUND_DEFAULT_LATENT
    assert _gap(off["gradients"], j["gradients"]) <= BOUND_DEFAULT_CALL
    assert _loss_gap(off, j) <= BOUND_DEFAULT_CALL
    assert _gap(off["image_gradient"], j["image_gradient"]) \
        <= BOUND_DEFAULT_IMAGE_GRAD


def test_jax_latents_stay_bf16(stacks):
    """The JAX package's VAE encode of bf16 images stays bf16 (it meets no
    float32 constant), so its mid-block attention is a bf16 call in both
    packages."""
    jsd, jgp, _, _ = stacks
    x = _inputs(3, 500)
    lat = jsd.encode_images(jgp, jnp.asarray(x["img"], BF16))
    assert lat.dtype == BF16


@pytest.mark.parametrize("make,shape", [
    (lambda: TL.Linear(24, 16), (2, 5, 24)),
    (lambda: TL.Conv2d(8, 16, 3, padding=1), (2, 8, 6, 6)),
    (lambda: TL.GroupNorm(4, 16, eps=1e-5), (2, 16, 6, 6)),
    (lambda: TL.LayerNorm(24, eps=1e-5), (2, 5, 24))])
def test_promoting_layers(make, shape):
    """Off (the default): each layer is torch's own, bit for bit, at bf16.
    Under ``jax_promotion``: a float32 input against bf16 weights computes
    in float32, bit for bit the float32 layer over the same weights."""
    gen = torch.Generator().manual_seed(0)
    layer = TL.build(make, "cpu", torch.bfloat16, gen)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    plain = {TL.Linear: torch.nn.Linear, TL.Conv2d: torch.nn.Conv2d,
             TL.GroupNorm: torch.nn.GroupNorm,
             TL.LayerNorm: torch.nn.LayerNorm}[type(layer)]
    x = torch.randn(shape, generator=gen)
    with torch.no_grad():
        got = layer(x.bfloat16())
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, plain.forward(layer, x.bfloat16()))
        with TL.jax_promotion():
            got = layer(x)
        f32 = TL.build(make, "cpu", torch.float32)
        f32.load_state_dict({k: v.float()
                             for k, v in layer.state_dict().items()})
        assert got.dtype == torch.float32
        assert torch.equal(got, f32(x))

"""The guidance's other families and modes of the port against the JAX
package, in float32 on the CPU at the tiny sizes of
``test_torch_guidance.py``: ``custom``, ``csd`` (plain, and the annealed
three-term mix that ``progress`` + ``neg_embeds`` select), ``nfsd`` (t on
both sides of 200), ``ism`` (progress 0, 0.5 and 1, two inversion
strides); ``test_torch_guidance_modes.py`` holds the denoise modes,
``latent_input`` and the VAE's sampled encode on the same stacks. Each
compares ``__call__``'s loss, gradients and target, the gradient that
reaches the rendered image, and ``latent_gradients`` (where the family
has one), with the JAX draws handed to the port: the score families'
noise from the first half of ``key``'s split, ``latent_gradients``' z0
target noise from the second, ``__call__``'s z0 / x0 target noise from
``key`` itself.

The JAX guidance's weights are seeded numpy on ``jax.eval_shape``'s shapes
(no Flax initialisation runs), the ControlNet's residual convs included,
so that it reaches the UNet. Tolerance: ``TOL`` relative (1e-4 of the
larger of 1 and the largest entry)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.guidance.controlnet import ControlNet as JControlNet
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.guidance.sds import ScoreDistillation as JSD
from dreamwaltz_g_tpu.guidance.unet import UNet2DCondition as JUNet
from dreamwaltz_g_tpu.guidance.unet import tiny_unet_config as jtiny_unet
from dreamwaltz_g_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamwaltz_g_tpu.guidance.vae import tiny_vae_config as jtiny_vae
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.guidance.sds import (
    LOSS_TYPES,
    SCORE_TYPES,
    ScoreDistillation,
)
from tests.torch_jax_pairs import _seeded
import tests.torch_threads  # noqa: F401  (per-worker threads)

# float32 through a dozen convolutions, GroupNorms and attentions, and up
# to six chained eps passes (ISM's inversion, the *_final walk): the two
# frameworks sum in different orders
TOL = 1e-4
LATENT = 8
B = 2


@pytest.fixture(scope="module")
def stacks():
    """(JAX ScoreDistillation, its params, the port's, its params): the
    tiny UNet, VAE and ControlNet (two condition blocks)."""
    ucfg = jtiny_unet()
    unet, vae = JUNet(ucfg), JVAE(jtiny_vae())
    cn = JControlNet(ucfg, cond_block_channels=(16, 32))
    key = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, LATENT, LATENT, 4))
    ctx = jnp.zeros((1, 4, ucfg.cross_attention_dim))
    t0 = jnp.zeros((1,), jnp.int32)
    rng = np.random.default_rng(0)
    trees = {
        "unet": _seeded(jax.eval_shape(unet.init, key, lat, t0, ctx), rng),
        "vae": _seeded(jax.eval_shape(
            lambda k: vae.init(k, image_size=2 * LATENT), key), rng),
        "controlnet": _seeded(jax.eval_shape(
            cn.init, key, lat, t0, ctx,
            jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3))), rng)}
    jsd = JSD(unet=unet, vae=vae, controlnet=cn, latent_size=LATENT,
              guidance_scale=7.5)
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})
    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True,
                                 latent_size=LATENT, device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    return jsd, jgp, tsd, tgp


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        lat=rng.normal(size=(B, LATENT, LATENT, 4)).astype(f),
        t=np.array([999, 120], np.int32),
        ctx=rng.normal(size=(B, 4, 32)).astype(f),
        unc=rng.normal(size=(B, 4, 32)).astype(f) * 0.3,
        neg=rng.normal(size=(B, 4, 32)).astype(f),
        cond=rng.uniform(size=(B, 2 * LATENT, 2 * LATENT, 3)).astype(f),
        img=rng.uniform(size=(B, 2 * LATENT, 2 * LATENT, 3)).astype(f))


def _close(j, t, tol=TOL):
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.shape == t.shape
    assert np.isfinite(j).all()
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(
        1.0, float(np.abs(j).max())))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


_JAX_FNS = {}


def _jax_fns(jsd, jgp, fields):
    """The JAX latent_gradients and __call__ (value, gradients, target and
    image gradient), jitted once a field set with progress a traced
    scalar."""
    name = tuple(sorted(fields.items()))
    if name not in _JAX_FNS:
        def lg(lat, ctx, unc, t, key, cond, neg, p):
            return jsd.latent_gradients(jgp, lat, ctx, unc, t, key,
                                        cond_image=cond, neg_embeds=neg,
                                        progress=p)

        def loss(im, ctx, unc, t, key, cond, neg, p):
            out = jsd(jgp, im, ctx, unc, t, key, cond_image=cond,
                      neg_embeds=neg, progress=p)
            return out["loss"], (out["gradients"], out["target"])

        _JAX_FNS[name] = (jax.jit(lg), jax.jit(jax.value_and_grad(
            loss, has_aux=True)))
    return _JAX_FNS[name]


def family_check(stacks, fields, x, key, neg=False, progress=None):
    """__call__'s loss, gradients and target and the image gradient, JAX
    against the port, and the port's ``latent_gradients`` (but for the x0
    modes): for a score family on the port's encoded latents against the
    JAX call's gradients (its own latent gradient), for the z0 modes
    against the JAX ``latent_gradients`` on ``x["lat"]`` (the target
    noise from ``key``'s second half)."""
    jsd, jgp, tsd, tgp = stacks
    jsd = dataclasses.replace(jsd, **fields)
    tsd = dataclasses.replace(tsd, **fields)
    jlg, jvg = _jax_fns(jsd, jgp, fields)
    T = torch.as_tensor
    jargs = (x["ctx"], x["unc"], x["t"], key, x["cond"],
             x["neg"] if neg else None,
             None if progress is None else np.float32(progress))
    targs = (T(x["ctx"]), T(x["unc"]), T(x["t"]))
    tkw = dict(cond_image=T(x["cond"]),
               neg_embeds=T(x["neg"]) if neg else None, progress=progress)
    k_noise, k_ism = jax.random.split(key)
    lt = fields["loss_type"]
    shape = x["lat"].shape

    (jl, (jgrads, jtarget)), jgrad = jvg(x["img"], *jargs)
    call_noise = T(_normal(key if lt[:2] in ("z0", "x0") else k_noise,
                           shape))
    img = T(x["img"]).requires_grad_(True)
    tout = tsd(tgp, img, *targs, noise=call_noise, **tkw)
    np.testing.assert_allclose(float(tout["loss"].detach()), float(jl),
                               rtol=TOL)
    assert float(np.abs(np.asarray(jgrads)).max()) > 0
    _close(jgrads, tout["gradients"])
    _close(jtarget, tout["target"])
    tout["loss"].backward()
    _close(jgrad, img.grad)
    if lt.startswith("z0"):
        tg = tsd.latent_gradients(tgp, T(x["lat"]), *targs,
                                  noise=T(_normal(k_ism, shape)), **tkw)
        _close(jlg(x["lat"], *jargs), tg)
    elif lt in SCORE_TYPES:
        tg = tsd.latent_gradients(tgp, tout["latents"].detach(), *targs,
                                  noise=call_noise, **tkw)
        _close(jgrads, tg)


@pytest.mark.parametrize("loss_type,fields,neg,progress", [
    ("custom", {}, False, None),
    ("custom", {"guidance_rescale": 0.7}, False, None),
    ("csd", {}, False, None),
    ("csd", {}, True, 0.3),
    ("csd", {"weight_type": "dreamfusion"}, True, 0.85),
    ("nfsd", {}, True, None),
])
def test_score_families_match_jax(stacks, loss_type, fields, neg, progress):
    """custom / csd / nfsd; csd with ``progress`` + ``neg_embeds`` is the
    annealed mix, nfsd's batch has t = 999 and t = 120 (its domain term
    switches at 200)."""
    family_check(stacks, dict(loss_type=loss_type, **fields), _inputs(4),
                  jax.random.PRNGKey(7), neg=neg, progress=progress)


@pytest.mark.parametrize("progress", [0.0, 0.5, 1.0])
def test_ism_matches_jax(stacks, progress):
    """ISM with two inversion strides: at t = 999 the inversion walks 499
    -> 699 -> 899 (progress 0: delta 100), at t = 120 it starts at 0 and
    stops at t - delta."""
    family_check(stacks, dict(loss_type="ism", weight_type="ism",
                               ism_xs_inv_steps=2), _inputs(5),
                  jax.random.PRNGKey(8), progress=progress)


def test_every_family_constructs_and_unknown_raises():
    assert set(LOSS_TYPES) == {"sds", "sjc", "sjc-red", "custom", "csd",
                               "nfsd", "ism", "z0", "z0_final", "x0",
                               "x0_final"}
    for lt in LOSS_TYPES:
        sd = ScoreDistillation(loss_type=lt, schedule=tts.make_schedule(
            device="cpu"))
        assert sd.is_denoising_mode == (lt[:2] in ("z0", "x0"))
    for lt in ("sdsx", "x1", ""):
        with pytest.raises(NotImplementedError):
            ScoreDistillation(loss_type=lt)

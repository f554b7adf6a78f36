"""Shared fixtures of the geometry parity tests (``test_torch_dmtet_step``,
``test_torch_vanilla``, ``test_torch_hash_avatar``): the JAX package's
tiny guidance with seeded weights (shapes from ``jax.eval_shape``, so no
Flax initialisation runs) and the port's twin, and the JAX draw of the
SDS noise.
"""
import jax
import jax.numpy as jnp
import numpy as np

from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.guidance.sds import ScoreDistillation as JSD
from dreamwaltz_g_tpu.guidance.unet import UNet2DCondition as JUNet
from dreamwaltz_g_tpu.guidance.unet import tiny_unet_config as jtiny_unet
from dreamwaltz_g_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamwaltz_g_tpu.guidance.vae import tiny_vae_config as jtiny_vae
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts

# float32 through a render, the VAE and the UNet, forward and backward, in
# two frameworks: the loss within 1e-4 relative, each gradient within 2e-3
# relative plus 2e-4 of its largest entry
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4
# at eps = 1e-15 Adam's first step is +-lr sign(g): updated parameters are
# compared only where |g| exceeds 1e-3 of the tensor's largest
UPDATE_MIN_GRAD = 1e-3


def _seeded(tree, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            w = 0.1 * rng.normal(size=s.shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def tiny_guidance_pair(latent: int, seed: int = 0):
    """(JAX ScoreDistillation, its GuidanceParams, the port's, its
    GuidanceParams): the tiny UNet and VAE, no ControlNet, float32."""
    ucfg = jtiny_unet()
    unet, vae = JUNet(ucfg), JVAE(jtiny_vae())
    key = jax.random.PRNGKey(seed)
    lat = jnp.zeros((1, latent, latent, 4))
    ctx = jnp.zeros((1, 4, ucfg.cross_attention_dim))
    rng = np.random.default_rng(seed)
    trees = {
        "unet": _seeded(jax.eval_shape(unet.init, key, lat,
                                       jnp.zeros((1,), jnp.int32), ctx), rng),
        "vae": _seeded(jax.eval_shape(
            lambda k: vae.init(k, image_size=2 * latent), key), rng)}
    jsd = JSD(unet=unet, vae=vae, controlnet=None, latent_size=latent,
              guidance_scale=7.5)
    jgp = JGP(unet=jax.tree_util.tree_map(jnp.asarray, trees["unet"]),
              vae=jax.tree_util.tree_map(jnp.asarray, trees["vae"]),
              controlnet=None)
    tsd, tgp = tts.tiny_guidance(seed, latent_size=latent, device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    return jsd, jgp, tsd, tgp


def sds_noise(key, latent: int) -> np.ndarray:
    """The noise the JAX guidance draws from ``key``."""
    k_noise, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k_noise, (1, latent, latent, 4),
                                        jnp.float32))


def grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all(), f"{name}: the JAX gradient is not finite"
    assert np.abs(want).max() > 0, f"{name}: no gradient"
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float((err - bound).max()),
                                  float(np.abs(want).max()))


def update_close(name, got, want, grad):
    """Updated parameters where the gradient is well above rounding."""
    g = np.asarray(grad)
    sure = np.abs(g) > UPDATE_MIN_GRAD * max(np.abs(g).max(), 1e-30)
    assert sure.any(), name
    np.testing.assert_allclose(np.asarray(got)[sure], np.asarray(want)[sure],
                               rtol=1e-6, atol=1e-6, err_msg=name)

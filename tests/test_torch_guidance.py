"""Parity of the port's guidance stack against the JAX package, at float32
on the CPU: the tiny UNet (with and without ControlNet residuals), the
ControlNet, the VAE, the time embedding, the noise schedule, and the SDS
latent gradient and loss with injected noise. Weights cross over through
``convert.py``. On the CPU both packages' attention takes the einsum path
under the default ``FLASH_ATTENTION = "auto"``; the flash path is held in
``tests/test_torch_flash.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.guidance import layers as JL
from dreamwaltz_g_tpu.guidance import time_prior as JT
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.guidance import layers as TL
from dreamwaltz_g_tpu_torch.guidance import time_prior as TT
import tests.torch_threads  # noqa: F401  (per-worker threads)

# float32 through a dozen convolutions, GroupNorms and attentions; the two
# frameworks sum in different orders (observed differences ~1e-6)
TOL = 1e-4
LATENT = 8


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _fill_zero_convs(cn_tree, rng):
    """The ControlNet's residual convs and its embedding's conv_out start at
    zero; fill them so the residual path carries values."""
    p = cn_tree["params"]
    for name, mod in p.items():
        if name.startswith("controlnet_down_blocks") or \
                name == "controlnet_mid_block":
            for k in mod:
                mod[k] = rng.normal(size=mod[k].shape).astype(np.float32) * .2
    out = p["controlnet_cond_embedding"]["conv_out"]
    for k in out:
        out[k] = rng.normal(size=out[k].shape).astype(np.float32) * 0.2


@pytest.fixture(scope="module")
def stacks():
    """(JAX ScoreDistillation, JAX params, port ScoreDistillation, port
    params) over the same weights."""
    jsd, jgp = jts.tiny_guidance(jax.random.PRNGKey(0), with_controlnet=True,
                                 latent_size=LATENT)
    rng = np.random.default_rng(0)
    trees = {k: _np_tree(getattr(jgp, k)) for k in ("unet", "vae",
                                                    "controlnet")}
    _fill_zero_convs(trees["controlnet"], rng)
    jgp = JGP(**{k: _jnp_tree(v) for k, v in trees.items()})
    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True,
                                 latent_size=LATENT, device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    return jsd, jgp, tsd, tgp


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        lat=rng.normal(size=(B, LATENT, LATENT, 4)).astype(f),
        t=np.array([999, 120][:B], np.int32),
        ctx=rng.normal(size=(B, 4, 32)).astype(f),
        cond=rng.uniform(size=(B, 2 * LATENT, 2 * LATENT, 3)).astype(f),
        img=rng.uniform(size=(B, 2 * LATENT, 2 * LATENT, 3)).astype(f))


def _close(j, t, tol=TOL):
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(
        1.0, float(np.abs(j).max())))


def test_timestep_embedding_and_schedule_match_jax():
    """The embedding within 1e-6 + 1.2e-7 t: the frequencies f = exp(...)
    round one float32 step (6e-8 relative) apart in the two libraries, which
    moves the argument t f of sin/cos by up to 6e-8 t rad. The schedule and
    its maps within 1e-6."""
    for t in (0, 1, 5, 37, 99, 500, 999):
        ts = np.array([t], np.int32)
        for dim in (32, 320, 33):
            j = np.asarray(JL.timestep_embedding(jnp.asarray(ts), dim))
            e = TL.timestep_embedding(torch.as_tensor(ts), dim).numpy()
            assert j.shape == e.shape
            assert float(np.abs(j - e).max()) <= 1e-6 + 1.2e-7 * t
    js, tsch = JT.make_schedule(), TT.make_schedule(device="cpu")
    for name in ("betas", "alphas_cumprod", "sigmas"):
        _close(getattr(js, name), getattr(tsch, name), tol=1e-6)
    rng = np.random.default_rng(1)
    x0, eps = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
               for _ in range(2))
    t = np.array([3, 800], np.int32)
    tt = torch.as_tensor(t).long()
    _close(js.add_noise(x0, eps, t), tsch.add_noise(
        torch.as_tensor(x0), torch.as_tensor(eps), tt), tol=1e-6)
    _close(js.pred_x0_from_eps(x0, eps, t), tsch.pred_x0_from_eps(
        torch.as_tensor(x0), torch.as_tensor(eps), tt), tol=1e-6)
    t_next = np.array([-17, 300], np.int32)   # -17: step to the clean end
    _close(js.ddim_step(x0, eps, t, t_next), tsch.ddim_step(
        torch.as_tensor(x0), torch.as_tensor(eps), tt,
        torch.as_tensor(t_next).long()), tol=1e-6)


def test_unet_and_controlnet_match_jax(stacks):
    jsd, jgp, tsd, tgp = stacks
    x = _inputs(2)
    T = torch.as_tensor
    with torch.no_grad():
        jr = jsd.controlnet.apply(jgp.controlnet, x["lat"], x["t"], x["ctx"],
                                  x["cond"], 0.7)
        tr = tgp.controlnet(T(x["lat"]), T(x["t"]), T(x["ctx"]),
                            T(x["cond"]), 0.7)
        assert len(jr[0]) == len(tr[0]) == 4
        for a, b in zip(jr[0] + [jr[1]], tr[0] + [tr[1]]):
            assert float(np.abs(np.asarray(a)).max()) > 0.1
            _close(a, b)
        _close(jsd.unet.apply(jgp.unet, x["lat"], x["t"], x["ctx"]),
               tgp.unet(T(x["lat"]), T(x["t"]), T(x["ctx"])))
        _close(jsd.unet.apply(jgp.unet, x["lat"], x["t"], x["ctx"],
                              down_residuals=jr[0], mid_residual=jr[1]),
               tgp.unet(T(x["lat"]), T(x["t"]), T(x["ctx"]),
                        down_residuals=tr[0], mid_residual=tr[1]))
        jg = jsd.controlnet.apply(jgp.controlnet, x["lat"], x["t"], x["ctx"],
                                  x["cond"], 1.0, guess_mode=True)
        tg = tgp.controlnet(T(x["lat"]), T(x["t"]), T(x["ctx"]),
                            T(x["cond"]), 1.0, guess_mode=True)
        _close(jg[1], tg[1])
        _close(jg[0][0], tg[0][0])


def test_vae_encode_decode_match_jax(stacks):
    jsd, jgp, tsd, tgp = stacks
    x = _inputs(3)
    with torch.no_grad():
        jlat = jsd.vae.encode(jgp.vae, x["img"])
        _close(jlat, tgp.vae.encode(torch.as_tensor(x["img"])))
        _close(jsd.vae.decode(jgp.vae, x["lat"]),
               tgp.vae.decode(torch.as_tensor(x["lat"])))
        _close(jsd.encode_images(jgp, x["img"]),
               tsd.encode_images(tgp, torch.as_tensor(x["img"])))


def _jax_noise(key, shape):
    """The noise ``latent_gradients`` draws from ``key`` (sds.py:352-353)."""
    k_noise, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k_noise, shape, dtype=jnp.float32))


@pytest.mark.parametrize("loss_type,weight_type,guards", [
    ("sds", "sjc", {}),
    ("sds", "dreamfusion", {}),
    ("sjc", "latent-nerf", {}),
    ("sjc-red", "ism", {}),
    ("sds", "sjc", {"grad_latent_clip": True, "guidance_rescale": 0.7}),
    ("sds", "dreamfusion", {"grad_latent_norm": True}),
    ("sds", "sjc", {"prediction_type": "v_prediction"}),
])
def test_sds_gradients_and_loss_match_jax(stacks, loss_type, weight_type,
                                          guards):
    """latent_gradients and __call__'s loss within 1e-4 relative, with the
    JAX draw of the noise handed to the port."""
    import dataclasses

    jsd, jgp, tsd, tgp = stacks
    kw = dict(loss_type=loss_type, weight_type=weight_type, **guards)
    jsd = dataclasses.replace(jsd, **kw)
    tsd = dataclasses.replace(tsd, **kw)
    x = _inputs(4, B=1)
    key = jax.random.PRNGKey(7)
    noise = _jax_noise(key, x["lat"].shape)
    uncond = np.zeros_like(x["ctx"])
    T = torch.as_tensor
    jg = jsd.latent_gradients(jgp, x["lat"], x["ctx"], uncond, x["t"], key,
                              cond_image=x["cond"])
    tg = tsd.latent_gradients(tgp, T(x["lat"]), T(x["ctx"]), T(uncond),
                              T(x["t"]), noise=T(noise), cond_image=T(x["cond"]))
    _close(jg, tg)

    jout = jsd(jgp, x["img"], x["ctx"], uncond, x["t"], key,
               cond_image=x["cond"])
    img = T(x["img"]).requires_grad_(True)
    tout = tsd(tgp, img, T(x["ctx"]), T(uncond), T(x["t"]), noise=T(noise),
               cond_image=T(x["cond"]))
    np.testing.assert_allclose(float(tout["loss"].detach()), float(jout["loss"]),
                               rtol=TOL)
    _close(jout["gradients"], tout["gradients"])
    # the loss's gradient reaches the render through the VAE
    jgrad = jax.grad(lambda im: jsd(jgp, im, x["ctx"], uncond, x["t"], key,
                                    cond_image=x["cond"])["loss"])(
        jnp.asarray(x["img"]))
    tout["loss"].backward()
    _close(jgrad, img.grad)


def test_unported_loss_families_raise():
    from dreamwaltz_g_tpu_torch.guidance.sds import ScoreDistillation

    for lt in ("csd", "nfsd", "ism", "custom", "z0", "x0"):
        with pytest.raises(NotImplementedError):
            ScoreDistillation(loss_type=lt)

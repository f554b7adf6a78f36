"""The guidance's denoise modes ``z0`` / ``z0_final`` / ``x0`` /
``x0_final`` (a 5-step grid), ``latent_input`` at the native and a
resized size, and the VAE's sampled encode, the port against the JAX
package in float32 on the CPU, on ``test_torch_guidance_families.py``'s
tiny stacks and checks (its ``TOL``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_guidance_families import (
    B,
    LATENT,
    TOL,
    _close,
    _inputs,
    _normal,
    family_check,
    stacks,  # noqa: F401  (the fixture)
)
import tests.torch_threads  # noqa: F401  (per-worker threads)


@pytest.mark.parametrize("loss_type", ["z0", "z0_final", "x0", "x0_final"])
def test_denoise_modes_match_jax(stacks, loss_type):
    """The denoise modes on a 5-step grid (stride 200): t = 999 snaps to
    800 (the *_final walk takes the four steps below it), t = 120 to 0
    (no step below it)."""
    family_check(stacks, dict(loss_type=loss_type, denoise_timesteps=5),
                  _inputs(6), jax.random.PRNGKey(9))


def test_x0_has_no_vae_backward(stacks):
    """The x0 modes' loss is on the pixels: its gradient reaches the image
    through the resize alone (``src - target`` per pixel, over B), and no
    VAE op is differentiated."""
    _, _, tsd, tgp = stacks
    tsd = dataclasses.replace(tsd, loss_type="x0", denoise_timesteps=5)
    x = _inputs(6)
    T = torch.as_tensor
    img = T(x["img"]).requires_grad_(True)
    out = tsd(tgp, img, T(x["ctx"]), T(x["unc"]), T(x["t"]),
              noise=torch.randn(B, LATENT, LATENT, 4), cond_image=T(x["cond"]))
    assert not out["latents"].requires_grad
    assert not out["target"].requires_grad
    out["loss"].backward()
    _close(out["gradients"] / B, img.grad, tol=1e-6)
    with pytest.raises(ValueError):
        tsd.latent_gradients(tgp, T(x["lat"]), T(x["ctx"]), T(x["unc"]),
                             T(x["t"]), noise=T(x["lat"]))


@pytest.mark.parametrize("side", [LATENT, 12])
def test_latent_input_matches_jax(stacks, side):
    """``latent_input``: the 4-channel render is the latents, kept at the
    latent grid's size and resized from another; the SDS loss's gradient
    reaches the render without the VAE."""
    jsd, jgp, tsd, tgp = stacks
    jsd = dataclasses.replace(jsd, latent_input=True)
    tsd = dataclasses.replace(tsd, latent_input=True)
    x = _inputs(7)
    render = np.random.default_rng(8).normal(
        size=(B, side, side, 4)).astype(np.float32)
    T = torch.as_tensor
    _close(jsd.encode_images(jgp, render),
           tsd.encode_images(tgp, T(render)))
    key = jax.random.PRNGKey(10)
    noise = _normal(jax.random.split(key)[0], x["lat"].shape)

    def jloss(r):
        return jsd(jgp, r, x["ctx"], x["unc"], x["t"], key,
                   cond_image=x["cond"])["loss"]

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(render))
    r = T(render).requires_grad_(True)
    tl = tsd(tgp, r, T(x["ctx"]), T(x["unc"]), T(x["t"]), noise=T(noise),
             cond_image=T(x["cond"]))["loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    tl.backward()
    _close(jgrad, r.grad)
    with pytest.raises(ValueError):
        tsd.encode_images(tgp, T(x["img"]))


def test_vae_sampled_encode_matches_jax(stacks):
    """The posterior sample mean + exp(0.5 clip(logvar)) n with the JAX
    draw of n, against the mode without it."""
    jsd, jgp, tsd, tgp = stacks
    x = _inputs(9)
    key = jax.random.PRNGKey(11)
    T = torch.as_tensor
    jlat = jsd.vae.encode(jgp.vae, x["img"], key=key)
    n = _normal(key, jlat.shape)
    with torch.no_grad():
        tlat = tgp.vae.encode(T(x["img"]), noise=T(n))
        mode = tgp.vae.encode(T(x["img"]))
        drawn = tgp.vae.encode(T(x["img"]),
                               generator=torch.Generator().manual_seed(0))
    _close(jlat, tlat)
    _close(jsd.vae.encode(jgp.vae, x["img"]), mode)
    assert float((tlat - mode).abs().max()) > 1e-3
    assert drawn.shape == mode.shape and not torch.equal(drawn, mode)

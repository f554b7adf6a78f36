"""The guidance families through the B-view steps, on the CPU.

The port's B-view steps send the B views' images through one guidance
call (a CFG batch of 2B) where the JAX DP steps call the guidance once a
view under ``vmap`` and take the views' mean. The two agree only where
nothing inside the call reduces across its batch. Held here, each family
at B = 2 (t = 999 and 120, so nfsd's domain term and ISM's inversion take
both branches) against the JAX per-view calls' mean: the loss (a score
family's within ``TOL`` of the sum of its terms' magnitudes, as
``test_torch_nerf_step.py`` holds it) and the gradient that reaches the
rendered images, with each view's noise the JAX
draw from its own key (``test_torch_guidance_families.py``'s stacks and
inputs, its ``TOL``): sds, sds with the latent clip and the CFG rescale
(the clip's statistic is each view's own), csd's annealed mix, nfsd, ISM,
z0, z0_final and x0.

And csd with ``progress`` and the negative branch through the whole
avatar DP step against the JAX ``make_avatar_sds_step_dp``
(``test_torch_dp_avatar.py``'s case and envelope).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch.parallel.dp import _expand
from tests.test_torch_dp_avatar import check_against_jax, run_jax
from tests.test_torch_guidance_families import (  # noqa: F401  (fixture)
    TOL,
    _close,
    _inputs,
    _normal,
    stacks,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

B = 2
FAMILIES = {
    "sds": dict(loss_type="sds"),
    # a low clip scale, so that the clip binds on every view
    "sds_clip_rescale": dict(loss_type="sds", grad_latent_clip=True,
                             grad_latent_clip_scale=0.5,
                             guidance_rescale=0.7),
    "csd_mix": dict(loss_type="csd"),
    "nfsd": dict(loss_type="nfsd"),
    "ism": dict(loss_type="ism", weight_type="ism", ism_xs_inv_steps=2),
    "z0": dict(loss_type="z0"),
    "z0_final": dict(loss_type="z0_final", denoise_timesteps=10),
    "x0": dict(loss_type="x0"),
}
NEG = ("csd_mix", "nfsd")     # the families given the negative branch
PROGRESS = {"csd_mix": 0.4, "ism": 0.2}


def _jax_view_mean(jsd, jgp, neg):
    """The JAX DP steps' guidance: one call a view under ``vmap``, the
    views' mean; its value and gradient in the images."""
    def one(im, ctx, unc, t, key, cond, p):
        return jsd(jgp, im[None], ctx[None], unc[None], t[None], key,
                   cond_image=cond[None], neg_embeds=neg,
                   progress=p)["loss"]

    def loss(ims, ctx, unc, t, keys, cond, p):
        return jnp.mean(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None))(
            ims, ctx, unc, t, keys, cond, p))

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_guidance_equals_the_views_mean(stacks, family):
    jsd, jgp, tsd, tgp = stacks
    fields = FAMILIES[family]
    jsd = dataclasses.replace(jsd, **fields)
    tsd = dataclasses.replace(tsd, **fields)
    x = _inputs(4)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    lt = fields["loss_type"]
    shape = (1,) + x["lat"].shape[1:]
    noise = np.concatenate([
        _normal(k if lt[:2] in ("z0", "x0") else jax.random.split(k)[0],
                shape) for k in keys])
    neg = x["neg"][:1] if family in NEG else None
    progress = PROGRESS.get(family)
    jl, jgrad = _jax_view_mean(jsd, jgp, None if neg is None
                               else jnp.asarray(neg))(
        x["img"], x["ctx"], x["unc"], x["t"], keys, x["cond"],
        None if progress is None else np.float32(progress))
    T = torch.as_tensor
    img = T(x["img"]).requires_grad_(True)
    out = tsd(tgp, img, T(x["ctx"]), T(x["unc"]), T(x["t"]),
              noise=T(noise), cond_image=T(x["cond"]),
              neg_embeds=None if neg is None else _expand(T(neg), B),
              progress=progress)
    # a score family's loss, sum(latents * grad) / B, is a sum whose terms
    # cancel: held to TOL of the sum of their magnitudes
    terms = float(jl)
    if lt[:2] not in ("z0", "x0"):
        terms = float((out["latents"].detach().float()
                       * out["gradients"]).abs().sum()) / B
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl),
                               rtol=TOL, atol=TOL * abs(terms))
    out["loss"].backward()
    assert float(np.abs(np.asarray(jgrad)).max()) > 0
    _close(jgrad, img.grad)


def test_csd_with_progress_through_the_dp_step_matches_jax():
    want, port = run_jax("shared_pose",
                         family=dict(loss_type="csd", progress=0.4))
    check_against_jax(want, port)

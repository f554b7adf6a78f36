"""Parity of the small host-side and autograd pieces around the SDS step
against the JAX package, on the CPU: the pixel-gradient hooks (every mode,
suppress types 0-5 and the identity, the masked variant), the render resize
of ``encode_images``, the timestep scheduler (integer for integer) and the
OpenPose canvas (equal arrays).

Hook backwards agree within 1e-6 of the gradient's largest entry (the same
float32 formulas; reductions sum in another order). The resize agrees within
2e-6 absolute on [0, 1] images, up- and down-scaling: ``F.interpolate`` with
``antialias=True`` applies the same triangle kernel, widened by the scale
when it shrinks, as ``jax.image.resize(..., "bilinear")``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import GuideConfig as JGuideConfig
from dreamwaltz_g_tpu.guidance import sds as JS
from dreamwaltz_g_tpu.guidance import time_prior as JT
from dreamwaltz_g_tpu.human import openpose as JP
from dreamwaltz_g_tpu_torch.configs import GuideConfig
from dreamwaltz_g_tpu_torch.guidance import sds as TS
from dreamwaltz_g_tpu_torch.guidance import time_prior as TT
from dreamwaltz_g_tpu_torch.human import openpose as TP
import tests.torch_threads  # noqa: F401  (per-worker threads)

HOOK_TOL = 1e-6
RESIZE_TOL = 2e-6


def _image_and_grad(seed, with_nan=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(12, 10, 3)).astype(np.float32)
    # gradients of mixed magnitude, some exactly zero
    g = (rng.normal(size=(12, 10, 3)) * 10 ** rng.uniform(
        -3, 1, size=(12, 10, 1))).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.1] = 0.0
    if with_nan:
        g[3, 4, 1] = np.nan
        g[7, 2, 0] = np.inf
    return x, g


def _jax_backward(hook, x, g, *extra):
    _, vjp = jax.vjp(lambda x_: hook(x_, *extra), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _torch_backward(hook, x, g, *extra):
    tx = torch.as_tensor(x).requires_grad_(True)
    y = hook(tx, *extra)
    assert torch.equal(y.detach(), tx.detach())       # identity forward
    y.backward(torch.as_tensor(g))
    return tx.grad.numpy()


def _close(got, want, tol=HOOK_TOL):
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    assert float(np.abs(got[ok] - want[ok]).max()) \
        <= tol * max(float(np.abs(want[ok]).max()), 1e-30)


@pytest.mark.parametrize("mode", ["clip", "std_clip", "normalize"])
def test_make_pgc_backward_matches_jax(mode):
    x, g = _image_and_grad(1)
    _close(_torch_backward(TS.make_pgc(0.1, mode), x, g),
           _jax_backward(JS.make_pgc(0.1, mode), x, g))


@pytest.mark.parametrize("suppress_type", [0, 1, 2, 3, 4, 5, 9])
def test_make_pgc_suppress_backward_matches_jax(suppress_type):
    x, g = _image_and_grad(2)
    _close(_torch_backward(TS.make_pgc_suppress(0.05, suppress_type), x, g),
           _jax_backward(JS.make_pgc_suppress(0.05, suppress_type), x, g))


@pytest.mark.parametrize("clip,norm,with_nan", [
    (True, False, False), (False, True, False), (True, True, False),
    (True, True, True), (False, False, False)])
def test_rgb_grad_hook_backward_matches_jax(clip, norm, with_nan):
    x, g = _image_and_grad(3, with_nan)
    _close(_torch_backward(TS.make_rgb_grad_hook(clip, norm, 2.5), x, g),
           _jax_backward(JS.make_rgb_grad_hook(clip, norm, 2.5), x, g))


@pytest.mark.parametrize("clip,norm,with_nan", [
    (True, False, False), (True, True, True), (False, True, False)])
def test_masked_rgb_grad_hook_backward_matches_jax(clip, norm, with_nan):
    """The masked variant: the std statistic over mask > 0.5 pixels only,
    and no gradient to the mask."""
    x, g = _image_and_grad(4, with_nan)
    mask = np.random.default_rng(5).uniform(size=(12, 10, 1)).astype(
        np.float32)
    jhook = JS.make_rgb_grad_hook(clip, norm, 2.0, with_mask=True)
    thook = TS.make_rgb_grad_hook(clip, norm, 2.0, with_mask=True)
    assert jhook.wants_mask and thook.wants_mask
    _close(_torch_backward(thook, x, g, torch.as_tensor(mask)),
           _jax_backward(jhook, x, g, jnp.asarray(mask)))
    tm = torch.as_tensor(mask).requires_grad_(True)
    thook(torch.as_tensor(x).requires_grad_(True), tm).backward(
        torch.as_tensor(np.nan_to_num(g)))
    assert float(tm.grad.abs().max()) == 0.0


@pytest.mark.parametrize("fields,kind", [
    ({}, None),
    (dict(grad_rgb_clip=True), "rgb"),
    (dict(grad_rgb_norm=True, grad_rgb_clip_scale=1.5), "rgb"),
    (dict(grad_rgb_clip=True, grad_rgb_clip_mask_guidance=True), "masked"),
    (dict(pgc_clip_rgb=0.1, pgc_suppress_type=4), "suppress"),
    (dict(pgc_clip_rgb=0.0, grad_rgb_clip=True), "suppress"),
])
def test_build_pixel_grad_hook_matches_jax(fields, kind):
    """The hook a config selects (None at the defaults) and its backward."""
    jhook = JS.build_pixel_grad_hook(JGuideConfig(**fields))
    thook = TS.build_pixel_grad_hook(GuideConfig(**fields))
    if kind is None:
        assert jhook is None and thook is None
        return
    x, g = _image_and_grad(6)
    extra_j, extra_t = (), ()
    if kind == "masked":
        mask = np.random.default_rng(7).uniform(size=(12, 10, 1)).astype(
            np.float32)
        assert thook.wants_mask
        extra_j, extra_t = (jnp.asarray(mask),), (torch.as_tensor(mask),)
    else:
        assert not getattr(thook, "wants_mask", False)
    _close(_torch_backward(thook, x, g, *extra_t),
           _jax_backward(jhook, x, g, *extra_j))


def test_guide_config_defaults_match_jax():
    j, t = JGuideConfig(), GuideConfig(min_timestep="(0, 0.5, 0.02, 100)")
    for name in GuideConfig.__dataclass_fields__:
        if name != "min_timestep":
            assert getattr(t, name) == getattr(j, name), name
    assert t.min_timestep == (0, 0.5, 0.02, 100)


class _StubVAE:
    """A VAE of factor 2 whose encode returns its input: what reaches it is
    the resized render."""

    cfg = types.SimpleNamespace(block_out_channels=(1, 2))

    def encode(self, *args):
        return args[-1]


@pytest.mark.parametrize("size,interpolate,resized", [
    ((12, 12), True, True),      # up-scale to 16
    ((40, 40), True, True),      # down-scale, antialiased
    ((24, 20), True, True),      # not square
    ((16, 16), True, False),     # already the VAE's input
    ((768, 768), False, False),  # the native 768 exception
    ((24, 24), False, True),     # not a native size: resized all the same
    ((768, 512), False, True),   # 768 but not square
])
def test_encode_images_resize_matches_jax(size, interpolate, resized):
    rng = np.random.default_rng(sum(size))
    img = rng.uniform(size=(2,) + size + (3,)).astype(np.float32)
    jsd = JS.ScoreDistillation(unet=None, vae=_StubVAE(), latent_size=8,
                               input_interpolate=interpolate)
    tsd = TS.ScoreDistillation(schedule=TS.make_schedule(device="cpu"),
                               latent_size=8, input_interpolate=interpolate)
    jout = np.asarray(jsd.encode_images(
        JS.GuidanceParams(unet=None, vae=None), jnp.asarray(img)))
    tin = torch.as_tensor(img).requires_grad_(True)
    tout = tsd.encode_images(TS.GuidanceParams(unet=None, vae=_StubVAE()),
                             tin)
    assert tuple(tout.shape) == jout.shape == (
        (2, 16, 16, 3) if resized else img.shape)
    assert float(np.abs(tout.detach().numpy() - jout).max()) <= RESIZE_TOL
    tout.sum().backward()                   # the graph is kept
    assert float(tin.grad.abs().max()) > 0


_SCHED_CASES = [
    dict(time_sampling="uniform"),
    dict(time_sampling="constant"),
    dict(time_sampling="linear"),
    dict(time_sampling="stage"),
    dict(time_sampling="stage-3", min_timestep=0.1, max_timestep=0.9),
    dict(time_sampling="annealed"),                     # linear, impulse
    dict(time_sampling="annealed", time_annealing="hifa",
         time_annealing_window="square,middle"),
    dict(time_sampling="annealed", time_annealing="linear,800,200,2.0",
         time_annealing_window="square,lower,100"),
    dict(time_sampling="annealed", time_annealing="dreamtime",
         time_annealing_window="square,upper,50"),
    dict(time_sampling="annealed", time_annealing="dreamtime-p2,700,200",
         time_annealing_window="normal,middle"),
    dict(time_sampling="annealed", time_annealing="ddpm",
         time_annealing_window="normal,lower,120"),
    dict(time_sampling="annealed", time_annealing="normal,600,150,400,80",
         time_annealing_window="normal,upper"),
    dict(time_sampling="annealed", time_annealing="uniform",
         time_annealing_window="square,tail,100"),
    dict(time_sampling="annealed", time_annealing="p2",
         time_annealing_window="normal,tail,150"),
    dict(time_sampling="annealed",
         min_timestep="(0, 0.3, 0.02, 30)", max_timestep=(0.0, 0.98, 0.5, 1.0),
         time_annealing_window="square,middle,60"),
]


@pytest.mark.parametrize("fields", _SCHED_CASES,
                         ids=[str(i) for i in range(len(_SCHED_CASES))])
def test_scheduler_timesteps_match_jax(fields):
    """Every ``time_sampling`` mode, annealing and window over 50 steps of
    a 50-step run: the same integers from the same seed."""
    js = JT.TimePrioritizedScheduler(JGuideConfig(**fields), seed=3)
    ts = TT.TimePrioritizedScheduler(GuideConfig(**fields), seed=3,
                                     device="cpu")
    got, want = [], []
    for step in range(1, 51):
        want.append(js.get_timestep(2, step, 50))
        got.append(ts.get_timestep(2, step, 50))
        assert got[-1].dtype == np.int32
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert 0 <= np.stack(got).min() and np.stack(got).max() <= 999
    np.testing.assert_array_equal(ts.get_ism_timestep(3, 10, 50),
                                  js.get_ism_timestep(3, 10, 50))


@pytest.mark.parametrize("adjust", ["constant", "uniform", "linear",
                                    "linear_reverse", "anneal"])
def test_scheduler_guidance_scale_matches_jax(adjust):
    fields = dict(guidance_adjust=adjust, guidance_scale=30.0)
    js = JT.TimePrioritizedScheduler(JGuideConfig(**fields), seed=1)
    ts = TT.TimePrioritizedScheduler(GuideConfig(**fields), seed=1,
                                     device="cpu")
    for step in range(1, 51):
        assert ts.get_guidance_scale(step, 50) \
            == js.get_guidance_scale(step, 50)
    for value in (3.0, (10, 1.0, 2.0, 20), [0.0, 4.0, 10], (0.1, 0., 1., 0.5)):
        for step in (0, 5, 15, 40):
            assert TT.C(value, step, 50) == JT.C(value, step, 50)
    with pytest.raises(NotImplementedError):
        TT.TimePrioritizedScheduler(GuideConfig(guidance_adjust="nope"),
                                    device="cpu").get_guidance_scale(1, 50)


def _keypoints(seed, n=128):
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0.05, 0.95, size=(n, 2)).astype(np.float32)
    kp[rng.uniform(size=n) < 0.1] = np.nan          # absent points
    return kp


@pytest.mark.parametrize("size,kw", [
    ((512, 512), {}),
    ((256, 384), dict(draw_face_kp=True)),
    ((768, 768), dict(flip_lr=True, draw_hand_kp=False)),
    ((128, 128), dict(draw_body_kp=False, draw_face_kp=True)),
])
def test_draw_openpose_map_equals_jax(size, kw):
    people = [_keypoints(1), _keypoints(2)]
    want = JP.draw_openpose_map(people, *size, **kw)
    got = TP.draw_openpose_map(people, *size, **kw)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0
    body_only = TP.draw_openpose_map([_keypoints(3, 18)], *size)
    np.testing.assert_array_equal(
        body_only, JP.draw_openpose_map([_keypoints(3, 18)], *size))

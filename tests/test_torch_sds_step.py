"""The stage-2 avatar SDS step of the port against the JAX package, whole:
the tiny avatar (carried over by ``convert.avatar_state_from_numpy``) and
the tiny guidance with its ControlNet (weights through ``convert.py``), in
float32 on the CPU, with the JAX draw of the noise handed to the port.

JAX side: ``jax.value_and_grad`` over ``gs_trainer._render_with_dummy`` and
the guidance, built as ``make_avatar_sds_step``'s ``loss_fn`` is, then the
optax update and ``update_avatar_stats``. Its render blends the (T, K)
table with the jnp blend (no early stop); the port's with the plain train
blend (the TPU kernels' tile stop). No tile here has every pixel below
T = 1e-4, so the tile stop never acts and the two differ by float32
rounding only.

The background is textured: over a flat one, the VAE's GroupNorms see
near-constant groups, where Flax's variance E[x^2] - E[x]^2 loses most of
its digits (torch's does not), and the latents then differ by ~1e-4.

A second case runs the whole step with the pixel-gradient hook set
(``grad_rgb_clip`` and ``grad_rgb_norm``) and ``FLASH_ATTENTION = "on"`` in
both packages, the length gate lowered to the 256 tokens of the tiny UNet's
and VAE's attention: the JAX side through its interpreted TPU kernel, the
port through the flash wrapper's plain version. Same envelope."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import GuideConfig as JGuideConfig
from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.guidance import layers as JL
from dreamwaltz_g_tpu.guidance import sds as JS
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import GuideConfig, RenderConfig
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.guidance import layers as TL
from dreamwaltz_g_tpu_torch.guidance import sds as TS
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
import tests.torch_threads  # noqa: F401  (per-worker threads)

H = W = 32
LATENT = 16                  # the tiny VAE halves: a 32^2 render
RASTER = dict(tile_size=16, capacity=64, chunk=32, max_tiles_per_gaussian=16)
MAX_STEPS = 5000
# float32 through SMPL-X, GLBS, the field, two MLPs, the blend, the VAE and
# the UNet, forward and backward, in two frameworks: the loss within 1e-4
# relative, each gradient within 2e-3 relative plus 2e-4 of its largest
# entry (the JAX package's envelope for its own train blend)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4
# at eps = 1e-15 Adam's first step is +-lr sign(g): compare the updated
# parameters only where |g| exceeds 1e-3 of the field's largest, where the
# sign cannot flip on rounding
UPDATE_MIN_GRAD = 1e-3


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


HOOK = dict(grad_rgb_clip=True, grad_rgb_norm=True)


# the csd family's annealed mix: the negative branch and the run's progress
CSD = dict(loss_type="csd", progress=0.4)


def _make_case(guide_fields=None, flash=False, family=None):
    """The JAX step's results and the port's twin inputs; ``guide_fields``
    selects the pixel-gradient hook of the JAX render; ``family`` (e.g.
    ``CSD``) the loss family and the step's ``progress``, with a negative
    branch drawn here. With ``flash`` the
    JAX step runs with ``FLASH_ATTENTION = "on"`` (the length gate at the
    tiny models' 256 tokens) through the interpreted TPU kernel; the
    guidance's Flax init runs outside that mode (an init run through the
    interpreter, eagerly, hung in its kernel on a loaded machine; the init
    draws the same weights either way)."""
    jpgc = None if guide_fields is None else JS.build_pixel_grad_hook(
        JGuideConfig(**guide_fields))
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    jsd, jgp = jts.tiny_guidance(jax.random.PRNGKey(0), with_controlnet=True,
                                 latent_size=LATENT)
    rng = np.random.default_rng(0)
    trees = {k: _np_tree(getattr(jgp, k)) for k in ("unet", "vae",
                                                    "controlnet")}
    cn = trees["controlnet"]["params"]
    for name, mod in cn.items():   # the zero convs carry values here
        if name.startswith("controlnet_") and name != \
                "controlnet_cond_embedding":
            for k in mod:
                mod[k] = rng.normal(size=mod[k].shape).astype(np.float32) * .2
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})

    cam = dict(radius=2.0, theta=20.0, phi=90.0, fovy=50.0)
    jc = jcamera(*cam.values(), H, W, at_vector=((0, 0.7, 0),))
    f32 = np.float32
    inputs = dict(
        txt=rng.normal(size=(1, 4, 32)).astype(f32),
        unc=np.zeros((1, 4, 32), f32),
        t=np.array([500], np.int32),
        cond=rng.uniform(size=(1, H, W, 3)).astype(f32),
        bg=rng.uniform(size=(H, W, 3)).astype(f32))
    fam = {}
    if family is not None:
        import dataclasses

        jsd = dataclasses.replace(jsd, loss_type=family["loss_type"])
        inputs["neg"] = rng.normal(size=(1, 4, 32)).astype(f32)
        fam = dict(neg_embeds=inputs["neg"], progress=family["progress"])
    key = jax.random.PRNGKey(3)
    k_noise, _ = jax.random.split(key)
    inputs["noise"] = np.asarray(jax.random.normal(
        k_noise, (1, LATENT, LATENT, 4), dtype=jnp.float32))

    state = jset.state
    C = state.capacity
    M = jset.model.n_mesh_points

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
            jnp.asarray(inputs["bg"]), H, W, RASTER, pgc=jpgc)
        sds = jsd(jgp, image[None], inputs["txt"], inputs["unc"],
                  inputs["t"], key, cond_image=inputs["cond"], **fam)
        return sds["loss"], (out.radii, out.alpha)

    old = (JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ)
    interpret = pltpu.force_tpu_interpret_mode() if flash \
        else contextlib.nullcontext()
    if flash:
        JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ = "on", 256
    try:
        with interpret:
            (loss, (radii, alpha)), (grads, dgrad) = jax.jit(
                jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
                state.params, jnp.zeros((C + M, 2), jnp.float32))
    finally:
        JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ = old
    assert float(alpha.max()) > 0.5          # the body covers pixels
    tx = JO.build_avatar_optimizer(JRenderConfig(), MAX_STEPS)
    upd, _ = tx.update(grads, tx.init(state.params), state.params)
    new_params = optax.apply_updates(state.params, upd)
    new_state = JA.update_avatar_stats(state._replace(params=new_params),
                                       dgrad[:C], radii[:C])
    jax_out = dict(loss=float(loss), grads=grads, dgrad=np.asarray(dgrad),
                   new=new_state)

    tset = tts.tiny_avatar_setup(device="cpu")
    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True, latent_size=LATENT,
                                 device="cpu")
    if family is not None:
        tsd.loss_type = family["loss_type"]
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    tc = tcamera(*cam.values(), H, W, at_vector=((0, 0.7, 0),), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, state)
    T = torch.as_tensor
    port = dict(model=tset.model, sd=tsd, gp=tgp, observed=tset.observed,
                cam=(tc.extrinsic[0], tc.intrinsics[0], tc.tanfov[0]),
                inputs={k: T(v) for k, v in inputs.items()},
                fresh=lambda: avatar_state_from_numpy(tree, tset.model,
                                                      device="cpu"),
                progress=None if family is None else family["progress"])
    return jax_out, port


@pytest.fixture(scope="module")
def case():
    return _make_case()


@pytest.fixture(scope="module")
def flash_case():
    """The JAX step with the pixel-gradient hook and the interpreted TPU
    flash kernel in the tiny UNet (256 tokens, d = 16) and VAE (256
    tokens, d = 64)."""
    return _make_case(HOOK, flash=True)


def _fields(params, model):
    """(name, torch leaf, JAX-layout accessor) for every trainable tensor."""
    out = [(n, getattr(params, n), lambda p, n=n: getattr(p, n))
           for n in ("positions", "log_scales", "quats", "lbs_weights",
                     "extra_betas")]
    out.append(("encoder.planes", params.encoder.planes,
                lambda p: p.encoder.planes))
    for f in params.mesh["face"]._fields:
        out.append((f"mesh.{f}", getattr(params.mesh["face"], f),
                    lambda p, f=f: getattr(p.mesh["face"], f)))
    for net_name in ("color_mlp", "sq_net"):
        net = getattr(model, net_name)
        for lname, lin in net.named_children():
            out.append((f"{net_name}.{lname}.kernel", lin.weight,
                        lambda p, a=net_name, b=lname:
                        np.asarray(getattr(p, a)["params"][b]["kernel"]).T))
            out.append((f"{net_name}.{lname}.bias", lin.bias,
                        lambda p, a=net_name, b=lname:
                        getattr(p, a)["params"][b]["bias"]))
    return out


def _check_grad(name, got, want):
    want = np.asarray(want)
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float((err - bound).max()),
                                  float(np.abs(want).max()))


def test_sds_loss_and_gradients_match_jax(case):
    """The loss, the gradient of every AvatarParams field and network
    weight, and the screen-space (``dummy``) gradient."""
    jax_out, port = case
    model = port["model"]
    state = port["fresh"]()
    x = port["inputs"]
    for _, leaf, _ in _fields(state.params, model):
        leaf.requires_grad_(True)
        leaf.grad = None
    C = state.capacity
    dummy = torch.zeros((C + model.n_mesh_points, 2), requires_grad=True)
    image, out = TG._render_with_dummy(
        model, state, state.params, port["observed"], dummy, *port["cam"],
        x["bg"], H, W, dict(RASTER, mode="train"))
    sds = port["sd"](port["gp"], image[None], x["txt"], x["unc"], x["t"],
                     noise=x["noise"], cond_image=x["cond"])
    sds["loss"].backward()
    np.testing.assert_allclose(float(sds["loss"].detach()), jax_out["loss"],
                               rtol=LOSS_RTOL)
    _check_grad("dummy", dummy.grad.numpy(), jax_out["dgrad"])
    scale = float(np.abs(np.asarray(jax_out["grads"].positions)).max())
    for name, leaf, get in _fields(state.params, model):
        # a tensor the loss does not reach (the extra betas, unused unless
        # hand or face betas are learned) gets None here, zeros in JAX
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        if name == "quats":
            # every Gaussian starts isotropic, so the rotation's gradient is
            # zero in exact arithmetic: in both it is float32 noise, far
            # below the positions' gradient
            assert float(got.abs().max()) < 1e-6 * scale
            assert float(np.abs(get(jax_out["grads"])).max()) < 1e-6 * scale
            continue
        _check_grad(name, got.numpy(), get(jax_out["grads"]))


def test_sds_step_matches_jax(case):
    """``make_avatar_sds_step`` on the CPU: the loss, the densification
    stats and, where the gradient is well above rounding, the updated
    parameters after one step; the kernels did not launch."""
    _check_step(*case)


def test_sds_step_csd_with_progress_matches_jax():
    """The same step on the csd family's annealed three-term mix: the
    constructor's ``neg_embeds`` and the step's ``progress`` reach the
    guidance (the JAX step's loss takes both)."""
    _check_step(*_make_case(family=CSD))


def test_sds_step_with_flash_and_pixel_hook_matches_jax(flash_case,
                                                        monkeypatch):
    """The same, with ``pgc`` set and ``FLASH_ATTENTION = "on"`` on both
    sides; the port's attention went through the flash wrapper (its plain
    version on the CPU) in the UNet, the ControlNet and the VAE."""
    monkeypatch.setattr(TL, "FLASH_ATTENTION", "on")
    monkeypatch.setattr(TL, "FLASH_MIN_SEQ", 256)
    calls = []
    flash = TL.flash_self_attention
    monkeypatch.setattr(TL, "flash_self_attention",
                        lambda *a: calls.append(a[0].shape) or flash(*a))
    grads = _check_step(*flash_case,
                        pgc=TS.build_pixel_grad_hook(GuideConfig(**HOOK)))
    assert sorted(set(calls)) == [(1, 256, 1, 64), (2, 256, 2, 16)]
    # the hook normalised the image gradient, so the gradients are another
    # size than the plain case's: held to the JAX step's own
    jax_out, port = flash_case
    for name, leaf, get in _fields(grads, port["model"]):
        if name == "quats" or leaf.grad is None:
            continue
        _check_grad(name, leaf.grad.numpy(), get(jax_out["grads"]))


def _check_step(jax_out, port, pgc=None):
    model = port["model"]
    x = port["inputs"]
    tx = TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS)
    tstate = TG.init_avatar_train_state(port["fresh"](), tx, model)
    step = TG.make_avatar_sds_step(model, port["sd"], H, W, pgc=pgc,
                                   neg_embeds=x.get("neg"), device="cpu",
                                   **RASTER)
    launches = (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches)
    new, metrics = step(tstate, port["gp"], port["observed"], *port["cam"],
                        x["bg"], x["txt"], x["unc"], x["t"],
                        noise=x["noise"], cond_image=x["cond"],
                        progress=port["progress"])
    assert (BT.blend_train_fwd.launches,
            BT.blend_train_bwd.launches) == launches   # CPU: plain versions
    assert new.step == 1 and tstate.opt_state.count == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_out["loss"],
                               rtol=LOSS_RTOL)
    assert 0.0 <= float(metrics["tile_overflow"]) < 1.0
    jnew = jax_out["new"]
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    np.testing.assert_array_equal(new.avatar.max_radii.numpy(),
                                  np.asarray(jnew.max_radii))
    assert float(new.avatar.grad_denom.sum()) > 0
    _check_grad("grad_accum", new.avatar.grad_accum.numpy(),
                jnew.grad_accum)
    for name, leaf, get in _fields(new.avatar.params, model):
        if name == "quats":   # a noise-level gradient: its sign is noise
            continue
        g = np.asarray(get(jax_out["grads"]))
        sure = np.abs(g) > UPDATE_MIN_GRAD * max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(leaf.detach().numpy()[sure],
                                   np.asarray(get(jnew.params))[sure],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    return new.avatar.params

"""The vanilla avatar (``--render.gs_type vanilla``) of the port against the
JAX package, on the CPU: ``ops/sh.py``, ``gaussian/model.py``,
``gaussian/densify.py``'s vanilla pass, ``system/vanilla.py``,
``training/optim.py:build_gaussian_optimizer`` and ``gs_trainer.py``'s
vanilla step and render.

The body is the synthetic stick body (120 vertices, 6 joints) of the
tiny avatar, the cloud its 64 points in a 96-slot buffer, Gaussians 3 cm
wide so that they cover pixels of a 32^2 render, the tiny float32
guidance with seeded weights (``tests/torch_jax_pairs.py``). The render's
chunk equals its tile capacity, so the plain blends' tile stop never acts
(the JAX jnp blend has none).

Tolerances: forward values within 1e-5 of the largest entry (float32),
geometry through SMPL-X and the LBS solve within 1e-5 absolute; the step's
loss within 1e-4 relative, its gradients within 2e-3 relative + 2e-4 of
the largest entry, its updated parameters within 1e-6 where the gradient
is well above rounding; the densification masks, the alive masks and the
visibility counts equal; the optimizer within 1e-6 of optax over 3
updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.gaussian import densify as JDen
from dreamwaltz_g_tpu.gaussian import model as JGM
from dreamwaltz_g_tpu.human import smplx_model as JSM
from dreamwaltz_g_tpu.ops import rasterize as JR
from dreamwaltz_g_tpu.ops import sh as JSH
from dreamwaltz_g_tpu.system import vanilla as JV
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.gaussian import densify as TDen
from dreamwaltz_g_tpu_torch.gaussian import model as TGM
from dreamwaltz_g_tpu_torch.human import smplx_model as TSM
from dreamwaltz_g_tpu_torch.ops import sh as TSH
from dreamwaltz_g_tpu_torch.system import vanilla as TV
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
    update_close,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

VAL_TOL = 1e-5
BODY = dict(num_vertices=120, num_joints=6, num_betas=3, num_expr=2, seed=0)
N_POINTS, CAPACITY = 64, 96
LATENT = 16
H = W = 2 * LATENT
RASTER = dict(tile_size=16, capacity=128, chunk=128,
              max_tiles_per_gaussian=16)
CAM = dict(radius=2.0, theta=20.0, phi=90.0, fovy=50.0)
MAX_STEPS = 100


def _close(got, want, tol=VAL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, (err, peak)


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) \
        else np.asarray(x)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    got = TSH.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d))
    _close(got.numpy(), want)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    _close(TSH.rgb_to_sh(torch.as_tensor(rgb)).numpy(),
           JSH.rgb_to_sh(jnp.asarray(rgb)))
    _close(TSH.sh_to_rgb(torch.as_tensor(sh[..., 0])).numpy(),
           JSH.sh_to_rgb(jnp.asarray(sh[..., 0])))


def _gauss_pair(seed=0, scale_rows=False):
    """A JAX GaussianState (64 points, 96 slots, random SH rest) and the
    port's ``init_state`` of the same inputs."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(N_POINTS, 3)).astype(np.float32) * 0.3
    col = rng.uniform(size=(N_POINTS, 3)).astype(np.float32)
    sc = rng.uniform(0.01, 0.05, size=(N_POINTS,) if scale_rows
                     else (N_POINTS, 3)).astype(np.float32)
    js = JGM.init_state(jnp.asarray(pos), jnp.asarray(col), CAPACITY,
                        init_opacity=0.7, init_scale=jnp.asarray(sc))
    ts = TGM.init_state(torch.as_tensor(pos), torch.as_tensor(col), CAPACITY,
                        init_opacity=0.7, init_scale=torch.as_tensor(sc))
    return js, ts


@pytest.mark.parametrize("scale_rows", [False, True])
def test_init_state_and_colors_match_jax(scale_rows):
    js, ts = _gauss_pair(scale_rows=scale_rows)
    for name in js.params._fields:
        _close(getattr(ts.params, name).numpy(), getattr(js.params, name))
    for name in ("alive", "grad_accum", "grad_denom", "max_radii"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    rest = np.random.default_rng(9).normal(
        size=js.params.sh_rest.shape).astype(np.float32) * 0.3
    jp = js.params._replace(sh_rest=jnp.asarray(rest))
    tp = ts.params._replace(sh_rest=torch.as_tensor(rest))
    campos = np.asarray([0.3, 1.0, 2.0], np.float32)
    for deg in (0, 3):
        _close(TGM.view_colors(tp, torch.as_tensor(campos), deg).numpy(),
               JGM.view_colors(jp, jnp.asarray(campos), deg))
    _close(TGM.dc_colors(tp).numpy(), JGM.dc_colors(jp))
    for fn in ("opacities", "rotations", "sh_coeffs"):
        _close(getattr(TGM, fn)(tp).numpy(), getattr(JGM, fn)(jp))
    _close(TGM.scales(tp, 0.03).numpy(), JGM.scales(jp, 0.03))


@pytest.fixture(scope="module")
def avatar():
    """The JAX vanilla avatar (cloud in zero pose by inverse LBS) and the
    port's ``init_vanilla_avatar`` of the same body and cloud."""
    jsmpl = JSM.make_synthetic_model(**BODY)
    tsmpl = TSM.make_synthetic_model(**BODY, device="cpu")
    jmodel = JV.VanillaAvatarModel(smpl=jsmpl,
                                   canonical_inputs=JSM.default_params(jsmpl),
                                   max_scale=0.05)
    tmodel = TV.VanillaAvatarModel(smpl=tsmpl,
                                   canonical_inputs=TSM.default_params(tsmpl),
                                   max_scale=0.05)
    rng = np.random.default_rng(0)
    cloud = (rng.normal(size=(N_POINTS, 3)) * 0.15
             + np.asarray([0, 0.7, 0])).astype(np.float32)
    col = rng.uniform(size=(N_POINTS, 3)).astype(np.float32)
    kw = dict(capacity=CAPACITY, init_scale=0.03, init_opacity=0.9)
    jstate = JV.init_vanilla_avatar(jmodel, jnp.asarray(cloud),
                                    jnp.asarray(col), **kw)
    tstate = TV.init_vanilla_avatar(tmodel, torch.as_tensor(cloud),
                                    torch.as_tensor(col), **kw)
    return jmodel, jstate, tmodel, tstate


def _pose(seed):
    rng = np.random.default_rng(seed)
    jsmpl = JSM.make_synthetic_model(**BODY)
    fields = {k: np.zeros(np.shape(v), np.float32)
              for k, v in JSM.default_params(jsmpl)._asdict().items()}
    fields["body_pose"] = (rng.normal(size=(1, 63)) * 0.3).astype(np.float32)
    fields["global_orient"] = (rng.normal(size=(1, 3)) * 0.2).astype(
        np.float32)
    return (JSM.SMPLXParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TSM.SMPLXParams(**{k: torch.as_tensor(v)
                               for k, v in fields.items()}))


def _port_state(jstate):
    return convert.vanilla_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


def test_init_vanilla_avatar_and_animate_match_jax(avatar):
    jmodel, jstate, tmodel, tstate = avatar
    np.testing.assert_array_equal(tstate.gaussians.alive.numpy(),
                                  np.asarray(jstate.gaussians.alive))
    np.testing.assert_allclose(tstate.lbs_weights.numpy(),
                               np.asarray(jstate.lbs_weights), atol=1e-5)
    for name in jstate.gaussians.params._fields:
        np.testing.assert_allclose(
            getattr(tstate.gaussians.params, name).numpy(),
            np.asarray(getattr(jstate.gaussians.params, name)), atol=1e-5,
            err_msg=name)
    jp, tp = _pose(1)
    ported = _port_state(jstate)
    campos = np.asarray([0.2, 0.9, 2.0], np.float32)
    for cp in (None, campos):
        jg = JV.animate_vanilla(jmodel, jstate, jp,
                                None if cp is None else jnp.asarray(cp))
        tg = TV.animate_vanilla(tmodel, ported, tp,
                                None if cp is None else torch.as_tensor(cp))
        for name in jg._fields:
            j, t = np.asarray(getattr(jg, name)), _np(getattr(tg, name))
            if j.dtype == bool:
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def step_case(avatar):
    """``jax.value_and_grad`` of the JAX vanilla step's loss (written as
    ``make_vanilla_sds_step``'s ``loss_fn`` is), the SH toward the camera,
    then the optax update and ``update_stats``."""
    jmodel, jstate, _, _ = avatar
    rest = np.random.default_rng(3).normal(
        size=jstate.gaussians.params.sh_rest.shape).astype(np.float32) * 0.2
    jstate = jstate._replace(gaussians=jstate.gaussians._replace(
        params=jstate.gaussians.params._replace(sh_rest=jnp.asarray(rest))))
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc = jcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),))
    jp, tp = _pose(2)
    rng = np.random.default_rng(4)
    x = dict(txt=rng.normal(size=(1, 4, 32)).astype(np.float32),
             unc=np.zeros((1, 4, 32), np.float32),
             t=np.array([500], np.int32),
             bg=rng.uniform(size=(H, W, 3)).astype(np.float32),
             campos=np.asarray(jc.c2w[0][:3, 3]))
    key = jax.random.PRNGKey(5)
    x["noise"] = sds_noise(key, LATENT)
    C = jstate.capacity

    def loss_fn(params, dummy):
        st = jstate._replace(gaussians=jstate.gaussians._replace(
            params=params))
        gs = JV.animate_vanilla(jmodel, st, jp, campos=x["campos"])
        g2d = JR.project_gaussians(
            gs.positions, JR.covariance3d(gs.quats, gs.scales),
            gs.opacities, gs.colors, jc.extrinsic[0], jc.intrinsics[0], H, W,
            tanfov=jc.tanfov[0], alive=gs.alive)
        g2d = g2d._replace(means2d=g2d.means2d + dummy)
        out = JR.rasterize_projected(g2d, H, W, **RASTER)
        image = out.image + (1.0 - out.alpha)[..., None] * x["bg"]
        sds = jsd(jgp, image[None], x["txt"], x["unc"], x["t"], key)
        return sds["loss"], (out.radii, jnp.mean(out.alpha))

    (loss, (radii, alpha)), (grads, dgrad) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        jstate.gaussians.params, jnp.zeros((C, 2)))
    assert float(alpha) > 0.05
    tx = JO.build_gaussian_optimizer(JRenderConfig(), MAX_STEPS)
    upd, _ = tx.update(grads, tx.init(jstate.gaussians.params),
                       jstate.gaussians.params)
    new = JDen.update_stats(jstate.gaussians._replace(
        params=optax.apply_updates(jstate.gaussians.params, upd)),
        dgrad[:C], radii[:C])
    T = torch.as_tensor
    return dict(loss=float(loss), grads=grads, dgrad=np.asarray(dgrad),
                new=new, jstate=jstate, tgp=tgp, tsd=tsd, tp=tp,
                cam=tcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),),
                            device="cpu"),
                x={k: T(v) for k, v in x.items()})


def test_vanilla_step_gradients_and_stats_match_jax(avatar, step_case):
    """``make_vanilla_sds_step``: the loss, every ``GaussianParams``
    gradient, the densification statistics, the updated parameters."""
    _, _, tmodel, _ = avatar
    c = step_case
    x = c["x"]
    tstate = TG.init_vanilla_train_state(
        _port_state(c["jstate"]),
        TO.build_gaussian_optimizer(RenderConfig(), MAX_STEPS))
    step = TG.make_vanilla_sds_step(tmodel, c["tsd"], H, W, device="cpu",
                                    **RASTER)
    cam = c["cam"]
    new, metrics = step(tstate, c["tgp"], c["tp"], cam.extrinsic[0],
                        cam.intrinsics[0], cam.tanfov[0], x["bg"], x["txt"],
                        x["unc"], x["t"], campos=x["campos"],
                        noise=x["noise"])
    assert new.step == 1 and tstate.opt_state.count == 1
    np.testing.assert_allclose(float(metrics["loss"]), c["loss"],
                               rtol=LOSS_RTOL)
    g = new.avatar.gaussians
    jnew = c["new"]
    np.testing.assert_array_equal(g.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    assert float(g.grad_denom.sum()) > 0
    np.testing.assert_allclose(g.max_radii.numpy(),
                               np.asarray(jnew.max_radii), rtol=1e-5)
    grad_close("grad_accum", g.grad_accum.numpy(), jnew.grad_accum)
    for name in g.params._fields:
        leaf = getattr(g.params, name)
        want = getattr(c["grads"], name)
        if name == "quats":
            # every Gaussian starts isotropic: the rotation's gradient is
            # float32 noise in both
            scale = float(np.abs(np.asarray(c["grads"].means)).max())
            assert float(leaf.grad.abs().max()) < 1e-5 * scale
            continue
        grad_close(name, leaf.grad.numpy(), want)
        update_close(name, leaf.detach().numpy(),
                     getattr(jnew.params, name), want)


def _densify_case():
    """A JAX GaussianState with statistics that clone, split and prune, more
    requests than free slots, and per-slot LBS rows riding along."""
    js, _ = _gauss_pair(seed=5)
    rng = np.random.default_rng(6)
    C = CAPACITY
    logs = np.log(rng.uniform(0.002, 0.03, size=(C, 3))).astype(np.float32)
    logit = rng.normal(size=(C, 1)).astype(np.float32) * 3.0
    quats = rng.normal(size=(C, 4)).astype(np.float32)
    js = js._replace(
        params=js.params._replace(log_scales=jnp.asarray(logs),
                                  opacity_logit=jnp.asarray(logit),
                                  quats=jnp.asarray(quats)),
        grad_accum=jnp.asarray(rng.uniform(0, 2, C).astype(np.float32)),
        grad_denom=jnp.asarray(rng.integers(0, 3, C).astype(np.float32)),
        max_radii=jnp.asarray(rng.uniform(0, 30, C).astype(np.float32)))
    lbs = rng.uniform(size=(C, 6)).astype(np.float32)
    cfg = dict(grad_threshold=0.4, min_opacity=0.05, max_screen_size=25.0)
    return js, lbs, cfg


@pytest.mark.parametrize("grad_prune", [False, True])
def test_densify_step_matches_jax(grad_prune):
    js, lbs, cfg = _densify_case()
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    shape = js.params.log_scales.shape
    offsets = (np.asarray(jax.random.normal(k1, shape)),
               np.asarray(jax.random.normal(k2, shape)))
    jnew, jwritten, jextras = JDen.densify_step(
        js, JDen.DensifyConfig(**cfg, grad_prune=grad_prune), key,
        extra_attrs={"lbs": jnp.asarray(lbs)})
    ts = TGM.GaussianState(
        params=TGM.GaussianParams(*[torch.as_tensor(np.array(a))
                                    for a in js.params]),
        **{k: torch.as_tensor(np.array(getattr(js, k)))
           for k in ("alive", "grad_accum", "grad_denom", "max_radii")})
    tnew, twritten, textras = TDen.densify_step(
        ts, TDen.DensifyConfig(**cfg, grad_prune=grad_prune),
        extra_attrs={"lbs": torch.as_tensor(lbs)}, offsets=offsets)
    np.testing.assert_array_equal(twritten.numpy(), np.asarray(jwritten))
    np.testing.assert_array_equal(tnew.alive.numpy(), np.asarray(jnew.alive))
    np.testing.assert_array_equal(textras["lbs"].numpy(),
                                  np.asarray(jextras["lbs"]))
    assert int(np.asarray(jwritten).sum()) > 0
    born = np.asarray(jnew.alive) & ~np.asarray(js.alive)
    assert born.any() != grad_prune     # children only outside grad-prune
    for name in jnew.params._fields:
        np.testing.assert_allclose(getattr(tnew.params, name).numpy(),
                                   np.asarray(getattr(jnew.params, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert tnew.params.means is ts.params.means     # written in place
    assert not tnew.grad_accum.any() and not tnew.grad_denom.any()


def test_reset_opacity_and_densify_vanilla_moments():
    """``reset_opacity`` against the JAX one; ``densify_vanilla`` zeroes the
    written slots' Adam moments in place and keeps the others."""
    js, lbs, cfg = _densify_case()
    ts = convert.vanilla_state_from_numpy(
        JV.VanillaAvatarState(js, jnp.asarray(lbs)), device="cpu")
    want = JDen.reset_opacity(js, 0.01).params.opacity_logit
    got = TDen.reset_opacity(ts.gaussians, 0.01).params.opacity_logit
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    ts = convert.vanilla_state_from_numpy(
        JV.VanillaAvatarState(js, jnp.asarray(lbs)), device="cpu")
    tstate = TG.init_vanilla_train_state(
        ts, TO.build_gaussian_optimizer(RenderConfig(), MAX_STEPS))
    for p in ts.gaussians.params:
        p.grad = torch.ones_like(p)
    tstate.opt_state.step()
    adam = tstate.opt_state.adam
    shape = js.params.log_scales.shape
    rng = np.random.default_rng(8)
    new = TG.densify_vanilla(tstate, TDen.DensifyConfig(**cfg), offsets=(
        rng.normal(size=shape), rng.normal(size=shape)))
    _, written, _ = TDen.densify_step(
        convert.vanilla_state_from_numpy(JV.VanillaAvatarState(
            js, jnp.asarray(lbs)), device="cpu").gaussians,
        TDen.DensifyConfig(**cfg), extra_attrs={"lbs": torch.as_tensor(lbs)},
        offsets=(rng.normal(size=shape), rng.normal(size=shape)))
    assert written.any() and not written.all()
    for p in ts.gaussians.params:
        for k in ("exp_avg", "exp_avg_sq"):
            m = adam.state[p][k]
            assert not m[written].any() and m[~written].all()
    assert new.avatar.lbs_weights.shape == lbs.shape


def test_gaussian_optimizer_matches_optax():
    """Six Adam groups (the means on the exponential schedule x spatial
    scale, the rest of the SH at feature_lr / 20) against optax over 3
    updates."""
    js, ts = _gauss_pair(seed=2)
    jcfg, tcfg = JRenderConfig(), RenderConfig()
    tx = JO.build_gaussian_optimizer(jcfg, MAX_STEPS, spatial_scale=2.5)
    jparams, jopt = js.params, tx.init(js.params)
    tstate = TG.init_vanilla_train_state(
        TV.VanillaAvatarState(ts, torch.zeros((CAPACITY, 6))),
        TO.build_gaussian_optimizer(tcfg, MAX_STEPS, spatial_scale=2.5))
    rng = np.random.default_rng(10)
    for _ in range(3):
        grads = [rng.normal(size=np.shape(p)).astype(np.float32)
                 for p in jparams]
        upd, jopt = tx.update(type(jparams)(*map(jnp.asarray, grads)), jopt,
                              jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(ts.params, grads):
            p.grad = torch.as_tensor(g)
        tstate.opt_state.step()
    assert [g["name"] for g in tstate.opt_state.adam.param_groups] == \
        ["pos", "dc", "rest", "opacity", "scale", "quat"]
    for name in jparams._fields:
        np.testing.assert_allclose(getattr(ts.params, name).detach().numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_vanilla_render_matches_jax(avatar):
    """``make_vanilla_render``: the JAX render's table blend on the CPU
    against the port's sorted blend (B2's plain version), the DC colors."""
    jmodel, jstate, tmodel, _ = avatar
    jp, tp = _pose(3)
    jc = jcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),))
    tc = tcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),), device="cpu")
    bg = np.full((H, W, 3), 0.3, np.float32)
    want = JG.make_vanilla_render(jmodel, H, W, **RASTER)(
        jstate, jp, jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
        jnp.asarray(bg))
    got = TG.make_vanilla_render(tmodel, H, W, device="cpu", **RASTER)(
        _port_state(jstate), tp, tc.extrinsic[0], tc.intrinsics[0],
        tc.tanfov[0], torch.as_tensor(bg))
    assert float(np.asarray(want[1]).max()) > 0.5
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", ["make_vanilla_render",
                                  "make_vanilla_sds_step"])
def test_vanilla_entry_points_default_to_cuda(avatar, name):
    """Without ``device=`` they ask for CUDA and, without it, raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    _, _, tmodel, _ = avatar
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "make_vanilla_render":
            TG.make_vanilla_render(tmodel, 8, 8)
        else:
            TG.make_vanilla_sds_step(tmodel, None, 8, 8)

"""The port's B-view stage-1 step (``parallel/dp.py:make_nerf_sds_step_dp``)
against the JAX ``make_nerf_sds_step_dp`` on a one-device
``make_mesh(dp=1)``, on the CPU, at B = 2 views, with sigma guidance on.

Fixtures of ``tests/test_torch_nerf_step.py``'s "plain" case (a tiny
triplane field with its background MLP composited, an occupancy grid
refreshed once, ray sparsity and volume sparsity on, the tiny guidance
with its ControlNet); each view's draws are the JAX step's, from its own
key split as the step splits it (``k_render`` the jitter, ``k_sds`` the
noise, ``k_vs`` the volume-sparsity points), handed to the port; the JAX
step takes the gradient-keeping transform of ``test_torch_dp_avatar.py``.
Compared: the loss and the sigma loss within 1e-4 relative and every
weight's gradient within 2e-3 relative + 2e-4 of its largest entry. The
JAX step runs op by op (``jax.disable_jit``): at the second view XLA's
compiled gradient of the render and the guidance parts from the op-by-op
one by up to 0.3% of the largest plane gradient (the same program jitted
without ``vmap`` gives the compiled numbers too), and the port agrees
with the op-by-op one.

And at B = 1, with the 'ddpm' per-timestep lr weights, the DP step equals
the single-view ``make_nerf_sds_step``: the loss and the gradients to
float32 rounding, the update where the gradient is well above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model as jsmpl
from dreamwaltz_g_tpu.parallel import dp as JDP
from dreamwaltz_g_tpu.parallel.mesh import make_mesh
from dreamwaltz_g_tpu.training import losses as JLo
from dreamwaltz_g_tpu.training import nerf_trainer as JT
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.guidance import sds as TS
from dreamwaltz_g_tpu_torch.guidance.time_prior import TimePrioritizedLR
from dreamwaltz_g_tpu_torch.parallel import dp as TDP
from dreamwaltz_g_tpu_torch.training import nerf_trainer as TT
from dreamwaltz_g_tpu_torch.training.losses import (SigmaGuidancePoints,
                                                    VolumeSparsityDraws)
from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer
from tests.test_torch_dp_avatar import _grab
from tests.test_torch_nerf_step import (FIELD, H, LATENT, LOSS_RTOL, MAX_IT,
                                        STEPS, W, _check_grad, _field,
                                        _guidance_trees, _pairs)
import tests.torch_threads  # noqa: F401  (per-worker threads)

B = 2
VIEWS = dict(radius=[2.5, 2.7], theta=[30.0, 60.0], phi=[80.0, 170.0],
             fovy=[50.0, 45.0])


def _view_draws(key, b):
    """One view's draws as the JAX DP step splits its key (``b`` the
    field's bound)."""
    k_render, k_sds, k_vs = jax.random.split(
        jax.random.wrap_key_data(key), 3)
    n_sh = 4096 // 2
    k_u, k_pick, k_axis, k_coord = jax.random.split(k_vs, 4)
    T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return dict(
        jitter=T(jax.random.uniform(k_render, TT.jitter_shape(H, W, 0,
                                                              STEPS))),
        noise=T(jax.random.normal(jax.random.split(k_sds)[0],
                                  (1, LATENT, LATENT, 4))),
        vs=VolumeSparsityDraws(*[T(d) for d in (
            jax.random.uniform(k_u, (4096 - n_sh, 3), minval=-b, maxval=b),
            jax.random.randint(k_pick, (n_sh,), 0, H * W),
            jax.random.randint(k_axis, (n_sh,), 0, 3),
            jax.random.uniform(k_coord, (n_sh, 1), minval=-b, maxval=b),
            jax.random.uniform(k_pick, (n_sh, 3), minval=-b, maxval=b))]))


@pytest.fixture(scope="module")
def case():
    """The JAX field, guidance and inputs and the port's twins; a test that
    steps the port's field restores its weights."""
    fields = dict(FIELD, detach_bg_weights_sum=False)
    jcfg, jmodel, params, grid, tmodel, tgrid = _field(fields)
    jsd, trees = _guidance_trees()
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})
    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True, latent_size=LATENT,
                                 device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    smpl = jsmpl(num_vertices=120, num_joints=6, seed=0)
    sigma_pts = JLo.make_sigma_guidance_points(
        jax.random.PRNGKey(4), smpl.v_template, jnp.asarray(smpl.faces),
        num_points=64)
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = dict(txt=rng.normal(size=(B, 4, 32)).astype(f32),
             unc=np.zeros((B, 4, 32), f32), t=np.array([600, 300], np.int32),
             cond=rng.uniform(size=(B, H, W, 3)).astype(f32),
             bg=rng.uniform(size=(B, 3)).astype(f32))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    return dict(fields=fields, jcfg=jcfg, jmodel=jmodel, params=params,
                grid=grid, tmodel=tmodel, tgrid=tgrid, jsd=jsd, jgp=jgp,
                tsd=tsd, tgp=tgp, sigma_pts=sigma_pts, x=x, keys=keys,
                tsigma=SigmaGuidancePoints(*[torch.as_tensor(np.array(p))
                                             for p in sigma_pts]))


def test_nerf_dp_step_matches_jax(case):
    c = case
    x = c["x"]
    jc = jcamera(*VIEWS.values(), H, W)
    tc = tcamera(*VIEWS.values(), H, W, device="cpu")
    step = JDP.make_nerf_sds_step_dp(
        c["jmodel"], c["jsd"], _grab(), make_mesh(dp=1), H, W, c["jcfg"],
        num_steps=STEPS, max_iteration=MAX_IT, bg_mode="nerf")
    jstate = JT.NeRFTrainState(c["params"], _grab().init(c["params"]),
                               jnp.zeros((), jnp.int32))
    # evaluated op by op: XLA's compiled render + guidance gradient parts
    # from the eager one at the second view (module docstring)
    with jax.disable_jit():
        jnew, jm = step(jstate, c["grid"], c["jgp"], jc.c2w, jc.intrinsics,
                        jnp.asarray(x["bg"]), jnp.asarray(x["txt"]),
                        jnp.asarray(x["unc"]), jnp.asarray(x["t"]),
                        c["keys"], cond_image=jnp.asarray(x["cond"]),
                        sigma_pts=c["sigma_pts"], use_sigma=True)

    draws = [_view_draws(k, c["jcfg"].bound) for k in c["keys"]]
    model = c["tmodel"]
    tree = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = NeRFConfig(**c["fields"])
    ts = TT.init_train_state(model, build_nerf_optimizer(cfg, MAX_IT))
    tstep = TDP.make_nerf_sds_step_dp(model, c["tsd"], H, W, cfg,
                                      num_steps=STEPS, max_iteration=MAX_IT,
                                      bg_mode="nerf", device="cpu")
    T = torch.as_tensor
    new, metrics = tstep(
        ts, c["tgrid"], c["tgp"], tc.c2w, tc.intrinsics, T(x["bg"]),
        T(x["txt"]), T(x["unc"]), T(x["t"]),
        jitter=torch.stack([d["jitter"] for d in draws]),
        noise=torch.cat([d["noise"] for d in draws]),
        vs_draws=[d["vs"] for d in draws], cond_image=T(x["cond"]),
        sigma_pts=c["tsigma"], use_sigma=True)
    assert new.step == 1
    for k in ("loss", "sigma_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for name, p, want in _pairs(model, jnew.opt_state):
        _check_grad(name, p.grad.numpy(), want)
    model.load_state_dict(tree)


def test_nerf_dp_step_at_one_view_equals_the_single_view_step(case):
    c = case
    x = c["x"]
    tc = tcamera(*VIEWS.values(), H, W, device="cpu")
    draws = _view_draws(c["keys"][0], c["jcfg"].bound)
    cfg = NeRFConfig(**c["fields"])
    T = torch.as_tensor
    weights = TimePrioritizedLR(TS.make_schedule(device="cpu")).weights
    outs = []
    tree = {k: v.detach().clone() for k, v in c["tmodel"].state_dict().items()}
    for make, sl in ((TT.make_nerf_sds_step, 0),
                     (TDP.make_nerf_sds_step_dp, slice(0, 1))):
        model = c["tmodel"]
        model.load_state_dict(tree)
        ts = TT.init_train_state(model, build_nerf_optimizer(cfg, MAX_IT))
        step = make(model, c["tsd"], H, W, cfg, num_steps=STEPS,
                    max_iteration=MAX_IT, bg_mode="nerf",
                    tp_lr_weights=weights, device="cpu")
        jit = draws["jitter"] if sl == 0 else draws["jitter"][None]
        vs = draws["vs"] if sl == 0 else [draws["vs"]]
        new, metrics = step(
            ts, c["tgrid"], c["tgp"], tc.c2w[sl], tc.intrinsics[sl],
            T(x["bg"])[sl], T(x["txt"])[:1], T(x["unc"])[:1], T(x["t"])[:1],
            jitter=jit, noise=draws["noise"], vs_draws=vs,
            cond_image=T(x["cond"])[:1], sigma_pts=c["tsigma"],
            use_sigma=True)
        outs.append((float(metrics["loss"]),
                     [p.grad.clone() for p in model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    c["tmodel"].load_state_dict(tree)
    (l1, g1, p1), (l2, g2, p2) = outs
    # the CPU's multi-threaded scatter-adds (the field's backward) sum in
    # no fixed order: equal to float32 rounding
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for a, b, p, q in zip(g1, g2, p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
        sure = b.abs() > 1e-3 * b.abs().max()
        torch.testing.assert_close(p[sure], q[sure], rtol=1e-6, atol=1e-6)

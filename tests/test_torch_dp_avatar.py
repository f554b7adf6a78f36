"""The port's B-view avatar SDS step (``parallel/dp.py:
make_avatar_sds_step_dp``) against the JAX package's
``make_avatar_sds_step_dp`` on a one-device ``make_mesh(dp=1)``, on the
CPU, at B = 2 views.

Fixtures of ``tests/test_torch_scene.py`` (the tiny avatar on a 16^2 x 8
triplane, 32^2 renders, a table blend whose chunk equals its capacity, so
the plain blend's tile stop never acts) and the seeded tiny guidance of
``tests/torch_jax_pairs.py``; the JAX step is jitted with the guidance's
weights as arguments and takes the gradient-keeping transform ``_grab`` as
its optimizer (zero updates, the gradient as its state), so that its
gradients come out of the step itself. Each view's noise is the JAX draw
from its own key, handed to the port.

Cases: one pose for both views; a pose a view (``per_view_poses``) with
the ControlNet and a condition image a view; the trainable MLP background,
each view over the net at its own rays. Compared: the loss within 1e-4
relative, every gradient (the background's too) within 2e-3 relative +
2e-4 of its largest entry, and the densification statistics: the
visibility counts and the max radii equal (the radii are the views'
maximum), the accumulated norm of the ``dummy``'s gradient (the sum over
views) within the gradients' envelope. On the CPU the train blend's
wrappers run once forward and once backward a step, for both views.

And at B = 1 the DP step equals the single-view ``make_avatar_sds_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.human.smplx_model import SMPLXParams as JParams
from dreamwaltz_g_tpu.parallel import dp as JDP
from dreamwaltz_g_tpu.parallel.mesh import make_mesh
from dreamwaltz_g_tpu.system import background as JB
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.convert import load_flax_dense_params
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.human.smplx_model import SMPLXParams
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.parallel import dp as TDP
from dreamwaltz_g_tpu_torch.system import background as TB
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_scene import (AT, H, LATENT, RASTER, W, _T,
                                    avatar_pair, check_grads)
from tests.torch_jax_pairs import (LOSS_RTOL, grad_close, sds_noise,
                                   tiny_guidance_pair)
import tests.torch_threads  # noqa: F401  (per-worker threads)

B = 2
# the first view narrow: it crops the body, so some Gaussians on screen in
# the second view are off it in the first, and the views' maximum radius
# is not the first view's
VIEWS = dict(radius=[2.0, 2.0], theta=[60.0, 20.0], phi=[150.0, 90.0],
             fovy=[12.0, 50.0])
MAX_STEPS = 100
CASES = {
    "shared_pose": dict(per_view=False, controlnet=False, bg=False),
    "per_view_poses": dict(per_view=True, controlnet=True, bg=False),
    "mlp_background": dict(per_view=False, controlnet=False, bg=True),
}


def _grab():
    """An optax transform that updates nothing and keeps the gradient as
    its state: the JAX step's gradients come back in its opt_state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def views():
    return (jcamera(*VIEWS.values(), H, W, at_vector=AT),
            tcamera(*VIEWS.values(), H, W, at_vector=AT, device="cpu"))


def view_inputs(seed=3, with_cond=False, neg=False):
    """Each view's text, null text, timestep and background (and condition
    image, negative text), seeded numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = dict(txt=rng.normal(size=(B, 4, 32)).astype(f32),
             unc=np.zeros((B, 4, 32), f32),
             t=np.array([500, 300], np.int32),
             bg=rng.uniform(size=(B, H, W, 3)).astype(f32))
    if with_cond:
        x["cond"] = rng.uniform(size=(B, H, W, 3)).astype(f32)
    if neg:
        x["neg"] = rng.normal(size=(1, 4, 32)).astype(f32)
    return x


def view_keys(seed=4):
    """The JAX step's per-view keys and the noise each draws."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return keys, np.concatenate([sds_noise(k, LATENT) for k in keys])


def two_poses(jobs, tobs, seed=6):
    """The tiny avatar's pose and a second one (body pose moved), stacked
    as the view batch in both packages."""
    rng = np.random.default_rng(seed)
    arrs = [np.asarray(x) for x in jobs]
    names = list(jobs._fields)
    moved = [a + (0.3 * rng.normal(size=a.shape).astype(np.float32)
                  if n == "body_pose" else 0.0) for n, a in zip(names, arrs)]
    stacked = [np.concatenate([a, m]).astype(a.dtype)
               for a, m in zip(arrs, moved)]
    return (JParams(*[jnp.asarray(a) for a in stacked]),
            SMPLXParams(*[torch.as_tensor(a) for a in stacked]))


def run_jax(case, family=None):
    """The JAX DP step on the case, and the port's twin inputs."""
    c = CASES[case]
    jset, tmodel, _, tobs = avatar_pair()
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT,
                                            with_controlnet=c["controlnet"])
    if family is not None:
        import dataclasses

        jsd = dataclasses.replace(jsd, loss_type=family["loss_type"])
        tsd.loss_type = family["loss_type"]
    jc, tc = views()
    x = view_inputs(with_cond=c["controlnet"], neg=family is not None)
    keys, noise = view_keys()
    jobs = jset.observed
    if c["per_view"]:
        jobs, tobs = two_poses(jobs, tobs)
    bg_net = bgp = None
    kw = {}
    if c["bg"]:
        bg_net = JB.BackgroundMLPNet()
        bgp = bg_net.init(jax.random.PRNGKey(7), jnp.zeros((1, 3)))
        kw = dict(bg_state=(bgp, _grab().init(bgp)), c2w=jc.c2w)
    step = JDP.make_avatar_sds_step_dp(
        jset.model, jsd, _grab(), make_mesh(dp=1), H, W,
        per_view_poses=c["per_view"], bg_net=bg_net,
        bg_tx=_grab() if c["bg"] else None,
        neg_embeds=None if family is None else jnp.asarray(x["neg"]),
        tile_size=RASTER["tile_size"], capacity=RASTER["capacity"],
        chunk=RASTER["chunk"])
    tstate = JG.init_avatar_train_state(jset.state, _grab())
    out = step(tstate, jgp, jobs, jc.extrinsic, jc.intrinsics, jc.tanfov,
               jnp.asarray(x["bg"]), jnp.asarray(x["txt"]),
               jnp.asarray(x["unc"]), jnp.asarray(x["t"]), keys,
               cond_image=None if "cond" not in x else jnp.asarray(x["cond"]),
               progress=None if family is None else family["progress"],
               **kw)
    new = out[0]
    want = dict(loss=float(out[-1]["loss"]), grads=new.opt_state,
                stats=new.avatar,
                bg_grads=None if not c["bg"] else out[1][1])
    tree = jax.tree_util.tree_map(np.asarray, jset.state)
    port = dict(model=tmodel, obs=tobs, sd=tsd, gp=tgp, cam=tc, x=x,
                noise=noise, tree=tree, bgp=bgp, per_view=c["per_view"],
                progress=None if family is None else family["progress"])
    return want, port


def run_port(port, bg=False, counts=None, monkeypatch=None):
    """The port's DP step on the twin inputs; returns (new tstate, the bg
    net or None, metrics)."""
    from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy

    model, x, tc = port["model"], port["x"], port["cam"]
    tx = TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS)
    ts = TG.init_avatar_train_state(
        avatar_state_from_numpy(port["tree"], model, device="cpu"), tx, model)
    kw, bg_net = {}, None
    if bg:
        bg_net = TB.BackgroundMLPNet(device="cpu")
        load_flax_dense_params(bg_net, jax.tree_util.tree_map(
            np.asarray, port["bgp"]))
        bg_tx = TO.adan(1e-3, eps=1e-8, weight_decay=2e-5, max_grad_norm=5.0)
        kw = dict(bg_state=TG.init_background_train_state(bg_net, bg_tx),
                  c2w=tc.c2w)
    step = TDP.make_avatar_sds_step_dp(
        model, port["sd"], H, W, per_view_poses=port["per_view"],
        bg_net=bg_net, bg_tx=bg_tx if bg else None,
        neg_embeds=None if "neg" not in x else _T(x["neg"]),
        tile_size=RASTER["tile_size"], capacity=RASTER["capacity"],
        chunk=RASTER["chunk"], device="cpu")
    res = step(ts, port["gp"], port["obs"], tc.extrinsic, tc.intrinsics,
               tc.tanfov, _T(x["bg"]), _T(x["txt"]), _T(x["unc"]),
               _T(x["t"]), noise=_T(port["noise"]),
               cond_image=None if "cond" not in x else _T(x["cond"]),
               progress=port["progress"], **kw)
    return res[0], bg_net, res[-1]


def check_against_jax(want, port, bg=False):
    new, bg_net, metrics = run_port(port, bg=bg)
    model = port["model"]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    check_grads(new.avatar.params, model, want["grads"])
    st = want["stats"]
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(st.grad_denom))
    np.testing.assert_array_equal(new.avatar.max_radii.numpy(),
                                  np.asarray(st.max_radii))
    assert float(new.avatar.grad_denom.sum()) > 0
    grad_close("grad_accum", new.avatar.grad_accum.numpy(), st.grad_accum)
    if bg:
        for lname, lin in bg_net.named_children():
            g = want["bg_grads"]["params"][lname]
            grad_close(f"bg.{lname}.kernel", lin.weight.grad.numpy().T,
                       g["kernel"])
            grad_close(f"bg.{lname}.bias", lin.bias.grad.numpy(), g["bias"])
    return new


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_step_matches_jax(case, monkeypatch):
    want, port = run_jax(case)
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = BT.blend_train_fwd, BT.blend_train_bwd

    def counted_fwd(tile_lists, *a, **kw):
        calls["fwd"].append(tuple(tile_lists.shape))
        return fwd(tile_lists, *a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(BT, "blend_train_fwd", counted_fwd)
    monkeypatch.setattr(BT, "blend_train_bwd", counted_bwd)
    check_against_jax(want, port, bg=CASES[case]["bg"])
    T = (H // RASTER["tile_size"]) * (W // RASTER["tile_size"])
    assert calls == {"fwd": [(B, T, RASTER["capacity"])], "bwd": 1}


def test_dp_step_at_one_view_equals_the_single_view_step():
    """B = 1: the DP step (tile cap as the single step's) gives the single
    step's loss, gradients, statistics and update."""
    _, model, _, tobs = avatar_pair()
    from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy

    jset, _, _, _ = avatar_pair()
    tree = jax.tree_util.tree_map(np.asarray, jset.state)
    _, _, tsd, tgp = tiny_guidance_pair(LATENT)
    _, tc = views()
    x = view_inputs()
    _, noise = view_keys()
    raster = dict(RASTER, max_tiles_per_gaussian=16)
    outs = []
    for make, sl in ((TG.make_avatar_sds_step, 0), (TDP.make_avatar_sds_step_dp,
                                                    slice(0, 1))):
        tx = TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS)
        ts = TG.init_avatar_train_state(
            avatar_state_from_numpy(tree, model, device="cpu"), tx, model)
        step = make(model, tsd, H, W, device="cpu", **raster)
        bg = _T(x["bg"])[sl]
        new, metrics = step(ts, tgp, tobs, tc.extrinsic[sl],
                            tc.intrinsics[sl], tc.tanfov[sl], bg,
                            _T(x["txt"])[:1], _T(x["unc"])[:1],
                            _T(x["t"])[:1], noise=_T(noise)[:1])
        grads = [leaf.grad.clone() for leaf in TG._leaves(new.avatar, model)
                 if leaf.grad is not None]
        params = [leaf.detach().clone()
                  for leaf in TG._leaves(new.avatar, model)]
        outs.append((float(metrics["loss"]), grads, params,
                     new.avatar.grad_accum.clone(),
                     new.avatar.max_radii.clone()))
    (l1, g1, p1, a1, r1), (l2, g2, p2, a2, r2) = outs
    assert l1 == pytest.approx(l2, rel=1e-6)
    assert len(g1) == len(g2) > 0
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a1, a2, rtol=1e-5, atol=1e-7)
    assert torch.equal(r1, r2)


def test_dp_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    _, model, _, _ = avatar_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDP.make_avatar_sds_step_dp(model, None, H, W)

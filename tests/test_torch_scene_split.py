"""The split SDS step (``make_avatar_sds_step_split``) of the port against
the JAX package, on the CPU, in both branches: the plain one (render ->
encode, the latent gradient, a re-render with that gradient injected) and
the MLP background's (its weights take their gradient with the avatar's
and their own Adan updates them). Both with the scene placement and the
Gaussian background, as the trainer builds the step, and the JAX step's
tile cap of 8.

JAX side: the step's three programs as ``make_avatar_sds_step_split``
builds them (the encode of the first render, ``latent_gradients``, then
``jax.value_and_grad`` of ``sum(latents * glat)``), then the optax updates:
the avatar's Adam and the background's ``adan(1e-3, eps=1e-8,
weight_decay=2e-5, max_grad_norm=5)``. One compiled JAX program serves
both branches: the background is ``w * mlp + (1 - w) * color`` with w 1 or
0, which is the MLP's image or the color to the bit.

Fixtures and tolerances of ``test_torch_scene.py``; the updated weights
where the gradient is well above rounding within 1e-6. On the CPU the
train blend's wrapper runs twice forward and once backward a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.data.camera import get_rays as jget_rays
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.system import background as JB
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.convert import (avatar_state_from_numpy,
                                            load_flax_dense_params)
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.system import background as TB
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_scene import (H, LATENT, PLACEMENT, RASTER, W, _T,
                                    avatar_pair, cameras, check_grads,
                                    fields, step_inputs,
                                    write_background_ply)
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
    update_close,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

RASTER8 = dict(RASTER, max_tiles_per_gaussian=8)
MAX_STEPS = 100


@pytest.fixture(scope="module")
def jax_split(tmp_path_factory):
    """The JAX split step's results for w = 0 (the plain branch) and 1
    (the MLP background), and the port's twin inputs."""
    ply = write_background_ply(tmp_path_factory.mktemp("bg") / "bg.ply")
    jbg = JB.load_gaussian_background(ply)
    jset, tmodel, _, tobs = avatar_pair()
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc, tc = cameras()
    x = step_inputs()
    key = jax.random.PRNGKey(4)
    state = jset.state
    C, M = state.capacity, jset.model.n_mesh_points
    placement = tuple(jnp.asarray(a) for a in PLACEMENT)
    jnet = JB.BackgroundMLPNet()
    bgp = jnet.init(jax.random.PRNGKey(7), jnp.zeros((1, 3)))
    _, rd = jget_rays(jc.c2w[:1], jc.intrinsics[:1], H, W)
    color = jnp.asarray(x["bg"])

    def image(params, dummy, bgp, w):
        bgimg = w * jnet.apply(bgp, rd[0]).reshape(H, W, 3) \
            + (1.0 - w) * color
        return JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0], bgimg, H, W,
            RASTER8, placement=placement, static_gaussians=jbg)

    @jax.jit
    def render_encode(params, bgp, w):
        img, _ = image(params, jnp.zeros((C + M, 2)), bgp, w)
        return jsd.encode_images(jgp, img[None])

    @jax.jit
    def latent_grad(latents):
        return jsd.latent_gradients(jgp, latents, x["txt"], x["unc"],
                                    x["t"], key,
                                    guidance_scale=jnp.asarray(
                                        jsd.guidance_scale, jnp.float32))

    def loss_fn(params, dummy, bgp, w, glat):
        img, out = image(params, dummy, bgp, w)
        latents = jsd.encode_images(jgp, img[None])
        loss = jnp.sum(latents.astype(jnp.float32) * glat) / latents.shape[0]
        return loss, (out.radii, out.overflow)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                         has_aux=True))
    tx = JO.build_avatar_optimizer(JRenderConfig(), MAX_STEPS)
    bg_tx = JO.adan(1e-3, eps=1e-8, weight_decay=2e-5, max_grad_norm=5.0)
    out = {}
    for w in (0.0, 1.0):
        glat = latent_grad(render_encode(state.params, bgp, w))
        (loss, (radii, ovf)), (grads, dgrad, bg_grads) = grad_fn(
            state.params, jnp.zeros((C + M, 2)), bgp, w, glat)
        upd, _ = tx.update(grads, tx.init(state.params), state.params)
        bup, _ = bg_tx.update(bg_grads, bg_tx.init(bgp), bgp)
        out[w] = dict(
            loss=float(loss), overflow=float(ovf), grads=grads,
            new=optax.apply_updates(state.params, upd),
            stats=JA.update_avatar_stats(state, dgrad[:C], radii[:C]),
            bg_grads=bg_grads, bg_new=optax.apply_updates(bgp, bup))
    assert float(np.abs(np.asarray(jax.tree_util.tree_leaves(
        out[1.0]["bg_grads"])[0])).max()) > 0
    tree = jax.tree_util.tree_map(np.asarray, state)
    port = dict(model=tmodel, obs=tobs, sd=tsd, gp=tgp,
                fresh=lambda: avatar_state_from_numpy(tree, tmodel,
                                                      device="cpu"),
                cam=tc, x=x, key=key, bgp=bgp,
                bg=TB.load_gaussian_background(ply, device="cpu"))
    return out, port


@pytest.mark.parametrize("branch", ["plain", "mlp_background"])
def test_split_step_matches_jax(jax_split, branch, monkeypatch):
    """The loss, the tile overflow, every avatar gradient and (where the
    gradient is well above rounding) update, the densification statistics,
    and with the MLP background its gradients and Adan update; two blend
    forwards and one backward."""
    out, port = jax_split
    want = out[1.0 if branch == "mlp_background" else 0.0]
    calls = {"fwd": 0, "bwd": 0}
    for name, k in (("blend_train_fwd", "fwd"), ("blend_train_bwd", "bwd")):
        fn = getattr(BT, name)

        def counted(*a, fn=fn, k=k, **kw):
            calls[k] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(BT, name, counted)
    model, x, tc = port["model"], port["x"], port["cam"]
    tx = TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS)
    # the step updates the state and the model's networks in place: each
    # case starts from the JAX state again
    ts = TG.init_avatar_train_state(port["fresh"](), tx, model)
    before = {name: leaf.detach().clone()
              for name, leaf, _ in fields(ts.avatar.params, model)}
    kw = {}
    bg_net = None
    if branch == "mlp_background":
        bg_net = TB.BackgroundMLPNet(device="cpu")
        load_flax_dense_params(bg_net, jax.tree_util.tree_map(
            np.asarray, port["bgp"]))
        bg_tx = TO.adan(1e-3, eps=1e-8, weight_decay=2e-5, max_grad_norm=5.0)
        kw = dict(bg_state=TG.init_background_train_state(bg_net, bg_tx),
                  c2w=tc.c2w[0])
    step = TG.make_avatar_sds_step_split(
        model, port["sd"], H, W, device="cpu", placement=PLACEMENT,
        static_gaussians=port["bg"], bg_net=bg_net,
        bg_tx=bg_tx if bg_net is not None else None, **RASTER8)
    res = step(ts, port["gp"], port["obs"], tc.extrinsic[0],
               tc.intrinsics[0], tc.tanfov[0], _T(x["bg"]), _T(x["txt"]),
               _T(x["unc"]), _T(x["t"]),
               noise=_T(sds_noise(port["key"], LATENT)), **kw)
    assert calls == {"fwd": 2, "bwd": 1}
    new, metrics = res[0], res[-1]
    if bg_net is not None:
        assert len(res) == 3 and res[1] is kw["bg_state"]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    assert float(metrics["tile_overflow"]) == want["overflow"]
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(want["stats"].grad_denom))
    grad_close("grad_accum", new.avatar.grad_accum.numpy(),
               want["stats"].grad_accum)
    check_grads(new.avatar.params, model, want["grads"])
    for name, leaf, get in fields(new.avatar.params, model):
        if name in ("positions", "encoder"):
            update_close(name, leaf.detach().numpy(), get(want["new"]),
                         get(want["grads"]))
            assert not torch.equal(leaf.detach(), before[name]), name
    if bg_net is None:
        return
    for lname, lin in bg_net.named_children():
        g = want["bg_grads"]["params"][lname]
        n = want["bg_new"]["params"][lname]
        grad_close(f"bg.{lname}.kernel", lin.weight.grad.numpy().T,
                   g["kernel"])
        grad_close(f"bg.{lname}.bias", lin.bias.grad.numpy(), g["bias"])
        update_close(f"bg.{lname}.kernel", lin.weight.detach().numpy().T,
                     n["kernel"], g["kernel"])
        update_close(f"bg.{lname}.bias", lin.bias.detach().numpy(),
                     n["bias"], g["bias"])

"""The DMTet finetune step of the port (``training/dmtet_trainer.py``)
against the JAX package, on the CPU.

The tiny triplane field (16^2 x 8, bound 1, the Gaussian density prior,
its weights the JAX ones), the JAX ``init_dmtet`` at resolution 12 handed
to the port (``convert.dmtet_from_numpy``), the tiny float32 guidance
(seeded weights, ``tests/torch_jax_pairs.py``), 16^2 renders, the
'lambertian' shading so that the light's draw counts. JAX side:
``jax.value_and_grad`` of the JAX step's loss, written as
``make_dmtet_sds_step``'s ``loss_fn`` is, with its draws (the light's
normal from the key's first half, the SDS noise from the second) handed
to the port; then the two optax updates.

Tolerances: the loss within 1e-4 relative and the regularisers within
1e-5; every gradient (the field's planes and heads, sdf, deform) within
2e-3 relative + 2e-4 of its largest entry; the updated parameters within
1e-6 where the gradient exceeds 1e-3 of its largest (Adam's first step at
eps 1e-15 is +-lr sign(g)); the eval render's image, depth and alpha
within 1e-5 of their largest entry. The render's chunk equals its tile
capacity, so the plain blend's tile stop never acts (the JAX jnp blend
has none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.nerf import dmtet as JD
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.training import dmtet_trainer as JDT
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.training import dmtet_trainer as TDT
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
    update_close,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

FIELD = dict(triplane_resolution=16, triplane_dim=8, bound=1.0,
             density_prior="gaussian")
RES = 12
THRESH = 2.0
LATENT = 8
H = W = 2 * LATENT
RASTER = dict(tile_size=8, capacity=256, chunk=256)
MAX_STEPS = 100
SHADING, AMBIENT = "lambertian", 0.3
CAM = dict(radius=2.5, theta=70.0, phi=30.0, fovy=60.0)
VAL_TOL = 1e-5


def _close(got, want, tol=VAL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * peak


@pytest.fixture(scope="module")
def case():
    jnerf = JN.build_nerf(JNeRFConfig(**FIELD), with_background=False)
    params = jnerf.init(jax.random.PRNGKey(0))
    jdm, jdp, jedges = JDT.init_dmtet(jnerf, params, RES,
                                      density_thresh=THRESH)
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc = jcamera(*CAM.values(), H, W)
    campos = jc.c2w[0][:3, 3]
    rng = np.random.default_rng(0)
    x = dict(txt=rng.normal(size=(1, 4, 32)).astype(np.float32),
             unc=np.zeros((1, 4, 32), np.float32),
             t=np.array([500], np.int32),
             bg=np.asarray([0.2, 0.4, 0.6], np.float32))
    key = jax.random.PRNGKey(3)
    k_light, k_sds = jax.random.split(key)
    x["light_noise"] = np.asarray(jax.random.normal(k_light, (3,)))
    x["noise"] = sds_noise(k_sds, LATENT)
    light = campos + x["light_noise"]
    light = light / jnp.maximum(jnp.linalg.norm(light), 1e-8)
    ncfg = JNeRFConfig(**FIELD)

    def loss_fn(trainables):
        p, dp = trainables
        soup = jdm.extract(dp)
        albedo = JDT._query_albedo(jnerf, p, jnp.mean(soup.vertices, 1))
        colors = JD.shade_soup(soup, albedo[..., :3], SHADING, light,
                               ambient_ratio=AMBIENT)
        out = JD.render_dmtet_splats(soup, colors, jc.extrinsic[0],
                                     jc.intrinsics[0], H, W,
                                     max_tiles_per_gaussian=8, **RASTER)
        img = out.image + (1.0 - out.alpha)[..., None] * x["bg"]
        sds = jsd(jgp, img[None], x["txt"], x["unc"], x["t"], k_sds)
        nc = JD.soup_normal_consistency(soup)
        lap = JD.tet_laplacian_loss(
            jdm.verts + jnp.tanh(dp.deform) * jdm.deform_scale, jedges)
        loss = sds["loss"] + ncfg.lambda_mesh_normal * nc \
            + ncfg.lambda_mesh_laplacian * lap
        return loss, dict(sds=sds["loss"], nc=nc, lap=lap,
                          alpha=jnp.mean(out.alpha))

    (loss, aux), (gn, gd) = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))((params, jdp))
    assert float(aux["alpha"]) > 0.05
    tx_n = JO.build_nerf_optimizer(ncfg, MAX_STEPS)
    tx_d = JDT.build_dmtet_optimizer(ncfg, MAX_STEPS)
    un, _ = tx_n.update(gn, tx_n.init(params), params)
    ud, _ = tx_d.update(gd, tx_d.init(jdp), jdp)
    jax_out = dict(loss=float(loss), aux={k: float(v) for k, v in
                                          aux.items()},
                   gn=gn, gd=gd, new_params=optax.apply_updates(params, un),
                   new_dp=optax.apply_updates(jdp, ud), params=params,
                   jnerf=jnerf, jdm=jdm, jdp=jdp, jc=jc)
    tc = tcamera(*CAM.values(), H, W, device="cpu")
    T = torch.as_tensor

    def fresh(**cfg):
        tnerf = TN.build_nerf(NeRFConfig(**FIELD), with_background=False,
                              device="cpu")
        convert.nerf_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tnerf)
        dm, dp = convert.dmtet_from_numpy(
            jdm, jax.tree_util.tree_map(np.asarray, jdp), device="cpu")
        tcfg = NeRFConfig(**FIELD, **cfg)
        tstate = TDT.init_train_state(
            tnerf, dp, TO.build_nerf_optimizer(tcfg, MAX_STEPS),
            TDT.build_dmtet_optimizer(tcfg, MAX_STEPS))
        step = TDT.make_dmtet_sds_step(
            tnerf, dm, T(np.asarray(jedges)), tsd, H, W, tcfg,
            ambient_ratio=AMBIENT, device="cpu", **RASTER)
        return tnerf, dm, tstate, step

    port = dict(fresh=fresh, gp=tgp, cam=(tc.extrinsic[0], tc.intrinsics[0],
                                          tc.c2w[0][:3, 3]),
                c2w=tc.c2w[0], intr=tc.intrinsics[0],
                x={k: T(v) for k, v in x.items()})
    return jax_out, port


def _field_leaves(tnerf, jtree):
    """(name, torch parameter, JAX array in the torch layout)."""
    out = [("planes", tnerf.planes, jtree.encoder.planes)]
    for jname in ("sigma_mlp", "albedo_mlp"):
        sub = getattr(jtree, jname)
        if sub is None:
            continue
        for lname, p in sub["params"].items():
            lin = getattr(getattr(tnerf, jname), lname)
            out.append((f"{jname}.{lname}.kernel", lin.weight,
                        np.asarray(p["kernel"]).T))
            out.append((f"{jname}.{lname}.bias", lin.bias, p["bias"]))
    return out


def _run(port, **cfg):
    tnerf, dm, tstate, step = port["fresh"](**cfg)
    x = port["x"]
    launches = (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches)
    new, metrics = step(tstate, port["gp"], *port["cam"], x["bg"], x["txt"],
                        x["unc"], x["t"], light_noise=x["light_noise"],
                        noise=x["noise"], shading=SHADING)
    assert (BT.blend_train_fwd.launches,
            BT.blend_train_bwd.launches) == launches   # CPU: plain versions
    return tnerf, tstate, new, metrics


def test_dmtet_step_matches_jax(case):
    """The loss and its terms, the gradients to the field, sdf and deform,
    then one update of each."""
    jax_out, port = case
    tnerf, tstate, new, metrics = _run(port)
    assert new.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_out["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["sds_loss"]),
                               jax_out["aux"]["sds"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["mesh_laplacian_loss"]),
                               jax_out["aux"]["lap"], rtol=VAL_TOL)
    assert abs(float(metrics["mesh_normal_loss"])
               - jax_out["aux"]["nc"]) < 1e-6
    assert 0.0 <= float(metrics["tile_overflow"]) < 1.0
    sdf, deform = new.dmtet
    grad_close("sdf", sdf.grad.numpy(), jax_out["gd"].sdf)
    grad_close("deform", deform.grad.numpy(), jax_out["gd"].deform)
    update_close("sdf", sdf.detach().numpy(), jax_out["new_dp"].sdf,
                 jax_out["gd"].sdf)
    update_close("deform", deform.detach().numpy(),
                 jax_out["new_dp"].deform, jax_out["gd"].deform)
    grads = _field_leaves(tnerf, jax_out["gn"])
    news = _field_leaves(tnerf, jax_out["new_params"])
    for (name, leaf, g), (_, _, want) in zip(grads, news):
        grad_close(name, leaf.grad.numpy(), g)
        update_close(name, leaf.detach().numpy(), want, g)


def test_lock_geo_freezes_the_geometry(case):
    """``lock_geo``: sdf and deform take no gradient and no update and their
    moments stay zero; the field's gradients are the unlocked step's."""
    jax_out, port = case
    tnerf, tstate, new, metrics = _run(port, lock_geo=True)
    dm0 = port["fresh"]()[2].dmtet
    assert torch.equal(new.dmtet.sdf, dm0.sdf)
    assert torch.equal(new.dmtet.deform, dm0.deform)
    assert new.dmtet.sdf.grad is None and new.dmtet.deform.grad is None
    (_, _, geo), = new.opt_state[1].groups.values()
    assert geo["count"] == 0
    assert all(not m.any() for m in geo["mu"] + geo["nu"])
    np.testing.assert_allclose(float(metrics["loss"]), jax_out["loss"],
                               rtol=LOSS_RTOL)
    for name, leaf, g in _field_leaves(tnerf, jax_out["gn"]):
        grad_close(name, leaf.grad.numpy(), g)
    moved = [name for name, leaf, w in _field_leaves(tnerf,
                                                      jax_out["params"])
             if not np.array_equal(leaf.detach().numpy(), np.asarray(w))]
    assert moved


def test_eval_render_matches_jax(case):
    jax_out, port = case
    jrender = JDT.make_dmtet_eval_render(
        jax_out["jnerf"], jax_out["jdm"], H, W, **RASTER)
    jstate = JDT.DMTetTrainState(jax_out["params"], jax_out["jdp"], None, 0)
    bg = jnp.asarray([0.5, 0.5, 0.5])
    want = jrender(jstate, jax_out["jc"].c2w[0], jax_out["jc"].intrinsics[0],
                   bg)
    tnerf, dm, tstate, _ = port["fresh"]()
    render = TDT.make_dmtet_eval_render(tnerf, dm, H, W, device="cpu",
                                        **RASTER)
    got = render(tstate, port["c2w"], port["intr"], torch.as_tensor(
        np.asarray(bg)))
    assert float(np.asarray(want[2]).max()) > 0.5
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", ["make_dmtet_sds_step",
                                  "make_dmtet_eval_render"])
def test_dmtet_entry_points_default_to_cuda(case, name):
    """Without ``device=`` they ask for CUDA and, without it, raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    _, port = case
    tnerf, dm, _, _ = port["fresh"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "make_dmtet_sds_step":
            TDT.make_dmtet_sds_step(tnerf, dm, None, None, 8, 8,
                                    NeRFConfig())
        else:
            TDT.make_dmtet_eval_render(tnerf, dm, 8, 8)

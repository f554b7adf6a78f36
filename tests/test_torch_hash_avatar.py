"""The hash avatar (``--render.gs_type hash``) of the port against the JAX
package, on the CPU: ``system/avatar.py``'s ``hash_mode`` branches (no
mesh parts; scales and rotations from a ``SigmaMLP`` over the field
encoding, ``flip_rotation_axis`` off, the vertex pose offsets always on
and the shape offsets with ``deform_with_shape``) through ``animate`` and
the stage-2 SDS step.

The tiny avatar's body and cloud (64 points, 128 slots), a 16^2 x 8
triplane field, the JAX state carried over by
``convert.avatar_state_from_numpy``; the tiny float32 guidance with
seeded weights (``tests/torch_jax_pairs.py``), a 32^2 render whose chunk
equals its tile capacity (no tile stop in the plain blend; the JAX jnp
blend has none).

Tolerances: ``animate`` within 1e-5 absolute (SMPL-X, GLBS, the field and
two MLPs in float32); the step's loss within 1e-4 relative and every
gradient within 2e-3 relative + 2e-4 of its largest entry; the
densification counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.human import smplx_model as JSM
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.nerf.network import SigmaMLP as JSigmaMLP
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.human import smplx_model as TSM
from dreamwaltz_g_tpu_torch.nerf.encoder import TriplaneConfig
from dreamwaltz_g_tpu_torch.nerf.network import SigmaMLP
from dreamwaltz_g_tpu_torch.system import avatar as TA
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)

BODY = dict(num_vertices=120, num_joints=6, num_betas=3, num_expr=2, seed=0)
LATENT = 16
H = W = 2 * LATENT
RASTER = dict(tile_size=16, capacity=128, chunk=128,
              max_tiles_per_gaussian=16)
CAM = dict(radius=2.0, theta=20.0, phi=90.0, fovy=50.0)


def _models(deform_with_shape):
    jsmpl = JSM.make_synthetic_model(**BODY)
    tsmpl = TSM.make_synthetic_model(**BODY, device="cpu")
    enc = dict(resolution=16, feature_dim=8)
    jm = JA.AvatarModel(
        smpl=jsmpl, canonical_inputs=JSM.default_params(jsmpl),
        enc_cfg=JTriplane(**enc), nerf_bound=2.0,
        color_mlp=JSigmaMLP(hidden=32, num_layers=2, out_channels=4),
        sq_net=JSigmaMLP(hidden=32, num_layers=2, out_channels=7),
        hash_mode=True, deform_with_shape=deform_with_shape,
        init_scale=0.02, max_scale=0.05)
    tcfg = TriplaneConfig(**enc)
    tm = TA.AvatarModel(
        smpl=tsmpl, canonical_inputs=TSM.default_params(tsmpl),
        enc_cfg=tcfg, nerf_bound=2.0,
        color_mlp=SigmaMLP(tcfg.output_dim, hidden=32, num_layers=2,
                           out_channels=4, device="cpu"),
        sq_net=SigmaMLP(tcfg.output_dim, hidden=32, num_layers=2,
                        out_channels=7, device="cpu"),
        hash_mode=True, deform_with_shape=deform_with_shape,
        init_scale=0.02, max_scale=0.05)
    rng = np.random.default_rng(0)
    cloud = (rng.normal(size=(64, 3)) * 0.15
             + np.asarray([0, 0.7, 0])).astype(np.float32)
    jstate = JA.init_avatar_state(jm, jnp.asarray(cloud),
                                  jax.random.PRNGKey(0), capacity=128,
                                  prune_dists_close_to_mesh=None)
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tm, device="cpu")
    return jm, jstate, tm, tstate


def _pose(seed):
    rng = np.random.default_rng(seed)
    jsmpl = JSM.make_synthetic_model(**BODY)
    fields = {k: np.zeros(np.shape(v), np.float32)
              for k, v in JSM.default_params(jsmpl)._asdict().items()}
    fields["body_pose"] = (rng.normal(size=(1, 63)) * 0.3).astype(np.float32)
    fields["global_orient"] = (rng.normal(size=(1, 3)) * 0.2).astype(
        np.float32)
    fields["betas"] = (rng.normal(size=fields["betas"].shape)).astype(
        np.float32)
    return (JSM.SMPLXParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TSM.SMPLXParams(**{k: torch.as_tensor(v)
                               for k, v in fields.items()}))


@pytest.mark.parametrize("deform_with_shape", [False, True])
def test_hash_animate_matches_jax(deform_with_shape):
    jm, jstate, tm, tstate = _models(deform_with_shape)
    assert not tm.mesh_parts and TA.effective_offset_flags(tm) == \
        JA.effective_offset_flags(jm)
    jp, tp = _pose(1)
    jg = JA.animate(jm, jstate, jp)
    tg = TA.animate(tm, tstate, tp)
    for name in jg._fields:
        j, t = np.asarray(getattr(jg, name)), getattr(tg, name).detach()
        if j.dtype == bool:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(t.numpy(), j, atol=1e-5,
                                       err_msg=name)
    # the scales and rotations come from the MLP, not the per-point params
    assert float(np.asarray(jg.scales).std()) > 0


def _leaves(params, model):
    """(name, torch tensor, JAX-layout accessor) of every learnable."""
    out = [(n, getattr(params, n), lambda p, n=n: getattr(p, n))
           for n in ("positions", "log_scales", "quats", "lbs_weights",
                     "extra_betas")]
    out.append(("encoder.planes", params.encoder.planes,
                lambda p: p.encoder.planes))
    for net_name in ("color_mlp", "sq_net"):
        for lname, lin in getattr(model, net_name).named_children():
            out.append((f"{net_name}.{lname}.kernel", lin.weight,
                        lambda p, a=net_name, b=lname:
                        np.asarray(getattr(p, a)["params"][b]["kernel"]).T))
            out.append((f"{net_name}.{lname}.bias", lin.bias,
                        lambda p, a=net_name, b=lname:
                        getattr(p, a)["params"][b]["bias"]))
    return out


@pytest.mark.parametrize("deform_with_shape", [False, True])
def test_hash_sds_step_gradients_match_jax(deform_with_shape):
    """``make_avatar_sds_step`` on the hash avatar against
    ``jax.value_and_grad`` of the JAX step's loss: the loss, every
    learnable's gradient (the per-point scales, rotations and extra betas
    take none) and the densification statistics (the screen-space
    gradient's norms and the visibility counts)."""
    jm, jstate, tm, tstate = _models(deform_with_shape)
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc = jcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),))
    tc = tcamera(*CAM.values(), H, W, at_vector=((0, 0.7, 0),), device="cpu")
    jp, tp = _pose(2)
    rng = np.random.default_rng(3)
    x = dict(txt=rng.normal(size=(1, 4, 32)).astype(np.float32),
             unc=np.zeros((1, 4, 32), np.float32),
             t=np.array([500], np.int32),
             bg=rng.uniform(size=(H, W, 3)).astype(np.float32))
    key = jax.random.PRNGKey(4)
    C = jstate.capacity

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jm, jstate, params, jp, dummy, jc.extrinsic[0], jc.intrinsics[0],
            jc.tanfov[0], jnp.asarray(x["bg"]), H, W, RASTER)
        sds = jsd(jgp, image[None], x["txt"], x["unc"], x["t"], key)
        return sds["loss"], (out.radii, jnp.mean(out.alpha))

    (loss, (radii, alpha)), (grads, dgrad) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        jstate.params, jnp.zeros((C, 2)))
    assert float(alpha) > 0.05
    jnew = JA.update_avatar_stats(jstate, dgrad[:C], radii[:C])

    T = torch.as_tensor
    tx = TO.build_avatar_optimizer(RenderConfig(), 100)
    ts = TG.init_avatar_train_state(tstate, tx, tm)
    step = TG.make_avatar_sds_step(tm, tsd, H, W, device="cpu", **RASTER)
    new, metrics = step(ts, tgp, tp, tc.extrinsic[0], tc.intrinsics[0],
                        tc.tanfov[0], T(x["bg"]), T(x["txt"]), T(x["unc"]),
                        T(x["t"]), noise=T(sds_noise(key, LATENT)))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    assert float(new.avatar.grad_denom.sum()) > 0
    grad_close("grad_accum", new.avatar.grad_accum.numpy(), jnew.grad_accum)
    for name, leaf, get in _leaves(new.avatar.params, tm):
        want = np.asarray(get(grads))
        if name in ("log_scales", "quats", "extra_betas"):
            assert leaf.grad is None and not want.any(), name
            continue
        grad_close(name, leaf.grad.numpy(), want)

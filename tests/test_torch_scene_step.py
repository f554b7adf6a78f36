"""The stage-2 SDS step with the scene placement and the Gaussian
background (``make_avatar_sds_step(placement=, static_gaussians=)``) of the
port against ``jax.value_and_grad`` of the JAX step's loss, on the CPU,
with the fixtures and tolerances of ``test_torch_scene.py``."""
import jax
import jax.numpy as jnp
import numpy as np

from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.system import background as JB
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.system import background as TB
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_scene import (H, LATENT, PLACEMENT, RASTER, W, _T,
                                    avatar_pair, cameras, check_grads,
                                    step_inputs, write_background_ply)
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)


def test_placed_step_with_gaussian_background_matches_jax(tmp_path):
    """``make_avatar_sds_step`` with ``placement`` and ``static_gaussians``
    against ``jax.value_and_grad`` of the JAX step's loss: the loss, every
    gradient, the screen-space statistics over the avatar's slots (the
    background's are padded after them and sliced off) and the tile
    overflow."""
    ply = write_background_ply(tmp_path / "bg.ply")
    jbg = JB.load_gaussian_background(ply)
    tbg = TB.load_gaussian_background(ply, device="cpu")
    jset, tmodel, tstate, tobs = avatar_pair()
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc, tc = cameras()
    x = step_inputs()
    key = jax.random.PRNGKey(4)
    state = jset.state
    C, M = state.capacity, jset.model.n_mesh_points
    placement = tuple(jnp.asarray(a) for a in PLACEMENT)

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
            jnp.asarray(x["bg"]), H, W, RASTER, placement=placement,
            static_gaussians=jbg)
        sds = jsd(jgp, image[None], x["txt"], x["unc"], x["t"], key)
        return sds["loss"], (out.radii, out.alpha, out.overflow)

    (loss, (radii, alpha, ovf)), (grads, dgrad) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, jnp.zeros((C + M, 2)))
    assert float(alpha.mean()) > 0.3         # the background shows
    jnew = JA.update_avatar_stats(state, dgrad[:C], radii[:C])

    tx = TO.build_avatar_optimizer(RenderConfig(), 100)
    ts = TG.init_avatar_train_state(tstate, tx, tmodel)
    step = TG.make_avatar_sds_step(tmodel, tsd, H, W, device="cpu",
                                   placement=PLACEMENT, static_gaussians=tbg,
                                   **RASTER)
    new, metrics = step(ts, tgp, tobs, tc.extrinsic[0], tc.intrinsics[0],
                        tc.tanfov[0], _T(x["bg"]), _T(x["txt"]),
                        _T(x["unc"]), _T(x["t"]),
                        noise=_T(sds_noise(key, LATENT)))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    assert float(metrics["tile_overflow"]) == float(ovf)
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    assert float(new.avatar.grad_denom.sum()) > 0
    grad_close("grad_accum", new.avatar.grad_accum.numpy(), jnew.grad_accum)
    check_grads(new.avatar.params, tmodel, grads)

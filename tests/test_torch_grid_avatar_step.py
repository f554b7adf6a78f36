"""The stage-2 avatar SDS step on a tiled-grid field of the port against
``jax.value_and_grad`` of the JAX step's loss, on the CPU: the JAX tiny
avatar on its own default grid (4 levels, 2^8 tables) carried over by
``convert.avatar_state_from_numpy``, with the fixtures and envelope of
``test_torch_scene.py`` (the loss within 1e-4 relative, every gradient,
the tables' included, within 2e-3 relative + 2e-4 of its largest entry,
the densification counts equal)."""
import jax
import jax.numpy as jnp
import numpy as np

from dreamwaltz_g_tpu.nerf.encoder import GridEncoderConfig as JGrid
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_scene import (H, LATENT, RASTER, W, _T, avatar_pair,
                                    cameras, check_grads, step_inputs)
from tests.torch_jax_pairs import (
    LOSS_RTOL,
    grad_close,
    sds_noise,
    tiny_guidance_pair,
)
import tests.torch_threads  # noqa: F401  (per-worker threads)


def test_grid_avatar_step_matches_jax():
    jenc = JGrid(**tts.TINY_GRID._asdict())
    jset, tmodel, tstate, tobs = avatar_pair(jenc, tts.TINY_GRID)
    assert tuple(tstate.params.encoder.tables.shape) == (4, 256, 2)
    # seeded tables, so that the field's gradient is well above rounding
    tables = np.random.default_rng(8).normal(size=(4, 256, 2)).astype(
        np.float32)
    state = jset.state._replace(params=jset.state.params._replace(
        encoder=jset.state.params.encoder._replace(
            tables=jnp.asarray(tables))))
    tstate.params.encoder.tables.copy_(_T(tables))
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc, tc = cameras()
    x = step_inputs()
    key = jax.random.PRNGKey(4)
    C, M = state.capacity, jset.model.n_mesh_points

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
            jnp.asarray(x["bg"]), H, W, RASTER)
        sds = jsd(jgp, image[None], x["txt"], x["unc"], x["t"], key)
        return sds["loss"], (out.radii, out.alpha)

    (loss, (radii, alpha)), (grads, dgrad) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, jnp.zeros((C + M, 2)))
    assert float(alpha.max()) > 0.5
    jnew = JA.update_avatar_stats(state, dgrad[:C], radii[:C])

    tx = TO.build_avatar_optimizer(RenderConfig(), 100)
    ts = TG.init_avatar_train_state(tstate, tx, tmodel)
    step = TG.make_avatar_sds_step(tmodel, tsd, H, W, device="cpu", **RASTER)
    new, metrics = step(ts, tgp, tobs, tc.extrinsic[0], tc.intrinsics[0],
                        tc.tanfov[0], _T(x["bg"]), _T(x["txt"]),
                        _T(x["unc"]), _T(x["t"]),
                        noise=_T(sds_noise(key, LATENT)))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    grad_close("grad_accum", new.avatar.grad_accum.numpy(), jnew.grad_accum)
    assert float(np.abs(np.asarray(grads.encoder.tables)).max()) > 0
    check_grads(new.avatar.params, tmodel, grads)

"""The port's B-view vanilla SDS step (``parallel/dp.py:
make_vanilla_sds_step_dp``) against the JAX ``make_vanilla_sds_step_dp``
on a one-device ``make_mesh(dp=1)``, on the CPU, at B = 2 views, with one
pose for both views and with a pose a view (``per_view_poses``).

Fixtures of ``tests/test_torch_vanilla.py`` (the synthetic body's 64-point
vanilla avatar in a 96-slot buffer, 32^2 renders, the tiny seeded
guidance); cameras, per-view inputs and noise and the gradient-keeping
JAX transform of ``tests/test_torch_dp_avatar.py``. Compared: the loss,
every ``GaussianParams`` gradient (the rotations' is float32 noise on
both sides: every Gaussian starts isotropic), the visibility counts and
max radii (the views' maximum) equal, the accumulated screen-space
gradient norm within the envelope.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.human import smplx_model as JSM
from dreamwaltz_g_tpu.parallel import dp as JDP
from dreamwaltz_g_tpu.parallel.mesh import make_mesh
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.human import smplx_model as TSM
from dreamwaltz_g_tpu_torch.parallel import dp as TDP
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests.test_torch_dp_avatar import _grab, view_inputs, view_keys, views
from tests.test_torch_vanilla import (  # noqa: F401  (fixture)
    H,
    LATENT,
    RASTER,
    W,
    _port_state,
    _pose,
    avatar,
)
from tests.torch_jax_pairs import LOSS_RTOL, grad_close, tiny_guidance_pair
import tests.torch_threads  # noqa: F401  (per-worker threads)

MAX_STEPS = 100
DP_RASTER = {k: RASTER[k] for k in ("tile_size", "capacity", "chunk")}


def _poses(per_view):
    """One pose, or two stacked as the view batch, in both packages."""
    if not per_view:
        return _pose(2)
    (j1, t1), (j2, t2) = _pose(2), _pose(3)
    return (JSM.SMPLXParams(*[jnp.concatenate([a, b])
                              for a, b in zip(j1, j2)]),
            TSM.SMPLXParams(*[torch.cat([a, b]) for a, b in zip(t1, t2)]))


@pytest.mark.parametrize("per_view", [False, True])
def test_vanilla_dp_step_matches_jax(avatar, per_view):
    jmodel, jstate, tmodel, _ = avatar
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc, tc = views()
    x = view_inputs()
    keys, noise = view_keys()
    jobs, tobs = _poses(per_view)
    step = JDP.make_vanilla_sds_step_dp(
        jmodel, jsd, _grab(), make_mesh(dp=1), H, W,
        per_view_poses=per_view, **DP_RASTER)
    jts = JG.VanillaTrainState(jstate, _grab().init(jstate.gaussians.params),
                               jnp.zeros((), jnp.int32))
    jnew, jm = step(jts, jgp, jobs, jc.extrinsic, jc.intrinsics, jc.tanfov,
                    jnp.asarray(x["bg"]), jnp.asarray(x["txt"]),
                    jnp.asarray(x["unc"]), jnp.asarray(x["t"]), keys)
    jgrads, jst = jnew.opt_state, jnew.avatar.gaussians

    T = torch.as_tensor
    ts = TG.init_vanilla_train_state(
        _port_state(jstate),
        TO.build_gaussian_optimizer(RenderConfig(), MAX_STEPS))
    tstep = TDP.make_vanilla_sds_step_dp(tmodel, tsd, H, W,
                                         per_view_poses=per_view,
                                         device="cpu", **DP_RASTER)
    new, metrics = tstep(ts, tgp, tobs, tc.extrinsic, tc.intrinsics,
                         tc.tanfov, T(x["bg"]), T(x["txt"]), T(x["unc"]),
                         T(x["t"]), noise=T(noise))
    assert new.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    g = new.avatar.gaussians
    np.testing.assert_array_equal(g.grad_denom.numpy(),
                                  np.asarray(jst.grad_denom))
    assert float(g.grad_denom.sum()) > 0
    np.testing.assert_allclose(g.max_radii.numpy(), np.asarray(jst.max_radii),
                               rtol=1e-5)
    grad_close("grad_accum", g.grad_accum.numpy(), jst.grad_accum)
    scale = float(np.abs(np.asarray(jgrads.means)).max())
    for name in g.params._fields:
        leaf = getattr(g.params, name)
        if name == "quats":
            assert float(leaf.grad.abs().max()) < 1e-5 * scale
            continue
        if leaf.grad is None:
            # the DC colors only (no camera: the JAX DP step's animate):
            # the rest of the SH takes no gradient, zeros in JAX
            assert name == "sh_rest" and not np.asarray(
                getattr(jgrads, name)).any()
            continue
        grad_close(name, leaf.grad.numpy(), getattr(jgrads, name))

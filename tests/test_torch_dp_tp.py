"""The (dp = 2, tp = 2) multi-view avatar step on 4 ``gloo`` ranks against
the JAX package's DP x TP step on ``make_mesh_2d(dp=2, tp=2)``, on the CPU.

The fixtures of ``tests/test_torch_dp_avatar.py`` (the tiny avatar, B = 2
views, each view's noise the JAX draw from its key, the gradient-keeping
``_grab`` transform as the JAX step's optimizer) and the seeded tiny
guidance, whose 2 heads a block give each rank of a model group one. The
ranks (``tests/torch_ranks.py``: spawned with a join deadline, one
intra-op thread each) form model groups {0, 1} and {2, 3}, one view each;
the JAX side runs in this process on the conftest's virtual devices.
Compared: the loss within 1e-4 relative, each gradient within 2e-3
relative + 2e-4 of its largest entry, the densification statistics (the
visibility counts and max radii equal), and every rank's updated state and
gradients equal to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.parallel import dp as JDP
from dreamwaltz_g_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from dreamwaltz_g_tpu.parallel.tp import guidance_shardings as jshardings
from dreamwaltz_g_tpu.parallel.tp import shard_guidance_params as jshard
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import optim as TO
from tests import torch_ranks as TR
from tests.test_torch_dp_avatar import (MAX_STEPS, _grab, view_inputs,
                                        view_keys, views)
from tests.test_torch_scene import H, LATENT, RASTER, W, avatar_pair, \
    check_grads
from tests.torch_jax_pairs import LOSS_RTOL, grad_close, tiny_guidance_pair
import tests.torch_threads  # noqa: F401  (per-worker threads)


def test_dp_tp_avatar_step_matches_jax(tmp_path):
    jset, tmodel, _, tobs = avatar_pair()
    jsd, jgp, tsd, tgp = tiny_guidance_pair(LATENT)
    jc, tc = views()
    x = view_inputs()
    keys, noise = view_keys()
    raster = dict(tile_size=RASTER["tile_size"], capacity=RASTER["capacity"],
                  chunk=RASTER["chunk"])
    mesh = jmesh_2d(dp=2, tp=2)
    step = JDP.make_avatar_sds_step_dp(
        jset.model, jsd, _grab(), mesh, H, W,
        gparams_shardings=jshardings(jgp, mesh), **raster)
    tstate = JG.init_avatar_train_state(jset.state, _grab())
    with mesh:
        new, metrics = step(tstate, jshard(jgp, mesh), jset.observed,
                            jc.extrinsic, jc.intrinsics, jc.tanfov,
                            jnp.asarray(x["bg"]), jnp.asarray(x["txt"]),
                            jnp.asarray(x["unc"]), jnp.asarray(x["t"]), keys)
    tree = jax.tree_util.tree_map(np.asarray, jset.state)
    path = TR.save(tmp_path / "step.pt", dict(
        model=tmodel, obs=tobs, sd=tsd, gp=tgp, cam=tc, x=x, noise=noise,
        tree=tree, max_steps=MAX_STEPS, H=H, W=W, raster=raster))
    ranks = TR.run_ranks(TR.dp_tp_avatar_step, 4, path, 2, 2)
    st = new.avatar
    for r in ranks:
        assert r["loss"] == pytest.approx(float(metrics["loss"]),
                                          rel=LOSS_RTOL)
        # the rank's gradients on a twin state, against JAX's
        twin = avatar_state_from_numpy(tree, tmodel, device="cpu")
        TG.init_avatar_train_state(
            twin, TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS),
            tmodel)
        for leaf, g in zip(TG._leaves(twin, tmodel), r["grads"]):
            leaf.grad = None if g is None else torch.as_tensor(g)
        check_grads(twin.params, tmodel, new.opt_state)
        np.testing.assert_array_equal(r["grad_denom"],
                                      np.asarray(st.grad_denom))
        np.testing.assert_array_equal(r["max_radii"],
                                      np.asarray(st.max_radii))
        grad_close("grad_accum", r["grad_accum"], st.grad_accum)
    for r in ranks[1:]:
        assert TR.state_equal(r["params"], ranks[0]["params"])
        assert TR.state_equal(r["grads"], ranks[0]["grads"])

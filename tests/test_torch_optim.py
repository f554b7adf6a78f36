"""Parity of the port's avatar optimizer against optax: ``expon_lr`` and
three steps of ``build_avatar_optimizer`` on fixed gradients, from the JAX
tiny avatar carried over by ``convert.avatar_state_from_numpy``."""
import jax
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import RenderConfig
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.training import optim as TO

# float32 Adam in both, the same formula summed in another order: the
# parameters agree to float32 rounding of values ~1 (~1e-7)
TOL = 1e-6


def test_expon_lr_matches_jax():
    for args in ((1.6e-4, 1.6e-6, 5000), (1e-2, 1e-4, 100, 10, 0.1)):
        js, ts = JO.expon_lr(*args), TO.expon_lr(*args)
        for step in (0, 1, 7, 50, 99, 100, 5000, 7000):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=TOL)


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32), tree)


def _set_torch_grads(state, model, g):
    p = state.params
    for name in ("positions", "log_scales", "quats", "lbs_weights",
                 "extra_betas"):
        getattr(p, name).grad = torch.as_tensor(getattr(g, name))
    p.encoder.planes.grad = torch.as_tensor(g.encoder.planes)
    for k, mp in p.mesh.items():
        for f in mp._fields:
            getattr(mp, f).grad = torch.as_tensor(getattr(g.mesh[k], f))
    for net, tree in ((model.color_mlp, g.color_mlp),
                      (model.sq_net, g.sq_net)):
        for lname, leaf in tree["params"].items():
            lin = getattr(net, lname)
            lin.weight.grad = torch.as_tensor(leaf["kernel"]).T.contiguous()
            lin.bias.grad = torch.as_tensor(leaf["bias"])


@pytest.mark.parametrize("max_steps", [3, 5000])
def test_avatar_optimizer_three_steps_match_optax(max_steps):
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    tset = tts.tiny_avatar_setup(device="cpu")
    jparams = jset.state.params
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jset.state), tset.model,
        device="cpu")
    model = tset.model

    jtx = JO.build_avatar_optimizer(JRenderConfig(), max_steps)
    jopt = jtx.init(jparams)
    topt = TO.build_avatar_optimizer(RenderConfig(), max_steps).init(
        tstate.params, model)
    labels = [g["name"] for g in topt.adam.param_groups]
    assert "lbs" not in labels and "betas" not in labels \
        and "mesh_vertex" not in labels          # frozen by the config
    frozen = [tstate.params.lbs_weights.clone(),
              tstate.params.mesh["face"].vertex_coords.clone()]
    for step in range(3):
        g = _grads_like(jparams, seed=step)
        upd, jopt = jtx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_torch_grads(tstate, model, g)
        with torch.no_grad():
            topt.step()
    p = tstate.params
    for name in ("positions", "log_scales", "quats", "lbs_weights",
                 "extra_betas"):
        np.testing.assert_allclose(getattr(p, name).detach().numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(p.encoder.planes.detach().numpy(),
                               np.asarray(jparams.encoder.planes),
                               rtol=TOL, atol=TOL)
    for f in p.mesh["face"]._fields:
        np.testing.assert_allclose(
            getattr(p.mesh["face"], f).detach().numpy(),
            np.asarray(getattr(jparams.mesh["face"], f)), rtol=TOL, atol=TOL,
            err_msg=f)
    for net, tree in ((model.color_mlp, jparams.color_mlp),
                      (model.sq_net, jparams.sq_net)):
        for lname, leaf in tree["params"].items():
            lin = getattr(net, lname)
            np.testing.assert_allclose(lin.weight.detach().numpy(),
                                       np.asarray(leaf["kernel"]).T,
                                       rtol=TOL, atol=TOL, err_msg=lname)
            np.testing.assert_allclose(lin.bias.detach().numpy(),
                                       np.asarray(leaf["bias"]),
                                       rtol=TOL, atol=TOL, err_msg=lname)
    torch.testing.assert_close(p.lbs_weights.detach(), frozen[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(p.mesh["face"].vertex_coords.detach(),
                               frozen[1], rtol=0, atol=0)
    assert topt.count == 3

"""Parity of the port's field encoder and decode networks against the JAX
package: the triplane encoding, ``SigmaMLP`` and ``DeformNetwork`` with
Flax weights carried by ``convert.load_flax_dense_params``. Float32 results
agree within 1e-5 (a few float32 dot products of width <= 128)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.human.deform import DeformNetwork as JDeform
from dreamwaltz_g_tpu.nerf import encoder as jenc
from dreamwaltz_g_tpu.nerf.network import SigmaMLP as JSigma
from dreamwaltz_g_tpu_torch.convert import load_flax_dense_params
from dreamwaltz_g_tpu_torch.human.deform import DeformNetwork as TDeform
from dreamwaltz_g_tpu_torch.nerf import encoder as tenc
from dreamwaltz_g_tpu_torch.nerf.network import SigmaMLP as TSigma
import tests.torch_threads  # noqa: F401  (per-worker threads)

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol)


@pytest.mark.parametrize("reduce", ["sum", "concat"])
def test_triplane_encode_matches_jax(reduce):
    rng = np.random.default_rng(0)
    jcfg = jenc.TriplaneConfig(resolution=16, feature_dim=8, reduce=reduce)
    tcfg = tenc.TriplaneConfig(resolution=16, feature_dim=8, reduce=reduce)
    planes = np.array(jenc.init_triplane(jcfg, jax.random.PRNGKey(1)).planes)
    # bound 2: a few points fall outside and must encode to zero
    pos = rng.uniform(-2.2, 2.2, size=(500, 3)).astype(np.float32)
    j = jenc.encode_any(jenc.TriplaneParams(jnp.asarray(planes)), jcfg,
                        jnp.asarray(pos), 2.0)
    t = tenc.encode_any(tenc.TriplaneParams(torch.as_tensor(planes)), tcfg,
                        torch.as_tensor(pos), 2.0)
    _close(j, t)
    assert (np.abs(np.asarray(j)).sum(-1) == 0).any()


def test_encode_any_refuses_unported_grid():
    """The grid is ported: ``encode_any`` dispatches a
    ``GridEncoderConfig`` to ``grid_encode``, as the JAX function does
    (``test_torch_grid.py`` holds the grid to the JAX one)."""
    cfg = tenc.GridEncoderConfig(num_levels=2, log2_hashmap_size=8,
                                 desired_resolution=32)
    params = tenc.init_grid_encoder(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(7, 3)
    assert torch.equal(tenc.encode_any(params, cfg, x),
                       tenc.grid_encode(params, cfg, x))


def test_frequency_encode_matches_jax():
    x = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    _close(jenc.frequency_encode(jnp.asarray(x), degree=10),
           tenc.frequency_encode(torch.as_tensor(x), degree=10))


@pytest.mark.parametrize("layers", [2, 3])
def test_sigma_mlp_matches_jax(layers):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    jm = JSigma(hidden=64, num_layers=layers, out_channels=4)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32))))
    tm = TSigma(32, hidden=64, num_layers=layers, out_channels=4)
    load_flax_dense_params(tm, params)
    _close(jm.apply(params, jnp.asarray(x)), tm(torch.as_tensor(x)))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(xyz_input_ch=None),
    dict(residual=True),
    dict(is_6dof=True),
], ids=["encoded", "freq", "residual", "6dof"])
def test_deform_network_matches_jax(kw):
    rng = np.random.default_rng(4)
    xyz_ch = kw.get("xyz_input_ch", 32)
    feats = rng.normal(size=(48, 3 if xyz_ch is None else xyz_ch))
    feats = feats.astype(np.float32)
    pose = (rng.normal(size=(1, 63)) * 0.3).astype(np.float32)
    jm = JDeform(depth=4, width=64, **kw)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(feats),
                     jnp.asarray(pose))
    # heads start at N(0, 1e-4^2): rescale so their outputs are O(1)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, p in params["params"].items():
        if not name.startswith("dense"):
            p["kernel"] = p["kernel"] * 1e3
    tm = TDeform(**kw)
    load_flax_dense_params(tm, params)
    jo = jm.apply(params, jnp.asarray(feats), jnp.asarray(pose))
    to = tm(torch.as_tensor(feats), torch.as_tensor(pose))
    for j, t in zip(jo, to):
        _close(j, t)


def test_load_flax_params_rejects_mismatched_layers():
    jm = JSigma(hidden=16, num_layers=2, out_channels=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    with pytest.raises(ValueError):
        load_flax_dense_params(TSigma(8, hidden=16, num_layers=3), params)

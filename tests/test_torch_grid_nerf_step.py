"""The stage-1 NeRF SDS step on a tiled-grid field (``--nerf.backbone
tiledgrid``: 4 levels, 2^8 tables) of the port against the JAX package, on
the CPU: ``test_torch_nerf_step.py``'s "plain" case (the background MLP,
ray sparsity, volume sparsity and sigma guidance, the JAX draws handed to
the port) with the grid in place of the triplane, its tables N(0, 1) so
that the field has structure. Its envelope: the loss within 1e-4
relative, each gradient (the tables' included) within 2e-3 relative plus
2e-4 of its largest entry, the updated weights where the gradient is well
above rounding within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.test_torch_nerf_step as NS
from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.nerf import encoder as JE
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf import renderer as JR
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.nerf.renderer import OccupancyGrid
import tests.torch_threads  # noqa: F401  (per-worker threads)

GRID = dict(backbone="tiledgrid", num_levels=4, level_dim=2,
            base_resolution=4, desired_resolution=32, log2_hashmap_size=8)


def _grid_field(cfg_fields):
    """``NS._field`` on the grid: the JAX field with seeded tables, a grid
    refreshed once from it, and the port's twins."""
    jcfg = JNeRFConfig(**cfg_fields)
    jmodel = JN.build_nerf(jcfg, with_background=True)
    params = jmodel.init(jax.random.PRNGKey(1))
    tables = np.random.default_rng(6).normal(
        size=params.encoder.tables.shape).astype(np.float32)
    params = params._replace(encoder=JE.GridEncoderParams(
        jnp.asarray(tables)))
    grid = JR.update_occupancy(JR.init_occupancy(jcfg.grid_size), jmodel,
                               params, jax.random.PRNGKey(2))
    tmodel = TN.build_nerf(NeRFConfig(**cfg_fields), with_background=True,
                           device="cpu")
    assert tmodel.enc_name == "tables"
    convert.nerf_state_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tmodel)
    tgrid = OccupancyGrid(*[torch.as_tensor(np.array(x)) for x in grid])
    return jcfg, jmodel, params, grid, tmodel, tgrid


def test_grid_nerf_sds_step_matches_jax(monkeypatch):
    monkeypatch.setattr(NS, "FIELD", dict(NS.FIELD, **GRID))
    monkeypatch.setattr(NS, "_field", _grid_field)
    NS.test_nerf_sds_step_matches_jax(NS._make_case("plain"), monkeypatch)

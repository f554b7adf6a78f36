"""The multi-resolution grid encoder of the port (``--nerf.backbone
hashgrid | tiledgrid``) against the JAX package, on the CPU, and the grid
field through the CLI's two stages.

* ``_level_indices``: every corner index equal to JAX's, for 'tiled' and
  'hash', on levels whose strides fit the table and levels where they
  overflow it, at corners whose xor-prime products pass 2^32 (the JAX code
  wraps them in uint32; the port masks int64 products to 32 bits);
  the trilinear weights within 1e-6.
* ``grid_encode``: within 1e-6 of the largest entry, zero features out of
  bounds, the tables cast to bf16 before the gather under
  ``compute_dtype='bf16'``; the tables' gradient within 2e-3 relative +
  2e-4 of its largest entry.
* ``tables_from_flat`` / ``tables_to_flat`` round-trip exactly and equal
  the JAX functions.
* A ``--nerf.backbone tiledgrid`` stage 1 -> stage 2 chain through
  ``main``: the stage-1 tables carried into the avatar to the bit.

Grids of at most 4 levels and 2^8 tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.nerf import encoder as JE
from dreamwaltz_g_tpu_torch.nerf import encoder as TE
import tests.torch_threads  # noqa: F401  (per-worker threads)

# 4 levels, 2^8 tables: level 0 fits the table, levels 1-3 overflow it
CFG = dict(num_levels=4, level_dim=2, base_resolution=4,
           desired_resolution=64, log2_hashmap_size=8)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4


def _coords(n=400, seed=0):
    """Points in [0, 1]^3 with the cube's corners, faces and the top
    corner, where the hash's prime products are largest."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(size=(n, 3)),
           np.asarray([[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 0.5, 0.5],
                       [1 - 1e-7, 1, 1 - 1e-7], [0, 1, 0]])]
    return np.concatenate(pts).astype(np.float32)


def _cfgs(gridtype):
    return (JE.GridEncoderConfig(gridtype=gridtype, **CFG),
            TE.GridEncoderConfig(gridtype=gridtype, **CFG))


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_level_indices_equal_jax(gridtype):
    jcfg, tcfg = _cfgs(gridtype)
    assert tcfg.max_table_size == jcfg.max_table_size == 256
    x = _coords()
    overflow = []
    for lv in range(jcfg.num_levels):
        args = (jcfg.level_scale(lv), jcfg.level_resolution(lv),
                jcfg.level_table_size(lv), gridtype)
        assert args[:3] == (tcfg.level_scale(lv), tcfg.level_resolution(lv),
                            tcfg.level_table_size(lv))
        ji, jw = JE._level_indices(jnp.asarray(x), *args)
        ti, tw = TE._level_indices(torch.as_tensor(x), *args)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                      err_msg=f"level {lv}")
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
        assert int(ti.max()) < args[2] and int(ti.min()) >= 0
        overflow.append((args[1] + 1) ** 3 > args[2])
    assert overflow == [False, True, True, True]
    if gridtype == "hash":
        # the top corner's products wrap: 65 * 805459861 > 2^32
        res = jcfg.level_resolution(3)
        assert (res + 1) * JE._PRIMES[2] > 2 ** 32


def _tables(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.num_levels, cfg.max_table_size,
                            cfg.level_dim)).astype(np.float32)


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_grid_encode_and_gradient_match_jax(gridtype):
    jcfg, tcfg = _cfgs(gridtype)
    tab = _tables(jcfg)
    rng = np.random.default_rng(2)
    bound = 2.0
    pos = rng.uniform(-1.1 * bound, 1.1 * bound, size=(300, 3)).astype(
        np.float32)
    ct = rng.normal(size=(300, jcfg.output_dim)).astype(np.float32)

    def jloss(t):
        out = JE.grid_encode(JE.GridEncoderParams(t), jcfg, jnp.asarray(pos),
                             bound)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tab))
    t = torch.as_tensor(tab).requires_grad_(True)
    tout = TE.grid_encode(TE.GridEncoderParams(t), tcfg,
                          torch.as_tensor(pos), bound)
    (tout * torch.as_tensor(ct)).sum().backward()
    jout, jg = np.asarray(jout), np.asarray(jg)
    scale = np.abs(jout).max()
    assert np.abs(tout.detach().numpy() - jout).max() <= 1e-6 * scale
    bound_g = GRAD_RTOL * np.abs(jg) + GRAD_ATOL_OF_MAX * np.abs(jg).max()
    assert (np.abs(t.grad.numpy() - jg) <= bound_g).all()
    # out-of-bound points give zero features, on both sides
    outside = (np.abs(pos) > bound).any(-1)
    assert outside.any() and (~outside).any()
    assert not tout.detach().numpy()[outside].any()
    assert not jout[outside].any()
    assert np.abs(jout[~outside]).min(-1).max() > 0


def test_bf16_tables_are_cast_before_the_gather():
    """``compute_dtype='bf16'``: the output equals the float32 encode of
    the tables rounded to bf16 (float32 weights, float32 sums), and the
    JAX bf16 encode within 1e-6 of its largest entry."""
    jcfg = JE.GridEncoderConfig(compute_dtype="bf16", **CFG)
    tcfg = TE.GridEncoderConfig(compute_dtype="bf16", **CFG)
    tab = _tables(jcfg, seed=3)
    pos = np.random.default_rng(4).uniform(-1, 1, size=(200, 3)).astype(
        np.float32)
    got = TE.grid_encode(TE.GridEncoderParams(torch.as_tensor(tab)), tcfg,
                         torch.as_tensor(pos))
    assert got.dtype == torch.float32
    rounded = torch.as_tensor(tab).to(torch.bfloat16).float()
    want = TE.grid_encode(TE.GridEncoderParams(rounded),
                          tcfg._replace(compute_dtype="f32"),
                          torch.as_tensor(pos))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    full = TE.grid_encode(TE.GridEncoderParams(torch.as_tensor(tab)),
                          tcfg._replace(compute_dtype="f32"),
                          torch.as_tensor(pos))
    assert float((full - got).abs().max()) > 1e-4     # the cast acts
    j = np.asarray(JE.grid_encode(JE.GridEncoderParams(jnp.asarray(tab)),
                                  jcfg, jnp.asarray(pos)))
    assert np.abs(got.numpy() - j).max() <= 1e-6 * np.abs(j).max()


def test_tables_flat_round_trip_and_init():
    jcfg, tcfg = _cfgs("tiled")
    total = sum(tcfg.level_table_size(lv) for lv in range(tcfg.num_levels))
    assert tcfg.total_params == jcfg.total_params == total * tcfg.level_dim
    flat = np.random.default_rng(5).normal(size=(total, 2)).astype(
        np.float32)
    tp = TE.tables_from_flat(tcfg, flat, device="cpu")
    np.testing.assert_array_equal(tp.tables.numpy(), np.asarray(
        JE.tables_from_flat(jcfg, flat).tables))
    np.testing.assert_array_equal(TE.tables_to_flat(tcfg, tp), flat)
    with pytest.raises(ValueError, match="tiledgrid"):
        TE.tables_from_flat(TE.TriplaneConfig(), flat, device="cpu")
    init = TE.init_grid_encoder(tcfg, torch.Generator().manual_seed(0))
    assert init.tables.shape == (4, 256, 2)
    assert 0 < float(init.tables.abs().max()) <= 1e-4


def test_enc_cfg_from_nerf_matches_jax():
    from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig

    for backbone in ("triplane", "tiledgrid", "hashgrid"):
        kw = dict(backbone=backbone, bound=1.5, grid_dtype="bf16")
        assert tuple(TE.enc_cfg_from_nerf(NeRFConfig(**kw))) == \
            tuple(JE.enc_cfg_from_nerf(JNeRFConfig(**kw)))


def test_grid_field_through_the_cli(tmp_path):
    """``--nerf.backbone tiledgrid``: stage 1 trains the grid field and
    checkpoints it; stage 2 (``--render.from_nerf``) seeds the avatar from
    it with the tables carried over to the bit, trains and evaluates."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer
    from dreamwaltz_g_tpu_torch.configs import parse_args

    grid = ["--nerf.backbone", "tiledgrid", "--nerf.num_levels", "4",
            "--nerf.log2_hashmap_size", "8", "--nerf.base_resolution", "4",
            "--nerf.desired_resolution", "32",
            "--nerf.density_prior", "gaussian",
            "--nerf.density_thresh", "2.0", "--nerf.bound", "1.0"]
    common = ["--optim.iters", "2", "--data.train_w", "16",
              "--data.train_h", "16", "--data.eval_size", "2",
              "--log.debug", "true", "--log.platform", "cpu",
              "--log.exp_root", str(tmp_path),
              "--data.eval_h", "16", "--data.eval_w", "16",
              "--log.snapshot_interval", "0",
              "--log.evaluate_interval", "0"] + grid
    s1 = main(["--stage", "nerf", "--log.exp_name", "s1",
               "--log.save_interval", "2"] + common)
    assert s1.nerf.enc_name == "tables" and s1.nerf.tables.shape == (4, 256, 2)
    assert np.isfinite(s1.losses).all()
    s2_args = ["--stage", "gs", "--render.from_nerf", str(tmp_path / "s1"),
               "--render.n_gaussians", "128", "--render.nerf_resolution",
               "24", "--log.exp_name", "s2"] + common
    fresh = Trainer(parse_args(s2_args + ["--optim.iters", "0"]))
    assert torch.equal(fresh.state.avatar.params.encoder.tables,
                       s1.nerf.tables.detach())
    s2 = main(s2_args)
    assert len(s2.losses) == 2 and np.isfinite(s2.losses).all()
    assert not torch.equal(s2.state.avatar.params.encoder.tables,
                           s1.nerf.tables.detach())
    frames = s2.evaluate(save_dir=tmp_path / "ev")
    assert len(frames) == 2 and np.isfinite(frames).all()

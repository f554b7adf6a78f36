"""``convert_reference`` of the port against the JAX package's, on the CPU:
the state dicts of the JAX ``tests/test_convert_reference.py`` (the
reference's key layout, seeded) through both packages' converters.

* The NeRF checkpoint: the tables, the sigma and background MLPs equal to
  the JAX ``NeRFParams`` leaf for leaf, and the field's density within
  1e-6 of its largest value; also read back from a ``.pth`` in the
  reference's wrapper through ``load_torch_checkpoint``.
* The avatar checkpoint: every leaf of the converted ``AvatarState`` (and
  the two networks' weights) equal to the JAX state's, and its render
  (``make_avatar_render``, the sorted blend) within the render tests'
  5e-3, also after a ``.pth`` round trip.
* The plain 3DGS checkpoint (the vanilla avatar's / a background's
  ``GaussianState``): every leaf equal.
"""
import jax.numpy as jnp
import numpy as np
import torch

from dreamwaltz_g_tpu import convert_reference as JCR
from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch import convert_reference as TCR
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from tests.test_convert_reference import _mlp_sd
import tests.torch_threads  # noqa: F401  (per-worker threads)

NERF = dict(backbone="tiledgrid", num_levels=4, level_dim=2,
            base_resolution=4, desired_resolution=32, log2_hashmap_size=8,
            bound=1.0)
ATOL_RENDER = 5e-3     # test_torch_avatar.py's end-to-end render tolerance


def _nerf_sd(rng, enc_cfg, with_bg=True):
    total = sum(enc_cfg.level_table_size(lv)
                for lv in range(enc_cfg.num_levels))
    sd = {"encoder.embeddings": rng.normal(size=(total, 2)).astype(
        np.float32) * 1e-2}
    sd.update(_mlp_sd("sigma_net.", (enc_cfg.output_dim, 64, 64, 4), rng))
    if with_bg:
        sd.update(_mlp_sd("bg_net.", (39, 64, 3), rng))
    return sd


def _dense_equal(module, flax_params):
    layers = flax_params["params"]
    assert set(layers) == {n for n, _ in module.named_children()}
    for name, lin in module.named_children():
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      np.asarray(layers[name]["kernel"]).T)
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      np.asarray(layers[name]["bias"]))


def _nerf_equal(tmodel, jparams, jmodel, rng):
    np.testing.assert_array_equal(tmodel.tables.detach().numpy(),
                                  np.asarray(jparams.encoder.tables))
    _dense_equal(tmodel.sigma_mlp, jparams.sigma_mlp)
    if jparams.bg_mlp is None:
        assert tmodel.bg_mlp is None
    else:
        _dense_equal(tmodel.bg_mlp, jparams.bg_mlp)
    pts = rng.uniform(-0.9, 0.9, size=(64, 3)).astype(np.float32)
    js, ja = jmodel.density(jparams, jnp.asarray(pts))
    with torch.no_grad():
        ts, ta = tmodel.density(torch.as_tensor(pts))
    for t, j in ((ts, js), (ta, ja)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()


def test_nerf_checkpoint_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    jcfg = JNeRFConfig(**NERF)
    jmodel = JN.build_nerf(jcfg)
    sd = _nerf_sd(rng, jmodel.enc_cfg)
    tmodel = TCR.convert_nerf_checkpoint(sd, NeRFConfig(**NERF),
                                         device="cpu")
    _nerf_equal(tmodel, JCR.convert_nerf_checkpoint(sd, jmodel.enc_cfg),
                jmodel, rng)
    # a stage-1 .pth in the reference's wrapper, without a background
    sd = _nerf_sd(rng, jmodel.enc_cfg, with_bg=False)
    path = tmp_path / "step_005000.pth"
    torch.save({"train_step": 5000, "model": {
        k: torch.from_numpy(v) for k, v in sd.items()}}, str(path))
    loaded = TCR.load_torch_checkpoint(str(path))
    assert loaded.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], sd[k])
    tmodel = TCR.convert_nerf_checkpoint(loaded, NeRFConfig(**NERF),
                                         device="cpu")
    jmodel_nobg = JN.build_nerf(jcfg, with_background=False)
    _nerf_equal(tmodel, JCR.convert_nerf_checkpoint(
        JCR.load_torch_checkpoint(str(path)), jmodel.enc_cfg,
        with_background=False), jmodel_nobg, rng)


def _avatar_sd(model, rng, N=40):
    """The JAX test's reference-layout avatar dict (its ``TestAvatar
    Conversion``), on the JAX tiny avatar's grid."""
    enc_cfg = model.enc_cfg
    total = sum(enc_cfg.level_table_size(lv)
                for lv in range(enc_cfg.num_levels))
    J = model.smpl.num_joints
    sd = {
        "avatar._positions": rng.normal(size=(N, 3)).astype(np.float32) * .1
        + np.asarray([0, 0.7, 0], np.float32),
        "avatar._scales": np.full((N, 3), -4.0, np.float32),
        "avatar._quaternions": np.tile(np.asarray([1, 0, 0, 0], np.float32),
                                       (N, 1)),
        "avatar._lbs_weights": np.abs(rng.normal(size=(N, J))).astype(
            np.float32),
        "avatar.nerf_encoder.embeddings": rng.normal(
            size=(total, 2)).astype(np.float32),
        "avatar._betas": rng.normal(size=(10,)).astype(np.float32),
    }
    sd.update({f"avatar.nerf_opacity_and_color_net.{k}": v
               for k, v in _mlp_sd("", (enc_cfg.output_dim, 32, 4),
                                   rng).items()})
    for i, (cin, cout) in enumerate([(enc_cfg.output_dim + 63, 32),
                                     (32, 32)]):
        sd[f"avatar.deform_model.layers.{i}.weight"] = rng.normal(
            size=(cout, cin)).astype(np.float32) * 0.01
        sd[f"avatar.deform_model.layers.{i}.bias"] = np.zeros(cout,
                                                              np.float32)
    for head, dim in (("gaussian_warp", 3), ("gaussian_rotation", 4),
                      ("gaussian_scaling", 3)):
        sd[f"avatar.deform_model.{head}.weight"] = rng.normal(
            size=(dim, 32)).astype(np.float32) * 1e-3
        sd[f"avatar.deform_model.{head}.bias"] = np.zeros(dim, np.float32)
    st = model.mesh_parts["face"]
    Fp, G = st.triangles.shape[0], st.n_per_triangle
    sd["avatar.mesh_binding_gaussians.face._bary_coords"] = np.full(
        (Fp, G, 3), 1 / 3, np.float32)
    sd["avatar.mesh_binding_gaussians.face._vertex_coords"] = np.asarray(
        model.smpl.v_template)[np.asarray(st.vertex_indices)]
    sd["avatar.mesh_binding_gaussians.face._scales"] = np.ones(
        (Fp * G, 3), np.float32)
    return sd


def _avatar_equal(tstate, tmodel, jstate):
    p, jp = tstate.params, jstate.params
    for name in ("positions", "log_scales", "quats", "lbs_weights",
                 "extra_betas"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(p.encoder.tables.numpy(),
                                  np.asarray(jp.encoder.tables))
    for f in p.mesh["face"]._fields:
        np.testing.assert_array_equal(getattr(p.mesh["face"], f).numpy(),
                                      np.asarray(getattr(jp.mesh["face"], f)),
                                      err_msg=f)
    assert p.smpl_learn == {} and dict(jp.smpl_learn) == {}
    for name in ("alive", "grad_accum", "grad_denom", "max_radii"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    _dense_equal(tmodel.color_mlp, jp.color_mlp)
    _dense_equal(tmodel.sq_net, jp.sq_net)


def test_avatar_checkpoint_matches_jax_and_renders(tmp_path):
    jset = jts.tiny_avatar_setup(capacity=64, n_points=32)
    tset = tts.tiny_avatar_setup(capacity=64, n_points=32, device="cpu",
                                 enc_cfg=tts.TINY_GRID)
    assert tuple(tset.model.enc_cfg) == tuple(jset.model.enc_cfg)
    sd = _avatar_sd(jset.model, np.random.default_rng(1))
    jstate = JCR.convert_avatar_checkpoint(sd, jset.model, capacity=64)
    tstate = TCR.convert_avatar_checkpoint(sd, tset.model, capacity=64,
                                           device="cpu")
    _avatar_equal(tstate, tset.model, jstate)
    # the default capacity: the live count + 25%
    assert TCR.convert_avatar_checkpoint(
        sd, tset.model, device="cpu").capacity == \
        JCR.convert_avatar_checkpoint(sd, jset.model).capacity == 50

    path = tmp_path / "step_015000.pth"
    torch.save({"train_step": 15000, "checkpoints": ["step_015000.pth"],
                "model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, str(path))
    tstate = TCR.convert_avatar_checkpoint(
        TCR.load_torch_checkpoint(str(path)), tset.model, capacity=64,
        device="cpu")
    _avatar_equal(tstate, tset.model, jstate)

    H = W = 32
    rk = dict(tile_size=8, capacity=64, chunk=32)
    cam = (2.0, 20.0, 90.0, 50.0, H, W)
    jc = jcamera(*cam, at_vector=((0, 0.7, 0),))
    tc = tcamera(*cam, at_vector=((0, 0.7, 0),), device="cpu")
    jout = JG.make_avatar_render(jset.model, H, W, **rk)(
        jstate, jset.observed, jc.extrinsic[0], jc.intrinsics[0],
        jc.tanfov[0], jnp.full((H, W, 3), 0.3))
    tout = TG.make_avatar_render(tset.model, H, W, device="cpu", **rk)(
        tstate, tset.observed, tc.extrinsic[0], tc.intrinsics[0],
        tc.tanfov[0], torch.full((H, W, 3), 0.3))
    assert float(tout[1].max()) > 0.5      # the avatar covers pixels
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=ATOL_RENDER)


def test_gaussian_checkpoint_matches_jax():
    rng = np.random.default_rng(2)
    N = 50
    sd = {
        "_positions": rng.normal(size=(N, 3)).astype(np.float32),
        "_sh_features_dc": rng.normal(size=(N, 1, 3)).astype(np.float32),
        "_sh_features_rest": rng.normal(size=(N, 15, 3)).astype(np.float32),
        "_opacities": rng.normal(size=(N, 1)).astype(np.float32),
        "_scales": rng.normal(size=(N, 3)).astype(np.float32) - 5.0,
        "_quaternions": rng.normal(size=(N, 4)).astype(np.float32),
    }
    for cap in (None, 64):
        j = JCR.convert_gaussian_checkpoint(sd, capacity=cap)
        t = TCR.convert_gaussian_checkpoint(sd, capacity=cap, device="cpu")
        assert t.capacity == j.capacity == (cap or N)
        for name in j.params._fields:
            np.testing.assert_array_equal(
                getattr(t.params, name).numpy(),
                np.asarray(getattr(j.params, name)), err_msg=name)
        for name in ("alive", "grad_accum", "grad_denom", "max_radii"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))

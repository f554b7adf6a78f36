"""The NeRF -> mesh export of the port against the JAX package, on the CPU:
``nerf/isosurface.py`` (the tet grid, marching tets, the weld, the field
queries), ``nerf/mesh_export.py`` (the host stages, the albedo bake, the
textured export) and ``main.run``'s dispatch of the CLI's five modes.

Tolerances:
* the tet grid, the marching's triangle slots and their validity, and the
  welded mesh equal (the edge points are interpolated in the JAX
  package's order of operations, so the weld's rounding to 5 decimals
  sees the same float32 values); the SDF's gradient through the edge
  interpolation within 1e-5 relative;
* the host stages (clean, decimate, UV unwrap, UV rasterization,
  inpainting) equal: the same numpy code on the same input;
* the baked albedo and the vertex colors within 1e-5 (float32 field
  queries in two frameworks; the tiny field's planes are the JAX ones,
  ``convert.nerf_state_from_numpy``);
* ``export_mesh`` of that field at resolution 16: the field's densities
  differ by float32 rounding, which can move an edge point across the
  weld's fifth decimal and split or merge a vertex, so every vertex lies
  within 2e-5 of one of the JAX mesh's and back (a weld cell's diagonal
  is 1.7e-5), at least 99% of the
  faces map onto the JAX faces through that matching, at least 99% of
  the vertices sit where the JAX ones do, and there their colors are
  within 1e-5;
* ``export_textured_mesh`` from one isosurface (the JAX one handed to
  both): the OBJ's faces and UV indices equal, its positions and UVs
  within 1e-5 (the OBJ's decimal text), the MTL equal, the albedo PNG
  within one 8-bit level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.nerf import isosurface as JI
from dreamwaltz_g_tpu.nerf import mesh_export as JM
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.nerf import isosurface as TI
from dreamwaltz_g_tpu_torch.nerf import mesh_export as TM
from dreamwaltz_g_tpu_torch.nerf import network as TN
import tests.torch_threads  # noqa: F401  (per-worker threads)

FIELD_TOL = 1e-5
WELD_TOL = 2e-5
FIELD = dict(triplane_resolution=16, triplane_dim=8)


def _sdf(verts, kind):
    """> 0 inside: a sphere, or an off-centre ellipsoid."""
    if kind == "sphere":
        return 0.6 - np.linalg.norm(verts, axis=-1)
    q = (verts - np.asarray([0.1, -0.05, 0.2])) / np.asarray([0.7, 0.4, 0.5])
    return (1.0 - np.linalg.norm(q, axis=-1)).astype(np.float32)


def test_tet_grid_matches_jax():
    for res, bound in ((7, 1.3), (16, 2.0)):
        jv, jt = JI.make_tet_grid(res, bound)
        tv, tt = TI.make_tet_grid(res, bound)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tt, jt)
        assert tt.shape == (6 * (res - 1) ** 3, 4)


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_marching_tets_and_weld_match_jax(kind):
    verts, tets = JI.make_tet_grid(24, 1.0)
    sdf = _sdf(verts, kind).astype(np.float32)
    js = JI.marching_tets(jnp.asarray(verts), jnp.asarray(sdf),
                          jnp.asarray(tets))
    ts = TI.marching_tets(torch.as_tensor(verts), torch.as_tensor(sdf),
                          torch.as_tensor(tets))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.vertices.numpy(),
                                  np.asarray(js.vertices))
    jv, jf = JI.compact_mesh(js)
    tv, tf = TI.compact_mesh(ts)
    assert len(tf) > 500
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == np.int64 and tf.max() < len(tv)


def test_marching_tets_empty_fields_and_gradient():
    verts, tets = TI.make_tet_grid(8, 1.0)
    v, t = torch.as_tensor(verts), torch.as_tensor(tets)
    for value in (1.0, -1.0):
        soup = TI.marching_tets(v, torch.full((len(verts),), value), t)
        assert not soup.valid.any()
        assert TI.compact_mesh(soup)[1].shape == (0, 3)

    def jloss(r):
        soup = JI.marching_tets(jnp.asarray(verts), r - jnp.linalg.norm(
            jnp.asarray(verts), axis=-1), jnp.asarray(tets))
        w = jnp.repeat(soup.valid, 3).astype(jnp.float32)
        pts = soup.vertices.reshape(-1, 3)
        return jnp.sum(w * jnp.sum(pts ** 2, -1)) / jnp.maximum(w.sum(), 1.)

    r = torch.tensor(0.5, requires_grad=True)
    soup = TI.marching_tets(v, r - torch.linalg.norm(v, dim=-1), t)
    w = soup.valid.repeat_interleave(3).float()
    loss = torch.sum(w * torch.sum(soup.vertices.reshape(-1, 3) ** 2, -1)) \
        / torch.clamp(w.sum(), min=1.0)
    loss.backward()
    want = float(jax.grad(jloss)(0.5))
    assert want > 0
    np.testing.assert_allclose(float(r.grad), want, rtol=1e-5)


@pytest.fixture(scope="module")
def sphere_mesh():
    verts, tets = JI.make_tet_grid(20, 1.0)
    v, f = JI.compact_mesh(JI.marching_tets(
        jnp.asarray(verts), jnp.asarray(_sdf(verts, "ellipsoid")),
        jnp.asarray(tets)))
    return v, f


def test_host_stages_match_jax(sphere_mesh):
    v, f = sphere_mesh
    # a few stray triangles far away: the clean step prunes them
    stray = np.asarray([[2.0, 2.0, 2.0], [2.01, 2.0, 2.0], [2.0, 2.01, 2.0]],
                       np.float32)
    v2 = np.concatenate([v, stray])
    f2 = np.concatenate([f, [[len(v), len(v) + 1, len(v) + 2]]])
    for got, want in zip(TM.clean_mesh(v2, f2), JM.clean_mesh(v2, f2)):
        np.testing.assert_array_equal(got, want)
    cv, cf = TM.clean_mesh(v2, f2)
    assert len(f) - 20 <= len(cf) < len(f) and cv.max() < 1.5
    for got, want in zip(TM.decimate_mesh(cv, cf, len(cf) // 3),
                         JM.decimate_mesh(cv, cf, len(cf) // 3)):
        np.testing.assert_array_equal(got, want)
    dv, df = TM.decimate_mesh(cv, cf, len(cf) // 3)
    assert len(df) <= len(cf) // 3 + 2
    np.testing.assert_array_equal(
        TM._vertex_quadrics(dv.astype(np.float64), df),
        JM._vertex_quadrics(dv.astype(np.float64), df))
    for got, want in zip(TM.unwrap_uv(dv, df), JM.unwrap_uv(dv, df)):
        np.testing.assert_array_equal(got, want)
    vt, ft = TM.unwrap_uv(dv, df)
    assert vt.min() >= 0.0 and vt.max() <= 1.0
    for got, want in zip(TM.rasterize_uv_attribute(dv, df, vt, ft, 64),
                         JM.rasterize_uv_attribute(dv, df, vt, ft, 64)):
        np.testing.assert_array_equal(got, want)
    tex, mask = TM.rasterize_uv_attribute(dv, df, vt, ft, 64)
    assert 0.1 < mask.mean() < 1.0
    np.testing.assert_array_equal(TM.inpaint_texture(tex, mask),
                                  JM.inpaint_texture(tex, mask))
    lat = np.random.default_rng(0).uniform(size=(5, 4)).astype(np.float32)
    np.testing.assert_array_equal(TM._latent_to_rgb(lat),
                                  JM._latent_to_rgb(lat))


@pytest.fixture(scope="module")
def field():
    """A JAX field whose density exceeds its median in places, and the
    port's twin; a threshold at the density's 80th percentile on the
    resolution-16 grid."""
    jmodel = JN.build_nerf(JNeRFConfig(**FIELD), with_background=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    params = params._replace(encoder=params.encoder._replace(
        planes=params.encoder.planes * 6.0))
    tmodel = TN.build_nerf(NeRFConfig(**FIELD), device="cpu")
    convert.nerf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tmodel)
    verts, _ = JI.make_tet_grid(16, jmodel.bound)
    sigma, _ = jmodel.density(params, jnp.asarray(verts))
    return jmodel, params, tmodel, float(np.percentile(np.asarray(sigma),
                                                       80))


def test_bake_albedo_matches_jax(field, sphere_mesh):
    jmodel, params, tmodel, _ = field
    v, f = sphere_mesh
    vt, ft = JM.unwrap_uv(v, f)
    want = JM.bake_albedo(jmodel, params, v, f, vt, ft, texture_size=64)
    got = TM.bake_albedo(tmodel, v, f, vt, ft, texture_size=64)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    assert got.std() > 0
    np.testing.assert_allclose(got, want, atol=FIELD_TOL)


def test_export_mesh_matches_jax(field):
    jmodel, params, tmodel, thresh = field
    jv, jf, jc = JI.export_mesh(jmodel, params, resolution=16,
                                density_thresh=thresh)
    tv, tf, tc = TI.export_mesh(tmodel, resolution=16, density_thresh=thresh)
    assert len(tf) > 100 and tf.max() < len(tv)
    d = torch.cdist(torch.as_tensor(tv), torch.as_tensor(jv),
                    compute_mode="donot_use_mm_for_euclid_dist")
    near = d.min(1)
    assert float(near.values.max()) <= WELD_TOL
    assert float(d.min(0).values.max()) <= WELD_TOL
    match = near.indices.numpy()
    mapped = {tuple(sorted(x)) for x in match[tf].tolist()}
    want = {tuple(sorted(x)) for x in jf.tolist()}
    assert len(mapped & want) >= 0.99 * len(want)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    # the colors where the weld put a vertex at the same place
    same = (near.values == 0).numpy()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tc[same], jc[match[same]], atol=FIELD_TOL)


def test_export_textured_mesh_matches_jax(field, tmp_path, monkeypatch):
    jmodel, params, tmodel, thresh = field
    kw = dict(resolution=16, density_thresh=thresh, texture_size=64)
    iso = JI.export_mesh(jmodel, params, resolution=16,
                         density_thresh=thresh)
    monkeypatch.setattr(JI, "export_mesh", lambda *a, **k: iso)
    monkeypatch.setattr(TI, "export_mesh", lambda *a, **k: iso)
    jobj = JM.export_textured_mesh(jmodel, params, str(tmp_path / "jax"),
                                   decimate_target=400, **kw)
    tobj = TM.export_textured_mesh(tmodel, str(tmp_path / "port"),
                                   decimate_target=400, **kw)
    assert tobj == str(tmp_path / "port" / "mesh.obj")

    def parse(path):
        rows = {"v": [], "vt": [], "f": []}
        for line in open(path):
            head, *rest = line.split()
            if head in rows:
                rows[head].append(rest)
        return rows

    t, j = parse(tobj), parse(jobj)
    assert t["f"] == j["f"] and len(t["f"]) <= 402
    for k in ("v", "vt"):
        np.testing.assert_allclose(np.asarray(t[k], np.float64),
                                   np.asarray(j[k], np.float64),
                                   atol=FIELD_TOL)
    assert (tmp_path / "port" / "mesh.mtl").read_text() \
        == (tmp_path / "jax" / "mesh.mtl").read_text()
    from dreamwaltz_g_tpu_torch.utils.media import load_image

    got = load_image(str(tmp_path / "port" / "albedo.png"))
    want = load_image(str(tmp_path / "jax" / "albedo.png"))
    assert got.shape == (64, 64, 3) and got.std() > 0
    # the PNG's 8 bits: a value within 1e-5 can round across a level
    assert np.abs(got - want).max() <= 1.0 / 255.0 + 1e-6
    monkeypatch.undo()
    with pytest.raises(ValueError, match="empty isosurface"):
        TM.export_textured_mesh(tmodel, str(tmp_path / "none"),
                                resolution=8, density_thresh=1e9)


MODES = {"train": [], "full_eval": ["--log.eval_only", "true"],
         "pretrain": ["--log.pretrain_only", "true"],
         "pretrain_nerf2gs": ["--log.nerf2gs", "true"],
         "export_mesh": ["--log.nerf2mesh", "true"]}


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_dispatch_matches_jax(monkeypatch, mode, resume):
    """``main.run`` builds the trainer, restores it under
    ``--optim.resume`` (a missing checkpoint is not an error) and calls
    the mode's method, as the JAX ``main.run`` does."""
    import importlib.util
    from pathlib import Path

    from dreamwaltz_g_tpu.configs import parse_args as jparse
    from dreamwaltz_g_tpu.training import trainer as JT
    from dreamwaltz_g_tpu_torch import main as TMain
    from dreamwaltz_g_tpu_torch.configs import parse_args
    from dreamwaltz_g_tpu_torch.training import trainer as TT

    def recorder(calls):
        class Stub:
            def __init__(self, cfg):
                calls.append("init")

            def load_checkpoint(self):
                calls.append("load_checkpoint")
                raise FileNotFoundError

        for name in MODES:
            setattr(Stub, name, lambda self, n=name: calls.append(n))
        return Stub

    tcalls, jcalls = [], []
    monkeypatch.setattr(TT, "Trainer", recorder(tcalls))
    monkeypatch.setattr(JT, "Trainer", recorder(jcalls))
    stage = "nerf" if mode in ("pretrain", "export_mesh") else "gs"
    argv = ["--stage", stage, "--optim.resume", str(resume).lower(),
            *MODES[mode]]
    spec = importlib.util.spec_from_file_location(
        "jax_main", Path(__file__).resolve().parents[1] / "main.py")
    jmain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmain)
    jmain.run(jparse(argv))
    cfg = parse_args(argv)
    TMain.run(cfg)
    # --log.eval_only restores whatever --optim.resume says
    assert tcalls == jcalls == ["init"] + ["load_checkpoint"] * int(
        cfg.optim.resume) + [mode]
    assert cfg.optim.resume == (resume or mode == "full_eval")


@pytest.mark.parametrize("colors", [False, True])
def test_save_obj_matches_jax(sphere_mesh, tmp_path, colors):
    v, f = sphere_mesh
    c = np.random.default_rng(2).uniform(size=v.shape).astype(np.float32) \
        if colors else None
    JI.save_obj(str(tmp_path / "jax" / "m.obj"), v, f, c)
    out = TI.save_obj(str(tmp_path / "port" / "m.obj"), v, f, c)
    assert open(out).read() == open(tmp_path / "jax" / "m.obj").read()

"""The DMTet module of the port (``nerf/dmtet.py``) and the mesh losses of
``training/losses.py`` against the JAX package, on the CPU.

The field is a triplane (16^2 x 8, bound 1, the Gaussian density prior)
on both sides, its weights the JAX ones (``convert.nerf_state_from_numpy``):
the JAX DMTet tests' tiled grid is not ported. Grids at resolution 12,
renders at 32^2.

Tolerances:
* the grid, the band of tets, the unique edges and every validity mask
  equal, to every index;
* forward values (the seeded SDF, the extracted vertices, shading, the
  regularisers, the splat render's image, alpha and depth) within 1e-5 of
  the largest entry (float32 in two frameworks);
* gradients within 2e-3 relative + 2e-4 of the largest entry (the port's
  whole-step envelope, ``ROADMAP.md`` queue C).

The render runs the JAX jnp table blend (no early stop) against the
port's plain train blend with a chunk as large as the tile capacity, so
the plain version's tile stop (at chunk boundaries) never acts.
``matrix_to_quat`` may pick a different one of its four candidates on a
near-tie; that is the same rotation, so images and gradients are held,
not quaternions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.nerf import dmtet as JD
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf.isosurface import TriangleSoup as JSoup
from dreamwaltz_g_tpu.training import losses as JL
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.nerf import dmtet as TD
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.nerf.isosurface import TriangleSoup
from dreamwaltz_g_tpu_torch.training import losses as TL
import tests.torch_threads  # noqa: F401  (per-worker threads)

FIELD = dict(triplane_resolution=16, triplane_dim=8, bound=1.0,
             density_prior="gaussian")
RES = 12
THRESH = 2.0
VAL_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4
H = W = 32
RASTER = dict(tile_size=8, capacity=256, chunk=256)


def _close(got, want, tol=VAL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, (err, peak)


def _grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all(), f"{name}: the JAX gradient is not finite"
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float((err - bound).max()))
    assert np.abs(want).max() > 0, name


@pytest.fixture(scope="module")
def field():
    jmodel = JN.build_nerf(JNeRFConfig(**FIELD), with_background=False)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = TN.build_nerf(NeRFConfig(**FIELD), with_background=False,
                           device="cpu")
    convert.nerf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def seeded(field):
    """Each package's grid fitted to the field and seeded from it."""
    jmodel, params, tmodel = field
    jm, jp = JD.DMTetModel.create(RES, 1.0).init_from_nerf(
        jmodel, params, density_thresh=THRESH, fit_scale=True)
    tm, tp = TD.DMTetModel.create(RES, 1.0).init_from_nerf(
        tmodel, density_thresh=THRESH, fit_scale=True)
    return jm, jp, tm, tp


@pytest.mark.parametrize("fit_scale", [False, True])
def test_create_and_init_from_nerf_match_jax(field, fit_scale):
    jmodel, params, tmodel = field
    j0, t0 = JD.DMTetModel.create(RES, 1.0), TD.DMTetModel.create(RES, 1.0)
    np.testing.assert_array_equal(t0.verts.numpy(), np.asarray(j0.verts))
    np.testing.assert_array_equal(t0.tets.numpy(), np.asarray(j0.tets))
    assert t0.deform_scale == j0.deform_scale and t0.bound == j0.bound
    jm, jp = j0.init_from_nerf(jmodel, params, density_thresh=THRESH,
                               fit_scale=fit_scale)
    tm, tp = t0.init_from_nerf(tmodel, density_thresh=THRESH,
                               fit_scale=fit_scale)
    _close(tm.verts.numpy(), jm.verts)
    np.testing.assert_allclose(tm.deform_scale, jm.deform_scale, rtol=1e-6)
    if fit_scale:     # the grid hugs the occupied region
        assert float(jnp.abs(jm.verts).max()) < 1.0
    sdf = np.asarray(jp.sdf)
    assert sdf.min() >= -1.0 and sdf.max() <= 1.0
    assert (sdf > 0).any() and (sdf <= 0).any()
    _close(tp.sdf.numpy(), sdf)
    np.testing.assert_array_equal(tp.sdf.numpy() > 0, sdf > 0)
    assert not tp.deform.any()


def test_band_and_edges_match_jax(seeded):
    jm, jp, tm, tp = seeded
    jb = jm.prune_to_surface_band(jp, dilate=3)
    tb = tm.prune_to_surface_band(tp, dilate=3)
    np.testing.assert_array_equal(tb.tets.numpy(), np.asarray(jb.tets))
    assert 0 < tb.tets.shape[0] < 6 * (RES - 1) ** 3
    je = JD.unique_tet_edges(jb.tets)
    te = TD.unique_tet_edges(tb.tets)
    np.testing.assert_array_equal(te, je)
    # a seed that cuts nothing keeps every tet
    flat = TD.DMTetParams(torch.ones_like(tp.sdf), tp.deform)
    assert tm.prune_to_surface_band(flat).tets.shape == tm.tets.shape


def _deform(n, seed=1, scale=0.5):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(
        np.float32) * scale


def _pair(seeded):
    """The JAX band and params with a random deform, and the port's twin
    (the JAX ones handed in)."""
    jm, jp, _, _ = seeded
    jb = jm.prune_to_surface_band(jp)
    jp = jp._replace(deform=jnp.asarray(_deform(jp.sdf.shape[0])))
    tb, tp = convert.dmtet_from_numpy(jb, jax.tree_util.tree_map(
        np.asarray, jp), device="cpu")
    return jb, jp, tb, tp


def test_extract_matches_jax(seeded):
    jb, jp, tb, tp = _pair(seeded)
    js, ts = jb.extract(jp), tb.extract(tp)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert int(ts.valid.sum()) > 50
    _close(ts.vertices.numpy(), js.vertices)


@pytest.mark.parametrize("shading", ["albedo", "normal", "textureless",
                                     "lambertian"])
def test_shade_soup_matches_jax(seeded, shading):
    jb, jp, tb, tp = _pair(seeded)
    js, ts = jb.extract(jp), tb.extract(tp)
    M = js.valid.shape[0]
    albedo = np.random.default_rng(2).uniform(size=(M, 3)).astype(np.float32)
    light = np.asarray([0.3, 0.8, 0.52], np.float32)
    light /= np.linalg.norm(light)
    want = JD.shade_soup(js, jnp.asarray(albedo), shading, jnp.asarray(light),
                         ambient_ratio=0.2)
    got = TD.shade_soup(ts, torch.as_tensor(albedo), shading,
                        torch.as_tensor(light), ambient_ratio=0.2)
    _close(got.numpy(), want)
    if shading != "albedo":
        assert float(np.asarray(want).std()) > 0


def test_normal_consistency_matches_jax():
    """On a soup of random triangle pairs (some slots invalid): the value
    and the gradient to the corners. On an extracted surface the term is 0
    up to rounding (see the next test), so it is held here."""
    rng = np.random.default_rng(8)
    tris = rng.normal(size=(2 * 40, 3, 3)).astype(np.float32)
    valid = rng.uniform(size=80) > 0.2
    tris[~valid] = 0.0
    want, jg = jax.value_and_grad(lambda v: JD.soup_normal_consistency(
        JSoup(v, jnp.asarray(valid))))(jnp.asarray(tris))
    v = torch.as_tensor(tris).requires_grad_(True)
    got = TD.soup_normal_consistency(TriangleSoup(v, torch.as_tensor(valid)))
    got.backward()
    assert float(want) > 0.1
    _close(float(got.detach()), float(want))
    _grad_close("vertices", v.grad.numpy(), jg)


def test_laplacian_and_gradients_match_jax(seeded):
    """``tet_laplacian_loss`` over the band's edges at the deformed
    vertices, its gradient to deform (sdf takes none). A tet's two
    triangles are the planar zero set of the SDF's affine interpolant, so
    ``soup_normal_consistency`` of the extracted surface is 0 up to float32
    rounding in both packages."""
    jb, jp, tb, tp = _pair(seeded)
    edges = JD.unique_tet_edges(jb.tets)

    def jloss(p):
        return JD.tet_laplacian_loss(
            jb.verts + jnp.tanh(p.deform) * jb.deform_scale,
            jnp.asarray(edges))

    jlap, jg = jax.value_and_grad(jloss)(jp)
    deform = tp.deform.clone().requires_grad_(True)
    p = TD.DMTetParams(tp.sdf, deform)
    lap = TD.tet_laplacian_loss(tb.deformed_verts(p), torch.as_tensor(edges))
    lap.backward()
    assert float(jlap) > 0
    _close(float(lap.detach()), float(jlap))
    _grad_close("deform", deform.grad.numpy(), jg.deform)
    assert float(JD.soup_normal_consistency(jb.extract(jp))) < 1e-6
    assert float(TD.soup_normal_consistency(tb.extract(tp))) < 1e-6


def test_render_splats_and_gradients_match_jax():
    """The twin of ``tests/test_isosurface.py``'s DMTet render test: a
    sphere with a small random deform at 32^2, image, alpha and depth, and
    the gradients of a loss on all three to sdf and deform."""
    jm = JD.DMTetModel.create(resolution=RES, bound=1.0)
    jp = jm.init_sphere(0.5)
    jm = jm.prune_to_surface_band(jp, dilate=1)
    jp = jp._replace(deform=jnp.asarray(_deform(jp.sdf.shape[0], 3, 0.3)))
    tm, tp = convert.dmtet_from_numpy(jm, jax.tree_util.tree_map(
        np.asarray, jp), device="cpu")
    cam = dict(radius=2.5, theta=70.0, phi=30.0, fovy=60.0)
    jc = jcamera(*cam.values(), H, W)
    tc = tcamera(*cam.values(), H, W, device="cpu")
    M = jm.tets.shape[0] * 2
    colors = np.random.default_rng(4).uniform(size=(M, 3)).astype(np.float32)
    wimg = np.random.default_rng(5).uniform(size=(H, W, 3)).astype(
        np.float32)

    def jrender(p):
        out = JD.render_dmtet_splats(
            jm.extract(p), jnp.asarray(colors), jc.extrinsic[0],
            jc.intrinsics[0], H, W, **RASTER)
        loss = jnp.sum(out.image * wimg) + jnp.sum(out.alpha) \
            + 0.1 * jnp.sum(out.depth)
        return loss, out

    (_, jout), jg = jax.value_and_grad(jrender, has_aux=True)(jp)
    sdf = tp.sdf.clone().requires_grad_(True)
    deform = tp.deform.clone().requires_grad_(True)
    out = TD.render_dmtet_splats(
        tm.extract(TD.DMTetParams(sdf, deform)), torch.as_tensor(colors),
        tc.extrinsic[0], tc.intrinsics[0], H, W, **RASTER)
    loss = torch.sum(out.image * torch.as_tensor(wimg)) \
        + torch.sum(out.alpha) + 0.1 * torch.sum(out.depth)
    loss.backward()
    assert float(jnp.mean(jout.alpha)) > 0.05
    for name in ("image", "alpha", "depth"):
        _close(getattr(out, name).detach().numpy(), getattr(jout, name))
    _grad_close("sdf", sdf.grad.numpy(), jg.sdf)
    _grad_close("deform", deform.grad.numpy(), jg.deform)


def _mesh():
    """A closed, slightly perturbed octahedron-like mesh: the marching
    surface of a sphere at resolution 6, welded."""
    from dreamwaltz_g_tpu.nerf import isosurface as JI

    verts, tets = JI.make_tet_grid(6, 1.0)
    sdf = 0.6 - np.linalg.norm(verts, axis=-1)
    v, f = JI.compact_mesh(JI.marching_tets(
        jnp.asarray(verts), jnp.asarray(sdf), jnp.asarray(tets)))
    v = v + np.random.default_rng(6).normal(size=v.shape).astype(
        np.float32) * 0.02
    return v.astype(np.float32), f


@pytest.mark.parametrize("loss", ["knn_offset", "knn_scale",
                                  "normal_consistency", "laplacian"])
def test_mesh_losses_match_jax(loss):
    v, f = _mesh()
    rng = np.random.default_rng(7)
    x = rng.normal(size=v.shape).astype(np.float32) * (
        0.05 if loss.startswith("knn") else 1.0)
    if loss == "knn_scale":
        x = np.abs(x) + 0.05
    adj = JL.face_adjacency_from_faces(f)
    np.testing.assert_array_equal(TL.face_adjacency_from_faces(f), adj)
    assert adj.shape[0] > 0

    def jfn(a):
        if loss == "knn_offset":
            return JL.KnnRegularizer.build(jnp.asarray(v)).offset_loss(a)
        if loss == "knn_scale":
            return JL.KnnRegularizer.build(jnp.asarray(v)).scale_loss(a)
        if loss == "normal_consistency":
            return JL.normal_consistency_loss(jnp.asarray(v) + a,
                                              jnp.asarray(f), jnp.asarray(adj))
        return JL.laplacian_smoothing_loss(jnp.asarray(v) + a,
                                           jnp.asarray(f))

    def tfn(a):
        tv = torch.as_tensor(v)
        if loss == "knn_offset":
            return TL.KnnRegularizer.build(tv).offset_loss(a)
        if loss == "knn_scale":
            return TL.KnnRegularizer.build(tv).scale_loss(a)
        if loss == "normal_consistency":
            return TL.normal_consistency_loss(tv + a, torch.as_tensor(f),
                                              torch.as_tensor(adj))
        return TL.laplacian_smoothing_loss(tv + a, torch.as_tensor(f))

    jx = jnp.asarray(x if loss.startswith("knn") else x * 0.02)
    want, jg = jax.value_and_grad(jfn)(jx)
    a = torch.as_tensor(np.asarray(jx)).requires_grad_(True)
    got = tfn(a)
    got.backward()
    assert float(want) > 0
    _close(float(got.detach()), float(want))
    _grad_close(loss, a.grad.numpy(), jg)

"""Stage 1's parts in the port against the JAX package, on the CPU: the
field (``nerf/network.py``), the rays and camera helpers, the renderer
(occupancy grid, ``ray_aabb``, ``sample_pdf``, ``compact_samples``,
``render_rays``, the composite), the mesh sampling of the sigma guidance,
the losses, the optimizers and their schedules, and the 'ddpm' lr weights.

Weights are carried by ``convert.nerf_state_from_numpy``; draws are the
JAX package's, handed to the port. Tolerances: forward values within 1e-5
(absolute, on values of order 1, or relative where stated); gradients
within 1e-4 of the largest entry; index decisions (the compaction's
selection, the occupancy lookup, the search in ``sample_pdf``) equal bit
for bit; optimizer states after three updates within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data import camera as JC
from dreamwaltz_g_tpu.guidance.time_prior import TimePrioritizedLR as JTPLR
from dreamwaltz_g_tpu.guidance.time_prior import make_schedule as jschedule
from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model as jsmpl
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf import renderer as JR
from dreamwaltz_g_tpu.ops import mesh as JM
from dreamwaltz_g_tpu.training import losses as JLo
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.data import camera as TC
from dreamwaltz_g_tpu_torch.guidance.time_prior import TimePrioritizedLR
from dreamwaltz_g_tpu_torch.guidance.time_prior import make_schedule
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.nerf import renderer as TR
from dreamwaltz_g_tpu_torch.ops import mesh as TM
from dreamwaltz_g_tpu_torch.training import losses as TLo
from dreamwaltz_g_tpu_torch.training import optim as TO

FWD_TOL = 1e-5
GRAD_TOL_OF_MAX = 1e-4
FIELD = dict(triplane_resolution=16, triplane_dim=8, grid_size=16,
             num_steps=16, bound=1.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(**fields):
    """A JAX field, its parameters, and the port's twin."""
    fields = dict(FIELD, **fields)
    jmodel = JN.build_nerf(JNeRFConfig(**fields), with_background=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    params = params._replace(encoder=params.encoder._replace(
        planes=params.encoder.planes * 4.0))     # a field with contrast
    tmodel = TN.build_nerf(NeRFConfig(**fields), device="cpu")
    convert.nerf_state_from_numpy(_np(params), tmodel)
    return jmodel, params, tmodel


def _torch_grads(tmodel):
    return {n: p.grad.numpy() for n, p in tmodel.named_parameters()
            if p.grad is not None}


def _jax_grad_named(grads):
    """The JAX gradient tree under the port's parameter names."""
    out = {"planes": np.asarray(grads.encoder.planes)}
    if grads.encoder_sigma is not None:
        out["planes_sigma"] = np.asarray(grads.encoder_sigma.planes)
    if grads.sigma_scale is not None:
        out["sigma_scale"] = np.asarray(grads.sigma_scale)
    for mlp in ("sigma_mlp", "albedo_mlp", "bg_mlp"):
        tree = getattr(grads, mlp)
        if tree is None:
            continue
        for lname, leaf in tree["params"].items():
            out[f"{mlp}.{lname}.weight"] = np.asarray(leaf["kernel"]).T
            out[f"{mlp}.{lname}.bias"] = np.asarray(leaf["bias"])
    return out


def _check_grads(tmodel, jgrads, names=None):
    want = _jax_grad_named(jgrads)
    got = _torch_grads(tmodel)
    for name in names or want:
        w = want[name]
        g = got.get(name, np.zeros_like(w))
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL_OF_MAX * scale, name


def test_trunc_exp_clamps_its_backward():
    x = np.linspace(-30, 30, 61).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(JN.trunc_exp(a)))(x)
    tx = torch.tensor(x, requires_grad=True)
    tv = TN.trunc_exp(tx)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.exp(x), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6)
    assert float(tx.grad.max()) == pytest.approx(np.exp(15.0), rel=1e-6)


@pytest.mark.parametrize("kind", ["none", "gaussian", "sqrt"])
def test_density_prior_matches_jax(kind):
    pts = np.random.default_rng(0).uniform(-2, 2, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TN.density_prior(kind, _t(pts), 2.0).numpy(),
        np.asarray(JN.density_prior(kind, pts, 2.0)), rtol=FWD_TOL,
        atol=FWD_TOL)


@pytest.mark.parametrize("structure,activation,prior", [
    ("shared_mlp", "exp", "none"), ("dual_mlp", "softplus", "gaussian"),
    ("dual_enc", "scaling", "sqrt")])
def test_field_density_and_gradients_match_jax(structure, activation, prior):
    """``NeRFModel.density`` (sigma, albedo) and the gradient of a random
    projection of both with respect to every weight, over points inside
    and outside the bound."""
    jmodel, params, tmodel = _pair(structure=structure,
                                   density_activation=activation,
                                   density_prior=prior)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)
    cs = rng.normal(size=(200,)).astype(np.float32)
    ca = rng.normal(size=(200, 3)).astype(np.float32)

    def f(p):
        s, a = jmodel.density(p, pts)
        return jnp.sum(s * cs) + jnp.sum(a * ca), (s, a)

    (_, (js, ja)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    ts, ta = tmodel.density(_t(pts))
    (torch.sum(ts * _t(cs)) + torch.sum(ta * _t(ca))).backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               atol=FWD_TOL)
    _check_grads(tmodel, jg)


def test_background_matches_jax():
    jmodel, params, tmodel = _pair()
    d = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(tmodel.background(_t(d)).detach().numpy(),
                               np.asarray(jmodel.background(params, d)),
                               atol=FWD_TOL)


def test_get_rays_and_camera_helpers_match_jax():
    """Rays (pixel centres at +0.5, the negative fy), the screen matrix, the
    NDC depth helpers and the batch's full projection and position."""
    H, W = 12, 16
    jc = JC.make_camera_batch([2.5, 3.0], [30.0, 200.0], [80.0, 60.0],
                              [50.0, 40.0], H, W)
    tc = TC.make_camera_batch([2.5, 3.0], [30.0, 200.0], [80.0, 60.0],
                              [50.0, 40.0], H, W, device="cpu")
    jo, jd = JC.get_rays(jc.c2w, jc.intrinsics, H, W)
    to, td = TC.get_rays(tc.c2w, tc.intrinsics, H, W)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=FWD_TOL)
    np.testing.assert_allclose(tc.full_projection.numpy(),
                               np.asarray(jc.full_projection), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tc.campos.numpy(), np.asarray(jc.campos),
                               atol=FWD_TOL)
    for flip in (False, True):
        np.testing.assert_array_equal(
            TC.to_screen(2, H, W, flip, device="cpu").numpy(),
            np.asarray(JC.to_screen(2, H, W, flip)))
    depth = np.linspace(0.5, 50.0, 20).astype(np.float32)
    ndc = TC.depth_to_ndc_depth(_t(depth), 0.01, 100.0)
    np.testing.assert_allclose(
        ndc.numpy(), np.asarray(JC.depth_to_ndc_depth(depth, 0.01, 100.0)),
        rtol=FWD_TOL)
    np.testing.assert_allclose(
        TC.ndc_depth_to_depth(ndc, 0.01, 100.0).numpy(),
        np.asarray(JC.ndc_depth_to_depth(np.asarray(ndc), 0.01, 100.0)),
        rtol=FWD_TOL)


def test_ray_aabb_and_occupancy_lookup_match_jax():
    """Slab near / far with axis-parallel directions (the 1e-9 clamp) and
    misses; the occupancy lookup's truncated indices on and off cell
    boundaries, equal bit for bit."""
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:8, 0] = 0.0
    d[8:12, 1] = -0.0
    d[12:16] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jn, jf, jh = JR.ray_aabb(o, d, 2.0, 0.1)
    tn, tf, th = TR.ray_aabb(_t(o), _t(d), 2.0, 0.1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 0 < int(th.sum()) < 64
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=FWD_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=FWD_TOL)

    G = 16
    occ = rng.uniform(size=(G, G, G)) < 0.5
    jgrid = JR.OccupancyGrid(jnp.zeros((G, G, G)), jnp.asarray(occ),
                             jnp.zeros(()))
    tgrid = TR.OccupancyGrid(torch.zeros((G, G, G)), _t(occ),
                             torch.zeros(()))
    pts = np.concatenate([
        rng.uniform(-2.2, 2.2, (500, 3)),
        (rng.integers(0, G + 1, (100, 3)) / G * 4.0 - 2.0)]).astype(
            np.float32)                          # on the cell boundaries
    np.testing.assert_array_equal(
        TR.occupancy_lookup(tgrid, _t(pts), 2.0).numpy(),
        np.asarray(JR.occupancy_lookup(jgrid, pts, 2.0)))


def test_update_occupancy_matches_jax():
    """The EMA refresh from the same cell jitter: densities within 1e-5
    relative, the same occupied cells and mean."""
    jmodel, params, tmodel = _pair()
    G = FIELD["grid_size"]
    key = jax.random.PRNGKey(5)
    jitter = jax.random.uniform(key, (G ** 3, 3), minval=-0.5, maxval=0.5)
    jgrid = JR.init_occupancy(G)
    tgrid = TR.init_occupancy(G, device="cpu")
    for _ in range(2):           # a second pass decays the first's EMA
        jgrid = JR.update_occupancy(jgrid, jmodel, params, key,
                                    chunk=1000)
        tgrid = TR.update_occupancy(tgrid, tmodel, jitter=_t(jitter),
                                    chunk=1000)
    np.testing.assert_allclose(tgrid.density.numpy(),
                               np.asarray(jgrid.density), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(tgrid.occupied.numpy(),
                                  np.asarray(jgrid.occupied))
    assert 0.05 < float(tgrid.occupied.float().mean()) < 0.95
    np.testing.assert_allclose(float(tgrid.mean_density),
                               float(jgrid.mean_density), rtol=FWD_TOL)


@pytest.mark.parametrize("drawn", [False, True])
def test_sample_pdf_matches_jax(drawn):
    """Inverse-CDF samples with the left-sided search, from the midpoints
    or from uniform draws (the JAX key's), on weights with empty bins."""
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(0.5, 3.0, (32, 17)), axis=-1).astype(
        np.float32)
    w = rng.uniform(size=(32, 16)).astype(np.float32)
    w[:, 3:7] = 0.0
    w[:4] = 0.0
    key = jax.random.PRNGKey(6) if drawn else None
    u = _t(jax.random.uniform(key, (32, 12))) if drawn else None
    np.testing.assert_allclose(
        TR.sample_pdf(_t(bins), _t(w), 12, u=u).numpy(),
        np.asarray(JR.sample_pdf(bins, w, 12, key)), rtol=FWD_TOL,
        atol=FWD_TOL)


def _compact_cases():
    rng = np.random.default_rng(7)
    S = 32
    live = rng.uniform(size=(64, S)) < 0.5
    live[0] = False                          # a dead ray
    live[1] = True                           # every sample occupied
    live[2] = False
    live[2, 0:3] = live[2, 20:23] = True     # two slabs with a gap
    live[3] = False
    live[3, -1] = True                       # the last sample only
    ts = np.cumsum(rng.uniform(0.01, 0.1, (64, S)), axis=-1).astype(
        np.float32)
    ts[4] = ts[4, 0]                          # equal depths on one ray
    return ts, live


@pytest.mark.parametrize("K", [4, 8, 16])
def test_compact_samples_selects_the_jax_samples_bit_for_bit(K):
    """The stable occupied-first selection, the strided subset of rays with
    more than K occupied samples (``K = 4, 8``), the depth re-sort and
    the stride: equal bit for bit, on rays with gaps, dead rays, full
    rays and equal depths."""
    ts, live = _compact_cases()
    j = JR.compact_samples(jnp.asarray(ts), jnp.asarray(live), K)
    t = TR.compact_samples(_t(ts), _t(live), K)
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (live.sum(-1) > K).any() and (live.sum(-1) <= K).any()


@pytest.mark.parametrize("opts", [
    dict(compact_steps=8),
    dict(compact_steps=8, upsample_steps=8),
    dict(shading="lambertian"),
    dict(shading="normal", return_normals=True),
], ids=["compact", "compact_upsample", "lambertian", "normal"])
def test_render_rays_matches_jax(opts):
    """``render_rays`` through the occupancy pre-pass, the stratified
    jitter (the JAX key's draws), compaction, the importance pass and the
    shading modes: image, depth and weights within 1e-5, the gradient of a
    random projection of them within 1e-4 of the largest entry."""
    jmodel, params, tmodel = _pair()
    G = FIELD["grid_size"]
    rng = np.random.default_rng(8)
    occ = rng.uniform(size=(G, G, G)) < 0.6
    jgrid = JR.OccupancyGrid(jnp.zeros((G, G, G)), jnp.asarray(occ),
                             jnp.zeros(()))
    tgrid = TR.OccupancyGrid(torch.zeros((G, G, G)), _t(occ),
                             torch.zeros(()))
    R, S = 48, FIELD["num_steps"]
    o = np.tile([[0.0, 0.2, -2.5]], (R, 1)).astype(np.float32)
    d = (rng.normal(size=(R, 3)) * 0.15 + [0.0, 0.0, 1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    jitter = jax.random.uniform(key, (R, S))
    pdf_u = jax.random.uniform(jax.random.fold_in(key, 1),
                               (R, opts.get("upsample_steps", 1)))
    c_img = rng.normal(size=(R, 3)).astype(np.float32)
    c_dep = rng.normal(size=(R,)).astype(np.float32)

    def f(p):
        out = JR.render_rays(jmodel, p, jgrid, o, d, key=key, num_steps=S,
                             perturb=True, **opts)
        return (jnp.sum(out.image * c_img) + jnp.sum(out.depth * c_dep)
                + jnp.sum(out.weights_sum)), out

    vg = jax.value_and_grad(f, has_aux=True)
    if "shading" not in opts:
        # the shaded cases run op by op, as the port does: their finite-
        # difference normals divide rounding by eps = 5e-3, and XLA's
        # fusions move the JAX package's own plane gradient by 1.6e-3
        # (lambertian) and 4.9e-3 (normal) of its largest entry
        vg = jax.jit(vg)
    (_, jout), jg = vg(params)
    tout = TR.render_rays(tmodel, tgrid, _t(o), _t(d), jitter=_t(jitter),
                          num_steps=S, perturb=True, pdf_u=_t(pdf_u), **opts)
    (torch.sum(tout.image * _t(c_img)) + torch.sum(tout.depth * _t(c_dep))
     + torch.sum(tout.weights_sum)).backward()
    for name in ("image", "depth", "weights_sum", "normals"):
        want = getattr(jout, name)
        if want is None:
            continue
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=name)
    assert 0.05 < float(tout.weights_sum.detach().mean()) < 0.99
    _check_grads(tmodel, jg, ["planes"] + [
        n for n in _jax_grad_named(jg) if n.startswith("sigma_mlp")])


def test_composite_weights_and_background_gradients_match_jax():
    """The exclusive cumprod of (1 - alpha + 1e-10) and the background
    composite (with and without the detached weights sum): values and the
    gradients with respect to sigma and the colours."""
    rng = np.random.default_rng(10)
    sigma = rng.uniform(0, 30, (16, 24)).astype(np.float32)
    sigma[:, ::5] = 0.0
    dt = rng.uniform(0.01, 0.1, (16, 1)).astype(np.float32)
    img = rng.uniform(size=(16, 3)).astype(np.float32)
    bg = rng.uniform(size=(3,)).astype(np.float32)
    cw = rng.normal(size=(16, 24)).astype(np.float32)
    ci = rng.normal(size=(16, 3)).astype(np.float32)
    for detach in (False, True):
        def f(s, im):
            w = JR._composite_weights(s, dt)
            out = JR.composite_background(im, jnp.sum(w, -1), bg, detach)
            return jnp.sum(w * cw) + jnp.sum(out * ci), w

        (_, jw), (js, ji) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(sigma, img)
        ts = torch.tensor(sigma, requires_grad=True)
        ti = torch.tensor(img, requires_grad=True)
        tw = TR._composite_weights(ts, _t(dt))
        out = TR.composite_background(ti, tw.sum(-1), _t(bg), detach)
        (torch.sum(tw * _t(cw)) + torch.sum(out * _t(ci))).backward()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                                   atol=FWD_TOL)
        for got, want in ((ts.grad, js), (ti.grad, ji)):
            want = np.asarray(want)
            assert float(np.abs(got.numpy() - want).max()) \
                <= GRAD_TOL_OF_MAX * float(np.abs(want).max())


def test_sparsity_losses_match_jax():
    """opacity, entropy, emptiness, their weighted sum before and after the
    late-stage multiplier, and the orientation loss."""
    rng = np.random.default_rng(11)
    ws = rng.uniform(0, 1, (256,)).astype(np.float32)
    cfg = dict(lambda_opacity=0.3, lambda_entropy=0.2, lambda_emptiness=1e-4,
               sparsity_step=0.5)
    jcfg, tcfg = JNeRFConfig(**cfg), NeRFConfig(**cfg)
    for fn in ("opacity_loss", "entropy_loss", "emptiness_loss"):
        np.testing.assert_allclose(float(getattr(TLo, fn)(_t(ws))),
                                   float(getattr(JLo, fn)(ws)), rtol=FWD_TOL)
    for step in (0, 60):
        np.testing.assert_allclose(
            float(TLo.sparsity_loss(_t(ws), tcfg, step, 100)),
            float(JLo.sparsity_loss(ws, jcfg, step, 100)), rtol=FWD_TOL)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(TLo.orientation_loss(_t(ws), _t(n), _t(dirs))),
        float(JLo.orientation_loss(ws, n, dirs)), rtol=FWD_TOL)


def _vs_draws(key, b, n_surface):
    n_sh = 4096 // 2
    if n_surface is None:
        return TLo.VolumeSparsityDraws(uniform=_t(jax.random.uniform(
            key, (4096, 3), minval=-b, maxval=b)))
    k_u, k_pick, k_axis, k_coord = jax.random.split(key, 4)
    return TLo.VolumeSparsityDraws(*[_t(a) for a in (
        jax.random.uniform(k_u, (4096 - n_sh, 3), minval=-b, maxval=b),
        jax.random.randint(k_pick, (n_sh,), 0, n_surface),
        jax.random.randint(k_axis, (n_sh,), 0, 3),
        jax.random.uniform(k_coord, (n_sh, 1), minval=-b, maxval=b),
        jax.random.uniform(k_pick, (n_sh, 3), minval=-b, maxval=b))])


@pytest.mark.parametrize("surface", ["none", "all_valid", "masked"])
def test_volume_sparsity_loss_matches_jax(surface):
    """The Cauchy prior at uniform points and at the surface points' axis
    shadows (invalid ones falling back to uniform points), from the JAX
    key's draws: the loss and its gradient."""
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(12)
    surf = valid = None
    if surface != "none":
        surf = rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32)
        valid = np.ones(300, bool) if surface == "all_valid" \
            else rng.uniform(size=300) < 0.5
    key = jax.random.PRNGKey(13)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JLo.volume_sparsity_loss(
        jmodel, p, key, surface_points=None if surf is None
        else jnp.asarray(surf), surface_valid=None if valid is None
        else jnp.asarray(valid))))(params)
    draws = _vs_draws(key, 1.0, None if surf is None else 300)
    tl = TLo.volume_sparsity_loss(
        tmodel, draws, None if surf is None else _t(surf),
        None if valid is None else _t(valid))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=FWD_TOL)
    _check_grads(tmodel, jg, ["planes", "sigma_mlp.dense_0.weight"])


def test_sigma_guidance_points_and_mesh_sampling_match_jax():
    """``sample_mesh_surface`` from the JAX key's face and uniform draws,
    ``vertex_normals``, and ``make_sigma_guidance_points``."""
    smpl = jsmpl(num_vertices=120, num_joints=6, seed=0)
    v = np.asarray(smpl.v_template, np.float32)
    faces = np.asarray(smpl.faces)
    np.testing.assert_allclose(
        TM.vertex_normals(_t(v), faces).numpy(),
        np.asarray(JM.vertex_normals(jnp.asarray(v), jnp.asarray(faces))),
        atol=FWD_TOL)
    key = jax.random.PRNGKey(14)
    jpts, jf = JM.sample_mesh_surface(key, jnp.asarray(v),
                                      jnp.asarray(faces), 100)
    k1, k2 = jax.random.split(key)
    tri = v[faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                         tri[:, 2] - tri[:, 0]), axis=-1)
    fidx = jax.random.categorical(
        k1, jnp.log(jnp.maximum(jnp.asarray(area), 1e-20))[None],
        shape=(1, 100))[0]
    u = jax.random.uniform(k2, (100, 2))
    np.testing.assert_array_equal(np.asarray(fidx), np.asarray(jf))
    tpts, tf = TM.sample_mesh_surface(_t(v), faces, 100, fidx=_t(fidx),
                                      u=_t(u))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=FWD_TOL)

    jsp = JLo.make_sigma_guidance_points(key, jnp.asarray(v),
                                         jnp.asarray(faces), num_points=100)
    ka, kb = jax.random.split(key)
    ks1, ks2 = jax.random.split(ka)
    fidx = jax.random.categorical(
        ks1, jnp.log(jnp.maximum(jnp.asarray(area), 1e-20))[None],
        shape=(1, 100))[0]
    tsp = TLo.make_sigma_guidance_points(
        _t(v), faces, 100, fidx=_t(fidx), u=_t(jax.random.uniform(
            ks2, (100, 2))), noise_u=_t(jax.random.uniform(kb, (100, 1))))
    for got, want in zip(tsp, jsp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_TOL)
    gen = torch.Generator().manual_seed(0)       # the port's own draws
    own = TLo.make_sigma_guidance_points(_t(v), faces, 100, generator=gen)
    assert own.surface.shape == own.offset.shape == (100, 3)


@pytest.mark.parametrize("loss_type", ["margin", "mse", "opacity_mse"])
def test_sigma_margin_loss_matches_jax(loss_type):
    jmodel, params, tmodel = _pair(structure="dual_mlp")
    rng = np.random.default_rng(15)
    pts = TLo.SigmaGuidancePoints(
        surface=rng.uniform(-0.9, 0.9, (80, 3)).astype(np.float32),
        offset=rng.uniform(-0.9, 0.9, (80, 3)).astype(np.float32))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JLo.sigma_margin_loss(
        jmodel, p, JLo.SigmaGuidancePoints(*pts), peak=2.0,
        loss_type=loss_type)))(params)
    tl = TLo.sigma_margin_loss(
        tmodel, TLo.SigmaGuidancePoints(*[_t(p) for p in pts]), peak=2.0,
        loss_type=loss_type)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=FWD_TOL)
    _check_grads(tmodel, jg, ["planes", "sigma_mlp.dense_0.weight",
                              "sigma_mlp.dense_2.bias"])


def _three_updates(jtx, ttx_state, params, tmodel, scale=1.0):
    """Three updates from random gradients in both packages."""
    state = jtx.init(params)
    rng = np.random.default_rng(16)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=np.shape(a)) * scale * (i + 1)
                       ).astype(np.float32), params)
        if i == 1:     # a group without a gradient: zeros in optax
            grads = grads._replace(bg_mlp=jax.tree_util.tree_map(
                np.zeros_like, grads.bg_mlp))
        upd, state = jtx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        named = _jax_grad_named(grads)
        for name, p in tmodel.named_parameters():
            p.grad = None if (i == 1 and name.startswith("bg_mlp")) \
                else torch.as_tensor(named[name])
        ttx_state.step()
    return params


@pytest.mark.parametrize("optimizer,policy", [
    ("adam", "constant"), ("adam", "cosine"), ("adan", "multistep")])
def test_nerf_optimizer_matches_optax(optimizer, policy):
    """``build_nerf_optimizer``: the planes under AdamW (the plane decay)
    at 10x, the heads under Adam, the background at ``bg_lr``; or Adan at
    5x behind the global norm clip at 5 (gradients scaled to ~100 so that
    it acts); three updates, the learning rate scheduled."""
    jmodel, params, tmodel = _pair()
    fields = dict(FIELD, optimizer=optimizer, lr_policy=policy)
    jtx = JO.build_nerf_optimizer(JNeRFConfig(**fields), 4)
    state = TO.build_nerf_optimizer(NeRFConfig(**fields), 4).init(tmodel)
    want = _three_updates(jtx, state, params, tmodel,
                          scale=3.0 if optimizer == "adan" else 1.0)
    got = {n: p.detach().numpy() for n, p in tmodel.named_parameters()}
    for name, w in _jax_grad_named(want).items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_make_optimizer_adamw_matches_optax():
    """``make_optimizer('adamw', lr)`` at optax's defaults, over a list."""
    rng = np.random.default_rng(17)
    p = rng.normal(size=(5, 7)).astype(np.float32)
    jtx = JO.make_optimizer("adamw", 1e-2)
    st = jtx.init(p)
    rule = TO.make_optimizer("adamw", 1e-2)
    tp = torch.tensor(p)
    tst = rule.init([tp])
    jp = p
    for _ in range(3):
        g = rng.normal(size=p.shape).astype(np.float32)
        u, st = jtx.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
        tp.add_(rule.update([torch.tensor(g)], tst, [tp])[0])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("policy", ["constant", "ddpm", "cosine", "step",
                                    "multistep", "warmup", "lambda"])
def test_nerf_lr_schedules_match_jax(policy):
    """Every policy at the steps where it turns, within 1e-6 relative or
    1e-6 of the base rate (the JAX schedules compute in float32: near the
    cosine's end, 1 + cos(pi t / T) is a few ulps)."""
    ac = np.asarray(jschedule().alphas_cumprod)
    j = JO.nerf_lr_schedule(policy, 1e-3, 3000, alphas_cumprod=ac)
    t = TO.nerf_lr_schedule(policy, 1e-3, 3000, alphas_cumprod=ac)
    for s in (0, 1, 999, 1000, 2099, 2100, 3149, 3150, 3674, 3675, 2999,
              3000, 3500):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(s))


def test_time_prioritized_lr_weights_match_jax():
    j = JTPLR(jschedule())
    t = TimePrioritizedLR(make_schedule(device="cpu"))
    np.testing.assert_array_equal(t.weights, j.weights)
    for ts in (-5, 0, 500, 999, 2000):
        assert t(ts) == j(ts)

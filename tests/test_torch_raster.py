"""Parity of the port's rasterizer against the JAX package: projection,
sorted binning, and the sorted tile blend's plain version against the
Pallas kernel (interpret mode, as ``tests/test_rasterize.py`` runs it) and
against the per-pixel oracle. The CUDA kernel itself runs only on the card
(``tests/test_torch_blend_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch
from dreamwaltz_g_tpu.ops import rasterize as JR
from dreamwaltz_g_tpu.utils.transforms import quat_normalize
from dreamwaltz_g_tpu_torch.ops import blend as TB
from dreamwaltz_g_tpu_torch.ops import rasterize as TR
import tests.torch_threads  # noqa: F401  (per-worker threads)


def _scene(rng, n, spread=0.5, scale=0.05, opacity=(0.3, 0.95)):
    means3d = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    quats = np.array(quat_normalize(jnp.asarray(
        rng.normal(size=(n, 4)), jnp.float32)))
    scales = (np.exp(rng.normal(size=(n, 3)) * 0.3) * scale).astype(np.float32)
    opac = rng.uniform(*opacity, size=(n,)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    return means3d, quats, scales, opac, colors


def _project_both(rng, H, W, n, **scene_kw):
    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W)
    means3d, quats, scales, opac, colors = _scene(rng, n, **scene_kw)
    extr, intr, tf = (np.array(x[0]) for x in (cam.extrinsic,
                                                  cam.intrinsics, cam.tanfov))
    jg = JR.project_gaussians(
        jnp.asarray(means3d), JR.covariance3d(jnp.asarray(quats),
                                              jnp.asarray(scales)),
        jnp.asarray(opac), jnp.asarray(colors), jnp.asarray(extr),
        jnp.asarray(intr), H, W, tanfov=jnp.asarray(tf))
    t = torch.as_tensor
    tg = TR.project_gaussians(
        t(means3d), TR.covariance3d(t(quats), t(scales)), t(opac), t(colors),
        t(extr), t(intr), H, W, tanfov=t(tf))
    return jg, tg


def _to_torch(g):
    """The JAX Gaussians2D as torch tensors (same values)."""
    return TR.Gaussians2D(*[torch.as_tensor(np.array(x)) for x in g])


def test_covariance_and_projection_match_jax():
    rng = np.random.default_rng(0)
    _, quats, scales, _, _ = _scene(rng, 64)
    np.testing.assert_allclose(
        np.asarray(JR.covariance3d(jnp.asarray(quats), jnp.asarray(scales))),
        TR.covariance3d(torch.as_tensor(quats), torch.as_tensor(scales)),
        atol=1e-7)
    jg, tg = _project_both(rng, 48, 64, n=200)
    np.testing.assert_array_equal(np.asarray(jg.mask), tg.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jg.radius), tg.radius.numpy())
    for name in ("means2d", "depth", "conic"):
        np.testing.assert_allclose(np.asarray(getattr(jg, name)),
                                   getattr(tg, name).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile_size,capacity,D", [(16, 64, 32), (16, 8, 16),
                                                  (8, 32, 8)])
def test_bin_gaussians_sorted_matches_jax(tile_size, capacity, D):
    rng = np.random.default_rng(1)
    H, W = 40, 56   # not tile multiples
    jg, _ = _project_both(rng, H, W, n=120)
    tg = _to_torch(jg)
    js, jstart, jcnt, jovf = JR.bin_gaussians_sorted(
        jg.means2d, jg.radius, jg.depth, jg.mask, H, W, tile_size, capacity, D)
    ts, tstart, tcnt, tovf = TR.bin_gaussians_sorted(
        tg.means2d, tg.radius, tg.depth, tg.mask, H, W, tile_size, capacity, D)
    np.testing.assert_array_equal(np.asarray(jstart), tstart.numpy())
    np.testing.assert_array_equal(np.asarray(jcnt), tcnt.numpy())
    assert float(jovf) == float(tovf)
    js = np.asarray(js)
    for t0, c in zip(tstart.tolist(), tcnt.tolist()):
        np.testing.assert_array_equal(js[t0: t0 + c], ts[t0: t0 + c].numpy())


def _rasterize_both(jg, H, W, **kw):
    j = JR.rasterize_projected(jg, H, W, use_pallas=True,
                               pallas_interpret=True, pallas_mode="eval", **kw)
    t = TR.rasterize_projected(_to_torch(jg), H, W, **kw)
    return j, t


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_plain_blend_matches_pallas_interpret(dense):
    """Plain version vs the TPU kernel run in interpret mode. 5e-3: the
    kernel's bf16 log-T prefix (about 0.4% of log T). The saturating scene
    drives pixels below T = 1e-4, so the tile-granular stop is exercised."""
    rng = np.random.default_rng(2)
    H, W = 64, 64
    kw = dict(tile_size=16, capacity=512, chunk=64, max_tiles_per_gaussian=16)
    if dense:
        jg, _ = _project_both(rng, H, W, n=300, spread=0.25, scale=0.08,
                              opacity=(0.9, 0.99))
    else:
        jg, _ = _project_both(rng, H, W, n=90)
    j, t = _rasterize_both(jg, H, W, **kw)
    if dense:
        assert float(t.alpha.max()) > 1.0 - 1e-4
    np.testing.assert_allclose(np.asarray(j.image), t.image.numpy(), atol=5e-3)
    np.testing.assert_allclose(np.asarray(j.alpha), t.alpha.numpy(), atol=5e-3)
    # depth lanes carry |value| up to ~3: the same relative bound
    np.testing.assert_allclose(np.asarray(j.depth), t.depth.numpy(),
                               atol=1.5e-2)
    assert float(j.overflow) == float(t.overflow)


def test_plain_blend_matches_per_pixel_oracle():
    """Plain version vs the JAX per-pixel oracle at the tolerance the JAX
    package holds its own tiled blend to (2e-5; depth 2e-4)."""
    rng = np.random.default_rng(3)
    H, W = 48, 64
    jg, _ = _project_both(rng, H, W, n=80)
    t = TR.rasterize_projected(_to_torch(jg), H, W, tile_size=16,
                               capacity=128, chunk=32,
                               max_tiles_per_gaussian=32)
    ref = np.asarray(JR.rasterize_reference(jg, H, W))
    np.testing.assert_allclose(t.image.numpy(), ref[..., :3], atol=2e-5)
    np.testing.assert_allclose(t.alpha.numpy(), ref[..., 4], atol=2e-5)
    np.testing.assert_allclose(t.depth.numpy(), ref[..., 3], atol=2e-4)
    # the port's oracle is the same function
    tref = TR.rasterize_reference(_to_torch(jg), H, W)
    np.testing.assert_allclose(tref.numpy(), ref, atol=1e-5)


def test_blend_stats_count_live_pairs():
    rng = np.random.default_rng(4)
    H = W = 32
    jg, _ = _project_both(rng, H, W, n=60)
    g = _to_torch(jg)
    s_idx, start, cnt, _ = TR.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, H, W, 16, 64, 16)
    vals = torch.cat([g.colors, g.depth[:, None], torch.ones(60, 1)], -1)
    stats = {}
    TB.blend_sorted_reference(s_idx, start, cnt, g.means2d, g.conic,
                              g.opacity * g.mask, vals, H, W, tile_size=16,
                              chunk=16, capacity=64, stats=stats)
    # nothing saturates here: every (pixel, segment entry) pair is live
    assert stats["pairs"] == int(cnt.sum()) * 16 * 16
    assert 0 < stats["blended"] < stats["pairs"]


def test_blend_wrapper_cpu_takes_plain_version():
    rng = np.random.default_rng(5)
    H = W = 32
    jg, _ = _project_both(rng, H, W, n=40)
    g = _to_torch(jg)
    s_idx, start, cnt, _ = TR.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, H, W, 16, 64, 16)
    vals = torch.cat([g.colors, g.depth[:, None], torch.ones(40, 1)], -1)
    args = (s_idx, start, cnt, g.means2d, g.conic, g.opacity * g.mask, vals,
            H, W)
    before = TB.blend_sorted.launches
    out = TB.blend_sorted(*args, tile_size=16, chunk=16, capacity=64)
    ref = TB.blend_sorted_reference(*args, tile_size=16, chunk=16,
                                    capacity=64)
    assert TB.blend_sorted.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError):
        TB.blend_sorted(*meta)

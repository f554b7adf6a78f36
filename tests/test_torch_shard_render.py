"""The Gaussian-sharded render (``parallel/shard_render.py``) and the
frame-parallel eval render (``make_avatar_render_frames(mesh=...)``) on two
``gloo`` ranks against the JAX package's on ``make_mesh(dp=2)``, on the
CPU.

The ranks are spawned with a join deadline and one intra-op thread each
(``tests/torch_ranks.py``); the JAX side runs in this process on the
conftest's virtual devices. Both scenes of ``tests/test_parallel.py``'s
sharded-render tests: 300 splats at 64^2, and 3,000 small splats whose
tiles hold more entries than their capacity (the row-block guard keeps
another block's splats from taking a block's capacity). Each rank returns
the whole frame, equal on both ranks to the bit; against the JAX sharded
render within the eval renders' 5e-3 (the JAX blend on the CPU walks the
(T, K) table with no early stop, the port the sorted segments with the
kernels' tile stop), and against the port's own unsharded render within
``test_parallel.py``'s tolerances. The frames: 4 animated frames over 2
ranks, each rank blending 2 of them, against JAX's within 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.human.smplx_model import SMPLXParams as JParams
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.parallel.mesh import make_mesh as jmake_mesh
from dreamwaltz_g_tpu.parallel.shard_render import make_sharded_render as \
    jsharded
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.human.smplx_model import SMPLXParams as TParams
from dreamwaltz_g_tpu_torch.ops import rasterize as R
from tests import torch_ranks as TR
import tests.torch_threads  # noqa: F401  (per-worker threads)

D = 2
H = W = 64
ATOL_E2E = 5e-3


def _scene(saturated):
    """``tests/test_parallel.py``'s two scenes: (the render's arguments as
    numpy, the camera's arguments, the raster settings, the JAX test's
    tolerance)."""
    if saturated:
        rng, N = np.random.default_rng(1), 3000
        positions = rng.uniform(-0.6, 0.6, (N, 3))
        scale, cam, bg = 0.015, (2.0, 25.0, 75.0, 50.0), 0.1
        raster = dict(tile_size=8, capacity=64, chunk=32,
                      max_tiles_per_gaussian=8)
        tol = 3e-3
    else:
        rng, N = np.random.default_rng(0), 300
        positions = rng.normal(size=(N, 3)) * 0.3
        scale, cam, bg = 0.02, (2.0, 10.0, 80.0, 50.0), 0.25
        raster = dict(tile_size=16, capacity=512, chunk=64,
                      max_tiles_per_gaussian=16)
        tol = 2e-3
    f32 = np.float32
    quats = np.zeros((N, 4), f32)
    quats[:, 0] = 1.0
    opac = rng.uniform(0.2, 0.95, N) if saturated else rng.uniform(0.3, 0.9,
                                                                   N)
    args = [positions.astype(f32), quats, np.full((N, 3), scale, f32),
            opac.astype(f32), rng.uniform(0, 1, (N, 3)).astype(f32),
            np.ones((N,), bool)]
    return args, cam, np.full((H, W, 3), bg, f32), raster, tol


@pytest.mark.parametrize("saturated", [False, True],
                         ids=["plain", "saturated"])
def test_sharded_render_matches_jax(tmp_path, saturated):
    args, cam_args, bg, raster, tol = _scene(saturated)
    jc = jcamera(*cam_args, H, W)
    tc = tcamera(*cam_args, H, W, device="cpu")
    want = jsharded(jmake_mesh(dp=D), H, W, **raster)(
        *[jnp.asarray(a) for a in args], jc.extrinsic[0], jc.intrinsics[0],
        jc.tanfov[0], jnp.asarray(bg))
    targs = [torch.as_tensor(a) for a in args] + [
        tc.extrinsic[0], tc.intrinsics[0], tc.tanfov[0], torch.as_tensor(bg)]
    path = TR.save(tmp_path / "scene.pt", dict(H=H, W=W, raster=raster,
                                               args=targs))
    ranks = TR.run_ranks(TR.sharded_render, D, path)
    assert TR.state_equal(ranks[0], ranks[1])
    img, alpha, depth, _ = ranks[0]
    assert img.shape == (H, W, 3) and alpha.shape == depth.shape == (H, W)
    assert alpha.max() > 0.5
    np.testing.assert_allclose(img, np.asarray(want[0]), atol=ATOL_E2E)
    np.testing.assert_allclose(alpha, np.asarray(want[1]), atol=ATOL_E2E)
    # the port's own unsharded render, at the JAX test's tolerance
    p, q, s, o, c, alive = targs[:6]
    g2d = R.project_gaussians(p, R.covariance3d(q, s), o, c, *targs[6:8],
                              H, W, tanfov=targs[8], alive=alive)
    ref = R.rasterize_projected(g2d, H, W, mode="eval", **raster)
    ref_img = ref.image + (1.0 - ref.alpha)[..., None] * targs[9]
    np.testing.assert_allclose(img, ref_img.numpy(), atol=tol)
    np.testing.assert_allclose(alpha, ref.alpha.numpy(), atol=tol)


def test_render_frames_over_two_ranks_match_jax(tmp_path):
    F, Hf = 4, 32
    raster = dict(tile_size=8, capacity=64, chunk=32)
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    tset = tts.tiny_avatar_setup(device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jset.state)
    tstate = avatar_state_from_numpy(tree, tset.model, device="cpu")
    rng = np.random.default_rng(4)
    fields = {k: np.zeros((F,) + np.shape(x), np.float32) for k, x in
              jts.default_params(jset.model.smpl, 1)._asdict().items()}
    fields["body_pose"] = (rng.normal(size=(F, 1, 63)) * 0.3).astype(
        np.float32)
    cam = ([2.5] * F, [0.0, 90.0, 180.0, 270.0], [80.0] * F, [55.0] * F)
    jc = jcamera(*cam, Hf, Hf, at_vector=((0, 0.7, 0),))
    tc = tcamera(*cam, Hf, Hf, at_vector=((0, 0.7, 0),), device="cpu")
    bg = np.full((Hf, Hf, 3), 0.3, np.float32)
    want = JG.make_avatar_render_frames(
        jset.model, Hf, Hf, mesh=jmake_mesh(dp=D), **raster)(
        jset.state, JParams(**{k: jnp.asarray(v) for k, v in
                               fields.items()}),
        jc.extrinsic, jc.intrinsics, jc.tanfov, jnp.asarray(bg))
    path = TR.save(tmp_path / "frames.pt", dict(
        model=tset.model, state=tstate, H=Hf, W=Hf, raster=raster,
        args=(TParams(**{k: torch.as_tensor(v) for k, v in fields.items()}),
              tc.extrinsic, tc.intrinsics, tc.tanfov, torch.as_tensor(bg))))
    ranks = TR.run_ranks(TR.render_frames, D, path)
    assert [r["blends"] for r in ranks] == [F // D] * D
    assert TR.state_equal(ranks[0]["frames"], ranks[1]["frames"])
    imgs, alphas, _ = ranks[0]["frames"]
    assert imgs.shape == (F, Hf, Hf, 3) and alphas.max() > 0.5
    np.testing.assert_allclose(imgs, np.asarray(want[0]), atol=ATOL_E2E)
    np.testing.assert_allclose(alphas, np.asarray(want[1]), atol=ATOL_E2E)
    # the frames differ from one another: each rank rendered its own
    assert np.abs(imgs[0] - imgs[F - 1]).max() > 0.05

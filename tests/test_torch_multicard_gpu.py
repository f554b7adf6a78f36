"""The multi-card half on the card: two ``gloo`` ranks on card 0 (NCCL
refuses two ranks on one device), spawned with a join deadline
(``tests/torch_ranks.py``), against the same calls in one process on the
card.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_multicard_gpu.py -m gpu --noconftest -q

* tp = 2: the tiny guidance in float32 at 32^2 latents (its top level's
  self-attentions, 1,024 tokens, take flash), one head a rank: the UNet's
  eps with the ControlNet's residuals on each rank against the unsharded
  stack's, within 1e-4 of the largest |eps| (the row-parallel sums add in
  another order), flash launched on each rank;
* the Gaussian-sharded render of 20,000 splats at 256^2 over the two
  ranks: B2 once a rank, the whole frame on both ranks, against the
  unsharded render within B2's plain-version tolerance (5e-3);
* the frames: 4 frames of the tiny avatar over the two ranks, B2 twice a
  rank, against the one-process frames within 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch

# by path: under --noconftest another installed ``tests`` package may
# shadow this directory's, and the spawned ranks import it by this name
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks as TR  # noqa: E402

pytestmark = pytest.mark.gpu

TOL_RGB_ALPHA = 5e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_tp2_eps_on_the_card(tmp_path):
    from dreamwaltz_g_tpu_torch import tests_support as tts

    dev = _card()
    sd, gp = tts.tiny_guidance(0, with_controlnet=True, latent_size=32,
                               device=dev)
    gen = torch.Generator().manual_seed(2)
    x = dict(lat=torch.randn((2, 32, 32, 4), generator=gen),
             t=torch.tensor([300, 701]),
             ctx=torch.randn((2, 4, 32), generator=gen),
             cond=torch.rand((2, 64, 64, 3), generator=gen))
    x = {k: v.to(dev) for k, v in x.items()}
    with torch.no_grad():
        want = sd._eps(gp, *x.values()).cpu().numpy()
    path = TR.save(tmp_path / "eps.pt", dict(sd=sd, gp=gp, device=dev, **x))
    for r in TR.run_ranks(TR.tp_eps, 2, path, cuda=True):
        assert r["heads"] == [1] and r["flash"] > 0
        np.testing.assert_allclose(r["eps"], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_sharded_render_on_the_card(tmp_path):
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import blend
    from dreamwaltz_g_tpu_torch.ops import rasterize as R

    dev = _card()
    S, N = 256, 20_000
    raster = dict(tile_size=16, capacity=256, chunk=64,
                  max_tiles_per_gaussian=16)
    gen = torch.Generator().manual_seed(1)
    quats = torch.zeros((N, 4))
    quats[:, 0] = 1.0
    args = [torch.rand((N, 3), generator=gen) * 1.2 - 0.6, quats,
            torch.full((N, 3), 0.01), torch.rand(N, generator=gen) * 0.8
            + 0.1, torch.rand((N, 3), generator=gen),
            torch.ones(N, dtype=torch.bool)]
    cam = make_camera_batch(2.0, 25.0, 75.0, 50.0, S, S, device=dev)
    args = [a.to(dev) for a in args] + [
        cam.extrinsic[0], cam.intrinsics[0], cam.tanfov[0],
        torch.full((S, S, 3), 0.1, device=dev)]
    p, q, s, o, c, alive = args[:6]
    g2d = R.project_gaussians(p, R.covariance3d(q, s), o, c, *args[6:8], S,
                              S, tanfov=args[8], alive=alive)
    blend.blend_sorted.launches = 0
    ref = R.rasterize_projected(g2d, S, S, mode="eval", **raster)
    assert blend.blend_sorted.launches == 1
    ref_img = (ref.image + (1.0 - ref.alpha)[..., None] * args[9]).cpu()
    path = TR.save(tmp_path / "scene.pt", dict(H=S, W=S, raster=raster,
                                               args=args, device=dev))
    ranks = TR.run_ranks(TR.sharded_render, 2, path, cuda=True)
    assert TR.state_equal(ranks[0], ranks[1])
    img, alpha, _, launches = ranks[0]
    assert launches == 1 and float(alpha.max()) > 0.5
    np.testing.assert_allclose(img, ref_img.numpy(), atol=TOL_RGB_ALPHA)
    np.testing.assert_allclose(alpha, ref.alpha.cpu().numpy(),
                               atol=TOL_RGB_ALPHA)


def test_frames_over_two_ranks_on_the_card(tmp_path):
    from dreamwaltz_g_tpu_torch import tests_support as tts
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.human.smplx_model import (SMPLXParams,
                                                          default_params)
    from dreamwaltz_g_tpu_torch.training import gs_trainer as TG

    dev = _card()
    F, S = 4, 128
    raster = dict(tile_size=16, capacity=256, chunk=64)
    tset = tts.tiny_avatar_setup(device=dev)
    base = default_params(tset.model.smpl, 1)
    gen = torch.Generator().manual_seed(4)
    pose = (torch.randn((F, 1, 63), generator=gen) * 0.3).to(dev)
    obs = SMPLXParams(*[x.expand((F,) + x.shape) for x in base])._replace(
        body_pose=pose)
    cam = make_camera_batch([2.5] * F, [0.0, 90.0, 180.0, 270.0], [80.0] * F,
                            [55.0] * F, S, S, at_vector=((0, 0.7, 0),),
                            device=dev)
    bg = torch.full((S, S, 3), 0.3, device=dev)
    fargs = (obs, cam.extrinsic, cam.intrinsics, cam.tanfov, bg)
    want = TG.make_avatar_render_frames(tset.model, S, S, device=dev,
                                        **raster)(tset.state, *fargs)
    path = TR.save(tmp_path / "frames.pt", dict(
        model=tset.model, state=tset.state, H=S, W=S, raster=raster,
        args=fargs, device=dev))
    ranks = TR.run_ranks(TR.render_frames, 2, path, cuda=True)
    assert [r["blends"] for r in ranks] == [F // 2] * 2
    for got, w in zip(ranks[0]["frames"], want):
        np.testing.assert_allclose(got, w.cpu().numpy(), rtol=0, atol=1e-6)
    assert TR.state_equal(ranks[0]["frames"], ranks[1]["frames"])
    assert float(want[1].max()) > 0.5

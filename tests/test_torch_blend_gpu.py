"""The sorted-blend CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_blend_gpu.py -m gpu --noconftest -q

Tolerance, kernel vs plain version on the same card inputs: 5e-3 on rgb and
alpha, 5e-3 x the largest depth on depth. A pixel the kernel stops early
loses at most exp(-9.2) |value| (the plain version stops per tile at chunk
boundaries), and a min_alpha decision flips only where exp rounds apart
(at most 1/255 of one entry)."""
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
from dreamwaltz_g_tpu_torch.ops import blend as B
from dreamwaltz_g_tpu_torch.ops import rasterize as R
from dreamwaltz_g_tpu_torch.utils.transforms import quat_normalize

TOL = 5e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blend_args(dev, H, W, n, tile_size, spread=0.4, scale=0.02,
                opacity=(0.5, 0.99)):
    rng = np.random.default_rng(n)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W, device=dev)
    g = R.project_gaussians(
        t(rng.normal(size=(n, 3)) * spread),
        R.covariance3d(quat_normalize(t(rng.normal(size=(n, 4)))),
                       t(np.exp(rng.normal(size=(n, 3)) * 0.3) * scale)),
        t(rng.uniform(*opacity, size=(n,))), t(rng.uniform(0, 1, (n, 3))),
        cam.extrinsic[0], cam.intrinsics[0], H, W, tanfov=cam.tanfov[0])
    s_idx, start, counts, _ = R.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, H, W, tile_size, 1024, 16)
    vals = torch.cat([g.colors, g.depth[:, None],
                      torch.ones((n, 1), device=dev)], -1)
    return (s_idx, start, counts, g.means2d, g.conic, g.opacity * g.mask,
            vals, H, W)


def _check(args, tile_size):
    before = B.blend_sorted.launches
    out = B.blend_sorted(*args, tile_size=tile_size)
    assert B.blend_sorted.launches == before + 1
    ref = B.blend_sorted_reference(*args, tile_size=tile_size)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (args[7], args[8], 5)
    err = (out - ref).abs()
    assert float(err[..., :3].max()) < TOL
    assert float(err[..., 4].max()) < TOL
    assert float(err[..., 3].max()) < TOL * float(args[6][:, 3].abs().max())
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_kernel_matches_plain_version(tile_size):
    # 200 x 300: not tile multiples, so the untiling crop is exercised
    ref = _check(_blend_args(_card(), 200, 300, 4000, tile_size), tile_size)
    assert float(ref[..., 4].max()) > 0.5


@pytest.mark.gpu
def test_blend_kernel_early_stop_matches_plain_version():
    """Opaque, overlapping Gaussians drive pixels below T = 1e-4, so the
    kernel's per-pixel stop and the plain version's per-tile stop both
    act."""
    args = _blend_args(_card(), 128, 128, 3000, 32, spread=0.15, scale=0.05,
                       opacity=(0.9, 0.99))
    ref = _check(args, 32)
    assert float(ref[..., 4].max()) > 1.0 - 1e-4


@pytest.mark.gpu
def test_blend_wrapper_rejects_bad_card_inputs():
    args = list(_blend_args(_card(), 64, 64, 100, 32))
    bad = list(args)
    bad[0] = args[0].long()                 # s_idx must be int32
    with pytest.raises(ValueError):
        B.blend_sorted(*bad)
    bad = list(args)
    bad[3] = args[3].cpu()                  # mixed devices
    with pytest.raises(ValueError):
        B.blend_sorted(*bad)
    with pytest.raises(ValueError):         # 64 x 64 = 4096 threads a tile
        B.blend_sorted(*args, tile_size=64)

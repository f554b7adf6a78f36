"""The sorted-blend CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_blend_gpu.py -m gpu --noconftest -q

Tolerance, kernel vs plain version on the same card inputs: 5e-3 on rgb and
alpha, 5e-3 x the largest depth on depth. A pixel the kernel stops early
loses at most exp(-9.2) |value| (the plain version stops per tile at chunk
boundaries), and a min_alpha decision flips only where exp rounds apart
(at most 1/255 of one entry).

The kernel's image equals, to every bit, the table eval kernel's (B3) on
the same depth-sorted entries, since the two run one walk
(``csrc/blend_common.cuh:forward_walk``) and differ only in where an
entry's row index comes from: ``test_sorted_equals_table_eval`` holds it
there at grazing footprints and at full tiles. That the cull drops only
pairs the plain test rejects is held by the plain versions' tolerances
above and, to every bit, by B1 forward's saved state against a walk of
every entry (``test_torch_blend_train_gpu.py``)."""
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch import tests_support
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
from dreamwaltz_g_tpu_torch.ops import blend as B
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
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


def _screen_args(dev, scene, tile_size):
    """blend_sorted's arguments for Gaussians placed on the screen:
    "grazing" puts box edges within a pixel of patch borders; "full" packs
    64 x 64 so densely that every tile holds the full 1024 entries, faint
    enough that most pixels walk them all."""
    if scene == "grazing":
        H, W, n, kw = 128, 160, 3000, dict(grazing=True)
    else:
        H, W, n, kw = 64, 64, 8000, dict(opacity=(0.005, 0.05),
                                          sigma=(2.0, 8.0))
    g = tests_support.screen_gaussians(n, H, W, seed=tile_size, device=dev,
                                       **kw)
    s_idx, start, counts, _ = R.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, H, W, tile_size, 1024, 64)
    vals = torch.cat([g.colors, g.depth[:, None],
                      torch.ones((n, 1), device=dev)], -1)
    return (s_idx, start, counts, g.means2d, g.conic, g.opacity, vals, H, W)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["grazing", "full"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_sorted_equals_table_eval(scene, tile_size):
    """B2 against B3 bitwise: the same depth-sorted segments as (1, T, K)
    tile lists padded with the sentinel row, through
    ``blend_tiles_eval_panels``, then untiled."""
    args = _screen_args(_card(), scene, tile_size)
    s_idx, start, counts, means2d, conic, op, vals, H, W = args
    out = B.blend_sorted(*args, tile_size=tile_size)
    N = means2d.shape[0]
    K = int(counts.max())
    if scene == "full":
        assert int(counts.min()) == K == 1024
    slot = torch.arange(K, device=s_idx.device)
    src = (start[:, None] + slot).clamp(max=s_idx.shape[0] - 1).long()
    tl = torch.where(slot < counts[:, None], s_idx[src], N).to(torch.int32)
    tiles_x = -(-W // tile_size)
    packed = B.pack_rows(means2d, conic, op, vals)[None].contiguous()
    ev = BT.blend_tiles_eval_panels(tl[None].contiguous(),
                                    counts[None].contiguous(), packed,
                                    tile_size, tiles_x)
    ev = B._untile(ev[0], 5, H, W, tile_size)
    torch.cuda.synchronize()
    assert float(out[..., 4].max()) > 0.5
    assert torch.equal(out, ev), float((out - ev).abs().max())


@pytest.mark.gpu
def test_sorted_blend_is_deterministic():
    args = _screen_args(_card(), "grazing", 32)
    a = B.blend_sorted(*args)
    b = B.blend_sorted(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)

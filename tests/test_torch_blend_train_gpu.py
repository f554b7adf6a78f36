"""The training-blend CUDA kernels (B1 forward and backward, B3) against
their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_blend_train_gpu.py -m gpu --noconftest -q

Tolerances, kernel vs plain version on the same card inputs:
* outputs: 5e-3 on rgb and alpha, 5e-3 x the largest depth on depth. A
  pixel the kernel stops early loses at most exp(-9.2) |value| (the plain
  version stops per tile at chunk boundaries), and a min_alpha decision
  flips only where exp rounds apart (at most 1/255 of one entry);
* gradients after the scatter, against the plain backward with the
  kernels' own per-pixel stop (``stop="pixel"``): |err| <= 2e-3 |ref| +
  2e-4 max|ref|, the JAX package's envelope for its own train kernel (the
  float32 T product and its back-to-front recovery against the log-space
  prefix); against the plain backward with the TPU's tile stop, that
  envelope on top of ``blend_tiles_train_stop_envelope``, the stop rules'
  own (an earlier entry's dw moves by up to 1e-4 |G| / (1 - w), w up to
  0.999);
* B1 forward's ``out`` against B3's, and its saved state against a walk of
  every entry in torch with the kernels' float32 roundings
  (``_walk_state``): to every bit, since the arithmetic is the same.
"""
import math

import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch import tests_support
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.ops import rasterize as R
from dreamwaltz_g_tpu_torch.ops.blend import (
    LOG_T_EPS,
    _tile,
    _tile_pixel_centres,
    pack_rows,
)
from dreamwaltz_g_tpu_torch.utils.transforms import quat_normalize

TOL = 5e-3
GRAD_RTOL = 2e-3
GRAD_ATOL_OF_MAX = 2e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _table(dev, H, W, n, tile_size, spread=0.4, scale=0.02,
           opacity=(0.5, 0.99), capacity=1024):
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
    tl, tc, _ = R.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H, W,
                                tile_size, capacity, 16)
    vals = torch.cat([g.colors, g.depth[:, None],
                      torch.ones((n, 1), device=dev)], -1)
    packed = pack_rows(g.means2d, g.conic, g.opacity * g.mask, vals)
    return tl[None], tc[None], packed[None], vals


def _close(out, ref, vals):
    err = (out - ref).abs()
    assert float(err[..., :3].max()) < TOL
    assert float(err[..., 4].max()) < TOL
    assert float(err[..., 3].max()) < TOL * float(vals[:, 3].abs().max())


def _check_grads(got, ref, env=None, peak=None):
    """|got - ref| <= env + GRAD_RTOL (|ref| + env) + GRAD_ATOL_OF_MAX peak,
    per gradient: env the stop rules' envelope (none: 0), peak the largest
    entry of the gradient the float32 envelope holds to (none: ref's)."""
    for i, (a, b) in enumerate(zip(got, ref)):
        e = 0.0 if env is None else env[i]
        m = float(b.abs().max()) if peak is None else peak[i]
        bound = e + GRAD_RTOL * (b.abs() + e) + GRAD_ATOL_OF_MAX * m
        assert bool(((a - b).abs() <= bound).all()), \
            float(((a - b).abs() - bound).max())


def _screen_table(dev, scene, tile_size):
    """The table of Gaussians placed on the screen: "grazing" puts footprint
    box edges within a pixel of patch borders; "full" fills every tile to
    K = 1024 entries, faint enough that most pixels walk them all."""
    if scene == "grazing":
        H, W, n, kw = 128, 160, 3000, dict(grazing=True)
    else:
        H, W, n, kw = 64, 64, 8000, dict(opacity=(0.005, 0.05),
                                          sigma=(2.0, 8.0))
    g = tests_support.screen_gaussians(n, H, W, seed=tile_size, device=dev,
                                       **kw)
    tl, tc, _ = R.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H, W,
                                tile_size, 1024, 64)
    vals = torch.cat([g.colors, g.depth[:, None],
                      torch.ones((n, 1), device=dev)], -1)
    packed = pack_rows(g.means2d, g.conic, g.opacity, vals)
    return (tl[None].contiguous(), tc[None].contiguous(),
            packed[None].contiguous(), vals), W


def _run(dev, H, W, n, tile_size, **kw):
    return _hold(*_table(dev, H, W, n, tile_size, **kw), tile_size, W)


def _hold(tl, tc, packed, vals, tile_size, W):
    """B1 forward and backward and B3 on one table against their plain
    versions; returns the tile-stop plain forward."""
    Tx = -(-W // tile_size)
    f0, b0 = BT.blend_train_fwd.launches, BT.blend_train_bwd.launches
    out, saved = BT.blend_train_fwd(tl, tc, packed, tile_size, Tx)
    assert BT.blend_train_fwd.launches == f0 + 1
    ref, ckpt_tile = BT.blend_tiles_train_reference_fwd(tl, tc, packed,
                                                        tile_size, Tx)
    ref_px, ckpt = BT.blend_tiles_train_reference_fwd(
        tl, tc, packed, tile_size, Tx, stop="pixel")
    torch.cuda.synchronize()
    _close(out, ref, vals)
    _close(out, ref_px, vals)

    dev = out.device
    g = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    g[..., 5:] = 0.0
    d = BT.blend_train_bwd(tl, tc, packed, saved, g, tile_size, Tx)
    assert BT.blend_train_bwd.launches == b0 + 1
    d_ref = BT.blend_tiles_train_reference_bwd(tl, tc, packed, ckpt, g,
                                               tile_size, Tx, stop="pixel")
    torch.cuda.synchronize()
    d_tile = BT.blend_tiles_train_reference_bwd(tl, tc, packed, ckpt_tile, g,
                                                tile_size, Tx)
    env = BT.blend_tiles_train_stop_envelope(tl, tc, packed, ckpt_tile, g,
                                             tile_size, Tx)
    n_rows = packed.shape[1]
    got = BT.panel_grads(d, tl, n_rows, 5)
    ref_px = BT.panel_grads(d_ref, tl, n_rows, 5)
    _check_grads(got, ref_px)
    _check_grads(got, BT.panel_grads(d_tile, tl, n_rows, 5),
                 env=BT.panel_grads(env, tl, n_rows, 5),
                 peak=[float(r.abs().max()) for r in ref_px])

    e0 = BT.blend_tiles_eval_panels.launches
    ev = BT.blend_tiles_eval_panels(tl, tc, packed, tile_size, Tx)
    assert BT.blend_tiles_eval_panels.launches == e0 + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(ev, out, rtol=0, atol=0)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [16, 32])
def test_train_kernels_match_plain_versions(tile_size):
    # 200 x 300: not tile multiples, so the untiling crop is exercised
    ref = _run(_card(), 200, 300, 4000, tile_size)
    assert float(ref[..., 4].max()) > 0.5


@pytest.mark.gpu
def test_train_kernels_early_stop_match_plain_versions():
    """Opaque, overlapping Gaussians drive pixels below T = 1e-4, so the
    kernels' per-pixel stop and the plain version's per-tile stop act."""
    ref = _run(_card(), 128, 128, 3000, 32, spread=0.15, scale=0.05,
               opacity=(0.9, 0.99))
    assert float(ref[..., 4].max()) > 1.0 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["grazing", "full"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_train_kernels_at_grazing_footprints_and_full_tiles(scene,
                                                            tile_size):
    """Where the backward's cull has its closest calls, and where every tile
    is full (count = K = 1024, the step's heaviest tiles)."""
    (tl, tc, packed, vals), W = _screen_table(_card(), scene, tile_size)
    if scene == "full":
        assert int(tc.min()) == tl.shape[-1] == 1024
    ref = _hold(tl, tc, packed, vals, tile_size, W)
    assert float(ref[..., 4].max()) > 0.5


@pytest.mark.gpu
def test_backward_is_deterministic():
    """Two backward calls on the same inputs give the same panel, to every
    bit: the sub-tile blocks' sums meet in a fixed order."""
    (tl, tc, packed, _), W = _screen_table(_card(), "full", 32)
    Tx = -(-W // 32)
    out, saved = BT.blend_train_fwd(tl, tc, packed, 32, Tx)
    g = torch.randn(out.shape, generator=torch.Generator(out.device)
                    .manual_seed(3), device=out.device)
    a = BT.blend_train_bwd(tl, tc, packed, saved, g, 32, Tx)
    b = BT.blend_train_bwd(tl, tc, packed, saved, g, 32, Tx)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert float(a.abs().max()) > 0


def _walk_state(tl, tc, packed, tile_size, tiles_x, alpha_clip=0.999,
                min_alpha=1.0 / 255.0):
    """Each pixel's final T and n_last by a front-to-back walk in torch,
    entry by entry, with the kernels' float32 roundings: one an operation,
    in their order, no fused multiply-add. Every entry is tested, none
    culled. Returns (B, T, P) float32 and int32."""
    B, T, _ = tl.shape
    dev = tl.device
    pix = _tile_pixel_centres(tiles_x, T // tiles_x, tile_size, dev)
    px, py = pix[..., 0], pix[..., 1]                    # (T, P)
    f32 = dict(dtype=torch.float32, device=dev)
    t_eps = torch.tensor(math.exp(LOG_T_EPS), **f32)
    min_alpha = torch.tensor(min_alpha, **f32)
    alpha_clip = torch.tensor(alpha_clip, **f32)
    t = torch.ones((B, T, px.shape[1]), **f32)
    n_last = tc[..., None].expand_as(t).clone()
    done = torch.zeros_like(t, dtype=torch.bool)
    for j in range(int(tc.max())):
        idx = tl[:, :, j].long()[..., None].expand(B, T, 16)
        a = torch.gather(packed, 1, idx)[:, :, None, :]  # (B, T, 1, 16)
        dx = px - a[..., 0]
        dy = py - a[..., 1]
        q = a[..., 2] * dx * dx + 2.0 * a[..., 3] * dx * dy \
            + a[..., 4] * dy * dy
        w = a[..., 5] * torch.exp(-0.5 * q)
        live = (j < tc)[..., None] & ~done & (q >= 0) & (w >= min_alpha)
        t = torch.where(live, t * (1.0 - torch.minimum(w, alpha_clip)), t)
        stop = live & (t <= t_eps)
        n_last = torch.where(stop, j + 1, n_last)
        done |= stop
    return t, n_last


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["grazing", "full"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_forward_saves_each_pixels_stop(scene, tile_size):
    """B1 forward's saved state, which the backward walks back from: per
    pixel, n_last is the list index + 1 of the entry that took T to t_eps
    or below, or the tile's count where none did, so it lies in
    [1, count], is the count wherever the final T is above t_eps, and where
    it is short of the count, entry n_last - 1 passes the pixel's
    ``q >= 0`` and ``w >= min_alpha`` tests (a culled entry never stops a
    pixel). Both equal, to every bit, ``_walk_state``'s walk of every
    entry, so the cull drops no entry that the pixel blends. ``out`` equals
    B3's to every bit, and a second call gives the same three tensors to
    every bit."""
    (tl, tc, packed, _), W = _screen_table(_card(), scene, tile_size)
    Tx = -(-W // tile_size)
    out, (t_final, n_last) = BT.blend_train_fwd(tl, tc, packed, tile_size,
                                                Tx)
    out2, (t_final2, n_last2) = BT.blend_train_fwd(tl, tc, packed,
                                                   tile_size, Tx)
    ev = BT.blend_tiles_eval_panels(tl, tc, packed, tile_size, Tx)
    torch.cuda.synchronize()
    assert torch.equal(out, ev), float((out - ev).abs().max())
    assert torch.equal(out, out2) and torch.equal(t_final, t_final2) \
        and torch.equal(n_last, n_last2)

    t_eps = math.exp(LOG_T_EPS)
    count = tc[..., None].expand_as(n_last)
    assert int(tc.min()) > 0
    assert bool(((n_last >= 1) & (n_last <= count)).all())
    assert bool((n_last[t_final > t_eps] == count[t_final > t_eps]).all())
    stopped = n_last < count
    assert bool((t_final[stopped] <= t_eps).all())
    if scene == "grazing":           # opaque enough that pixels stop early
        assert int(stopped.sum()) > 1000
    row = tl.gather(-1, (n_last - 1).long())             # (1, T, P)
    a = packed[0, row.long()]                            # (1, T, P, 16)
    pix = _tile_pixel_centres(Tx, tl.shape[1] // Tx, tile_size, out.device)
    dx = pix[..., 0] - a[..., 0]
    dy = pix[..., 1] - a[..., 1]
    q = a[..., 2] * dx * dx + 2.0 * a[..., 3] * dx * dy + a[..., 4] * dy * dy
    w = a[..., 5] * torch.exp(-0.5 * q)
    assert bool(((q >= 0) & (w >= 1.0 / 255.0))[stopped].all())
    # to every bit the walk of every entry, culled or not
    t_ref, n_ref = _walk_state(tl, tc, packed, tile_size, Tx)
    assert torch.equal(n_last, n_ref), int((n_last != n_ref).sum())
    assert torch.equal(t_final, t_ref), float((t_final - t_ref).abs().max())


@pytest.mark.gpu
def test_autograd_function_on_card_matches_cpu():
    """The whole ``blend_tiles_train`` (kernels on the card) against the
    same call on the CPU (plain versions, tile stop), gradients included,
    on a scene where no pixel reaches T = 1e-4, so the stop rules agree."""
    dev = _card()
    tl, tc, packed, vals = _table(dev, 96, 96, 800, 16, opacity=(0.2, 0.6))
    H = W = 96
    p = packed[0, :-1]
    leaves = [p[:, 0:2], p[:, 2:5], p[:, 5], vals]
    g = torch.randn((H, W, 5), generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for d in (dev, torch.device("cpu")):
        xs = [x.detach().to(d).requires_grad_(True) for x in leaves]
        out = BT.blend_tiles_train(tl[0].to(d), tc[0].to(d), *xs, H, W,
                                   tile_size=16)
        (out * g.to(d)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append([x.grad.cpu() for x in xs])
    assert float(outs[1][..., 4].max()) < 1.0 - 1e-4
    assert float((outs[0] - outs[1]).abs().max()) < TOL
    _check_grads(grads[0], grads[1])


@pytest.mark.gpu
def test_train_wrapper_rejects_bad_card_inputs():
    dev = _card()
    tl, tc, packed, _ = _table(dev, 64, 64, 100, 32)
    with pytest.raises(ValueError):            # lists must be int32
        BT.blend_train_fwd(tl.long(), tc, packed, 32, 2)
    with pytest.raises(ValueError):            # mixed devices
        BT.blend_train_fwd(tl, tc.cpu(), packed, 32, 2)
    with pytest.raises(ValueError):            # 64 x 64 = 4096 threads a tile
        BT.blend_train_fwd(tl, tc, packed, 64, 1)
    assert _tile(torch.zeros(64, 64, 5, device=dev), 32).shape == (4, 1024, 8)

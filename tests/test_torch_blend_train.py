"""Parity of the port's training blend (B1) and table eval blend (B3) plain
versions against the JAX package: the Pallas kernels run in interpret mode
(as ``tests/test_pallas_blend.py`` runs them) and JAX autodiff of the jnp
``blend_tiles``; the (T, K) binning; the ``autograd.Function`` on CPU
tensors against torch autograd of the port's ``blend_tiles``. The CUDA
kernels run only on the card (``tests/test_torch_blend_train_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch
from dreamwaltz_g_tpu.ops import rasterize as JR
from dreamwaltz_g_tpu.ops.pallas_blend import (
    blend_tiles_pallas,
    blend_tiles_pallas_train,
)
from dreamwaltz_g_tpu.utils.transforms import quat_normalize
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.ops import rasterize as TR
from dreamwaltz_g_tpu_torch.ops.blend import _tile, pack_rows
import tests.torch_threads  # noqa: F401  (per-worker threads)

H = W = 32
TS, CAP, CHUNK = 16, 64, 32


def _scene(n, seed, spread=0.4, scale=0.03, opacity=(0.2, 0.95)):
    rng = np.random.default_rng(seed)
    means3d = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    quats = quat_normalize(jnp.asarray(rng.normal(size=(n, 4)), jnp.float32))
    scales = jnp.asarray(np.exp(rng.normal(size=(n, 3))) * scale, jnp.float32)
    opac = jnp.asarray(rng.uniform(*opacity, size=(n,)), jnp.float32)
    colors = jnp.asarray(rng.uniform(0, 1, size=(n, 3)), jnp.float32)
    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W)
    return JR.project_gaussians(means3d, JR.covariance3d(quats, scales), opac,
                                colors, cam.extrinsic[0], cam.intrinsics[0],
                                H, W)


def _jax_args(g):
    tl, tc, _ = JR.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H, W,
                                 TS, CAP)
    N = g.colors.shape[0]
    values = jnp.concatenate([g.colors, g.depth[:, None], jnp.ones((N, 1))],
                             -1)
    op = g.opacity * g.mask.astype(jnp.float32)
    return tl, tc, (g.means2d, g.conic, op, values)


def _t(x):
    return torch.as_tensor(np.array(x))


def _loss_weights(seed):
    return np.random.default_rng(seed).normal(size=(H, W, 5)).astype(
        np.float32)


@pytest.mark.parametrize("tile_size,capacity,D", [(16, 64, 8), (16, 8, 16),
                                                  (8, 32, 8)])
def test_bin_gaussians_matches_jax(tile_size, capacity, D):
    """tile_lists and tile_counts exactly; each tile's entries as a
    multiset, since ``lax.sort`` need not keep ties in order."""
    g = _scene(120, seed=1)
    jl, jc, jo = JR.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H, W,
                                  tile_size, capacity, D)
    tl, tc, to = TR.bin_gaussians(_t(g.means2d), _t(g.radius), _t(g.depth),
                                  _t(g.mask), H, W, tile_size, capacity, D)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert float(jo) == float(to)
    jl = np.asarray(jl)
    assert tl.dtype == torch.int32 and tl.shape == jl.shape
    for a, b in zip(jl, tl.numpy()):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_train_plain_version_matches_pallas_interpret(dense):
    """Forward within 1e-5 and the gradients within 1e-4 (relative to the
    largest) of the TPU train kernels run in interpret mode: both float32,
    the same chunked prefix and tile stop. The saturating scene drives
    pixels below T = 1e-4, so the stop acts."""
    g = _scene(300, seed=2, spread=0.25, scale=0.08, opacity=(0.9, 0.99)) \
        if dense else _scene(120, seed=3)
    tl, tc, args = _jax_args(g)
    gw = _loss_weights(0)

    def jloss(*a):
        out = blend_tiles_pallas_train(tl, tc, *a, H, W, tile_size=TS,
                                       chunk=CHUNK, interpret=True)
        return jnp.sum(out * gw), out

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(*args)
    xs = [_t(a).requires_grad_(True) for a in args]
    tout = BT.blend_tiles_train(_t(tl), _t(tc), *xs, H, W, tile_size=TS,
                                chunk=CHUNK)
    if dense:
        assert float(tout.detach()[..., 4].max()) > 1.0 - 1e-4
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    (tout * torch.as_tensor(gw)).sum().backward()
    for name, a, b in zip(("means2d", "conic", "opacity", "values"), jg, xs):
        a = np.asarray(a)
        np.testing.assert_allclose(b.grad.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(a).max()),
                                   err_msg=name)


def test_train_plain_version_matches_jax_autodiff():
    """Against JAX autodiff of the jnp ``blend_tiles`` (the JAX package's
    envelope for its own train kernel): loss rtol 1e-4, gradients rtol 2e-3
    / atol 2e-4. The values' constant ones lane gets no gradient there."""
    g = _scene(120, seed=4)
    tl, tc, args = _jax_args(g)
    N, CH = g.colors.shape
    gw = _loss_weights(1)

    def jloss(means2d, conic, opacity, vals):
        gg = g._replace(means2d=means2d, conic=conic, opacity=opacity,
                        colors=vals[:, :CH], depth=vals[:, CH],
                        mask=jnp.ones(N, bool))
        return jnp.sum(JR.blend_tiles(tl, gg, H, W, TS, CHUNK) * gw)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(*args)
    xs = [_t(a).requires_grad_(True) for a in args]
    tl_ = (BT.blend_tiles_train(_t(tl), _t(tc), *xs, H, W, tile_size=TS,
                                chunk=CHUNK) * torch.as_tensor(gw)).sum()
    tl_.backward()
    np.testing.assert_allclose(float(tl_.detach()), float(jl), rtol=1e-4)
    for i, (a, b) in enumerate(zip(jg, xs)):
        a, b = np.asarray(a), b.grad.numpy()
        if i == 3:
            a, b = a[:, :CH + 1], b[:, :CH + 1]
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)


def test_function_matches_autograd_of_port_blend_tiles():
    """The autograd.Function on CPU tensors (plain forward and hand-derived
    backward) against torch autograd through the port's ``blend_tiles``;
    float32 log-space against the same log-space, within 1e-5 on the
    outputs and 1e-4 relative on the gradients."""
    g = _scene(150, seed=5)
    tl, tc, _ = _jax_args(g)
    tg = TR.Gaussians2D(*[_t(x) for x in g])
    N = tg.colors.shape[0]
    leaves = [tg.means2d, tg.conic, tg.opacity * tg.mask,
              torch.cat([tg.colors, tg.depth[:, None], torch.ones(N, 1)], -1)]
    gw = torch.as_tensor(_loss_weights(2))
    a = [x.clone().requires_grad_(True) for x in leaves]
    out_a = BT.blend_tiles_train(_t(tl), _t(tc), *a, H, W, tile_size=TS,
                                 chunk=CHUNK)
    (out_a * gw).sum().backward()
    b = [x.clone().requires_grad_(True) for x in leaves]
    gb = TR.Gaussians2D(b[0], b[1], b[3][:, 3], tg.radius, b[2], b[3][:, :3],
                        torch.ones(N, dtype=torch.bool))
    out_b = TR.blend_tiles(_t(tl), gb, H, W, TS, CHUNK)
    (out_b * gw).sum().backward()
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=1e-5)
    for i, (x, y) in enumerate(zip(a, b)):
        gx, gy = x.grad, y.grad
        if i == 3:
            gx, gy = gx[:, :4], gy[:, :4]
        torch.testing.assert_close(gx, gy, rtol=1e-4,
                                   atol=1e-4 * float(gy.abs().max()))


def test_eval_plain_version_matches_pallas_interpret():
    """B3's plain version, through ``_blend_dispatch(mode='eval')``, within
    1e-5 of ``blend_tiles_pallas`` in interpret mode."""
    g = _scene(200, seed=6, spread=0.3, opacity=(0.6, 0.99))
    tl, tc, args = _jax_args(g)
    j = blend_tiles_pallas(tl, *args, H, W, tile_size=TS, chunk=CHUNK,
                           interpret=True, tile_counts=tc)
    tg = TR.Gaussians2D(*[_t(x) for x in g])
    before = BT.blend_tiles_eval_panels.launches
    t = TR._blend_dispatch(_t(tl), tg.means2d, tg.conic, tg.opacity,
                           tg.colors, tg.depth, tg.mask, H, W, TS, CHUNK,
                           tile_counts=_t(tc), mode="eval")
    assert BT.blend_tiles_eval_panels.launches == before   # CPU: no kernel
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_rasterize_projected_train_matches_jax():
    """``rasterize_projected``'s default train branch end to end (table
    binning + the train blend) against the JAX package's jnp path; its
    eval branch still takes the sorted blend."""
    g = _scene(150, seed=7)
    kw = dict(tile_size=TS, capacity=CAP, chunk=CHUNK,
              max_tiles_per_gaussian=8)
    j = JR.rasterize_projected(g, H, W, **kw)
    t = TR.rasterize_projected(TR.Gaussians2D(*[_t(x) for x in g]), H, W,
                               **kw)
    for name in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=2e-5)
    assert float(t.overflow) == float(j.overflow)
    with pytest.raises(ValueError, match="mode"):
        TR.rasterize_projected(TR.Gaussians2D(*[_t(x) for x in g]), H, W,
                               mode="both")


def test_tile_untile_round_trip_and_wrapper_checks():
    img = torch.randn(2, 40, 56, 5)
    tiles = _tile(img, 16)
    assert tiles.shape == (2, 12, 256, 8)
    from dreamwaltz_g_tpu_torch.ops.blend import _untile
    torch.testing.assert_close(_untile(tiles, 5, 40, 56, 16), img)
    packed = pack_rows(torch.zeros(3, 2), torch.zeros(3, 3), torch.zeros(3),
                       torch.zeros(3, 5))
    with pytest.raises(ValueError):   # lists must be (B, T, K)
        BT.blend_train_fwd(torch.zeros(4, 8, dtype=torch.int32),
                           torch.zeros(1, 4, dtype=torch.int32), packed[None],
                           16, 2)
    with pytest.raises(ValueError):   # meta tensors are neither cpu nor cuda
        BT.blend_train_fwd(torch.zeros(1, 4, 8, dtype=torch.int32,
                                       device="meta"),
                           torch.zeros(1, 4, dtype=torch.int32,
                                       device="meta"),
                           packed[None].to("meta"), 16, 2)


@pytest.mark.parametrize("stop", ["tile", "pixel"])
def test_plain_backward_is_the_gradient_of_plain_forward(stop):
    """On a saturating scene, the hand-derived plain backward equals torch
    autograd through the plain forward (the gather's vjp included), for the
    TPU kernels' tile stop and for the CUDA kernels' per-pixel stop; 1e-4
    relative to each gradient's largest entry (float32 sums in another
    order)."""
    g = _scene(300, seed=8, spread=0.25, scale=0.08, opacity=(0.9, 0.99))
    tl, tc, args = _jax_args(g)
    packed = pack_rows(*[_t(a) for a in args])[None].requires_grad_(True)
    tl, tc = _t(tl)[None], _t(tc)[None]
    Tx = W // TS
    out, ckpt = BT.blend_tiles_train_reference_fwd(tl, tc, packed, TS, Tx,
                                                   CHUNK, stop=stop)
    assert float(out.detach()[..., 4].max()) > 1.0 - 1e-4
    gw = _tile(torch.as_tensor(_loss_weights(3))[None], TS)
    (out * gw).sum().backward()
    d = BT.blend_tiles_train_reference_bwd(tl, tc, packed.detach(),
                                           ckpt.detach(), gw, TS, Tx, CHUNK,
                                           stop=stop)
    got = BT.panel_grads(d, tl, packed.shape[1], 5)
    want = packed.grad[:, :-1]
    for a, b in zip(got, (want[..., 0:2], want[..., 2:5], want[..., 5],
                          want[..., 8:13])):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    if stop == "pixel":   # the two rules give different images here
        tile, _ = BT.blend_tiles_train_reference_fwd(tl, tc, packed, TS, Tx,
                                                     CHUNK)
        diff = float((tile - out).detach().abs().max())
        assert 0.0 < diff <= 1e-4 * float(packed[..., 8:13].abs().max())


@pytest.mark.parametrize("seed,saturating", [(8, True), (9, True),
                                             (3, False)])
def test_stop_envelope_bounds_the_two_stop_rules(seed, saturating,
                                                 monkeypatch):
    """``blend_tiles_train`` on CPU tensors under ``PLAIN_STOP = "tile"``
    and ``"pixel"``: per Gaussian, the two rules' gradients part by no more
    than ``blend_tiles_train_stop_envelope`` allows, up to the float32
    rounding of the two plain versions (1e-5 of the largest gradient). On
    the saturating scenes the stop acts and the rules part by more than
    rounding; on the sparse one no pixel reaches T = 1e-4, the envelope is
    zero and so is the gap."""
    g = _scene(300, seed=seed, spread=0.25, scale=0.08, opacity=(0.9, 0.99)) \
        if saturating else _scene(120, seed=seed)
    tl, tc, args = _jax_args(g)
    gw = torch.as_tensor(_loss_weights(seed))
    grads = {}
    for stop in ("tile", "pixel"):
        monkeypatch.setattr(BT, "PLAIN_STOP", stop)
        xs = [_t(a).requires_grad_(True) for a in args]
        (BT.blend_tiles_train(_t(tl), _t(tc), *xs, H, W, tile_size=TS,
                              chunk=CHUNK) * gw).sum().backward()
        grads[stop] = [x.grad for x in xs]
    packed = pack_rows(*[_t(a) for a in args])[None]
    btl, btc = _t(tl)[None], _t(tc)[None]
    _, ckpt = BT.blend_tiles_train_reference_fwd(btl, btc, packed, TS,
                                                 W // TS, CHUNK)
    env = BT.blend_tiles_train_stop_envelope(btl, btc, packed, ckpt,
                                             _tile(gw[None], TS), TS, W // TS,
                                             CHUNK)
    env = [e[0] for e in BT.panel_grads(env, btl, packed.shape[1], 5)]
    gap_of_max = 0.0
    for a, b, e in zip(grads["tile"], grads["pixel"], env):
        m = float(a.abs().max())
        gap = (a - b).abs()
        assert bool((gap <= e + 1e-5 * m).all()), \
            float((gap - e - 1e-5 * m).max())
        gap_of_max = max(gap_of_max, float(gap.max()) / m)
    if saturating:
        assert gap_of_max > 1e-4
    else:
        assert max(float(e.max()) for e in env) == 0.0
        assert gap_of_max == 0.0

"""The blend kernels' footprint cull, through its plain twins
``ops/blend.py:footprint_boxes`` and ``patch_keep``, on the CPU.

A culled (pixel, entry) pair must be one the plain test rejects: the box
must hold every pixel centre where ``ops/blend_train.py:_weights`` (the
float32 operation order both kernels use) passes ``q >= 0`` and
``w >= min_alpha``. The kernels compute the same float64 box and round it
outward to float32, so it holds the twin's. The margin
(``csrc/blend_common.cuh``) covers the float32 rounding of q, exp and the
products; ``test_zero_margin_box_misses_a_passing_pixel`` shows that the
exact ellipse's box is not enough. The kernels themselves run only on the
card (``tests/test_torch_blend_gpu.py``, ``tests/test_torch_blend_train_gpu.py``).
"""
import re

import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch import kernels, tests_support
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
from dreamwaltz_g_tpu_torch.ops import blend as B
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.ops import rasterize as R
from dreamwaltz_g_tpu_torch.ops.blend import footprint_boxes, patch_keep
from dreamwaltz_g_tpu_torch.utils.transforms import quat_normalize

MIN_ALPHA = 1.0 / 255.0
MA32 = float(np.float32(MIN_ALPHA))
SIZE = 48          # pixel grid of the containment tests


def _rows(means, conics, ops):
    """(N, 16) float32 packed rows from float64 attributes."""
    n = len(ops)
    packed = np.zeros((n, 16), np.float32)
    packed[:, 0:2] = means
    packed[:, 2:5] = conics
    packed[:, 5] = ops
    packed[:, 8:11] = 0.5
    return torch.tensor(packed)


def _conics(rng, n, lo, hi, blur=0.3):
    """Conics of random rotated covariances with eigenvalues in [lo, hi]
    (+ the projection's blur): rows [ca, cb, cc]."""
    th = rng.uniform(0, np.pi, n)
    l1 = rng.uniform(lo, hi, n) + blur
    l2 = rng.uniform(lo, hi, n) + blur
    c, s = np.cos(th), np.sin(th)
    a = l1 * c * c + l2 * s * s
    b = (l1 - l2) * c * s
    d = l1 * s * s + l2 * c * c
    det = a * d - b * b
    return np.stack([d / det, -b / det, a / det], -1)


def _pixels(size=SIZE):
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    px = torch.tensor(xs.reshape(1, -1, 1) + 0.5, dtype=torch.float32)
    py = torch.tensor(ys.reshape(1, -1, 1) + 0.5, dtype=torch.float32)
    return px, py


def _passes(packed, px, py):
    """(P, N) bool: the plain test of every (pixel, row) pair."""
    _, _, _, _, w = BT._weights(packed[None, None], px, py, 0.999, MIN_ALPHA)
    return w[0, 0] > 0


def _exact_boxes(packed):
    """The exact ellipse's box, q <= 2 ln(op / min_alpha), no margin, for
    positive-definite conics."""
    a = packed.double()
    mx, my, ca, cb, cc, op = (a[..., i] for i in range(6))
    det = ca * cc - cb * cb
    r = torch.clamp(2.0 * torch.log(op / MA32), min=0.0)
    hx, hy = torch.sqrt(r * cc / det), torch.sqrt(r * ca / det)
    return torch.stack([mx - hx, mx + hx, my - hy, my + hy], -1)


def _patch_of_pixel(tile_size):
    """(P,) the 8 x 4 patch, numbered row-major, of each pixel of a tile
    (pixels row-major): the warp the kernels give it
    (``csrc/blend_common.cuh:patch_of``)."""
    ly, lx = torch.meshgrid(torch.arange(tile_size), torch.arange(tile_size),
                            indexing="ij")
    return ((ly // B.PATCH_H) * (tile_size // B.PATCH_W)
            + lx // B.PATCH_W).reshape(-1)


def _assert_holds(packed, size=SIZE):
    px, py = _pixels(size)
    ok = _passes(packed, px, py)
    box = footprint_boxes(packed, MIN_ALPHA)
    x, y = px[0].double(), py[0].double()                  # (P, 1)
    inside = (x >= box[:, 0]) & (x <= box[:, 1]) & (y >= box[:, 2]) \
        & (y <= box[:, 3])
    assert int((ok & ~inside).sum()) == 0, \
        f"{int((ok & ~inside).sum())} passing pairs outside their box"
    return ok, box


def _case(name, rng, n=400):
    if name == "random":
        means = rng.uniform(-5, SIZE + 5, (n, 2))
        conics = _conics(rng, n, 0.1, 40.0)
        ops = rng.uniform(0.02, 0.99, n)
    elif name == "near_min_alpha":
        # a few ulps to 1% above min_alpha; centres on and off pixel centres
        means = np.floor(rng.uniform(2, SIZE - 2, (n, 2))) + 0.5
        means[n // 2:] += rng.uniform(-0.5, 0.5, (n - n // 2, 2))
        conics = _conics(rng, n, 0.0, 4.0)
        ops = MA32 * (1.0 + rng.uniform(0, 1e-2, n))
        ops[:40] = np.nextafter(np.float32(MA32), np.float32(1.0))
    elif name == "thin":
        # needles: one axis at the blur, the other up to 70 px long
        means = rng.uniform(0, SIZE, (n, 2))
        th = rng.uniform(0, np.pi, n)
        l1 = np.full(n, 0.3)
        l2 = rng.uniform(100, 5000, n)
        c, s = np.cos(th), np.sin(th)
        a = l1 * c * c + l2 * s * s
        b = (l1 - l2) * c * s
        d = l1 * s * s + l2 * c * c
        det = a * d - b * b
        conics = np.stack([d / det, -b / det, a / det], -1)
        ops = rng.uniform(0.3, 0.99, n)
    elif name == "far":
        sign = rng.choice([-1.0, 1.0], (n, 2))
        means = SIZE / 2 + sign * rng.uniform(40, 5000, (n, 2))
        conics = _conics(rng, n, 0.1, 400.0)
        ops = rng.uniform(0.02, 0.99, n)
    else:  # "grazing": each box edge within a pixel of a pixel centre
        conics = _conics(rng, n, 0.1, 20.0)
        ops = rng.uniform(0.02, 0.99, n)
        box = footprint_boxes(_rows(np.zeros((n, 2)), conics, ops),
                              MIN_ALPHA).numpy()
        edge = np.floor(rng.uniform(4, SIZE - 4, (n, 2))) + 0.5
        edge += rng.uniform(-1, 1, (n, 2))
        means = edge - box[:, [1, 3]]          # x_hi, y_hi land at `edge`
    return _rows(means, conics, ops)


@pytest.mark.parametrize("name", ["random", "near_min_alpha", "thin", "far",
                                  "grazing"])
def test_box_holds_every_passing_pixel(name):
    packed = _case(name, np.random.default_rng(len(name)))
    ok, box = _assert_holds(packed)
    if name == "far":
        assert int(ok.sum()) == 0
        # most boxes miss the image altogether
        out = (box[:, 1] < 0) | (box[:, 0] > SIZE) | (box[:, 3] < 0) \
            | (box[:, 2] > SIZE)
        assert float(out.double().mean()) > 0.9
    else:
        assert int(ok.sum()) > 0
        assert bool(torch.isfinite(box).all())


def test_grazing_boxes_are_tight():
    """The margin is a few ulps, not pixels: on the grazing case every box
    edge lies within 1e-3 pixel of the exact ellipse's."""
    packed = _case("grazing", np.random.default_rng(7))
    exact = _exact_boxes(packed)
    wide = footprint_boxes(packed, MIN_ALPHA)
    assert bool((wide[:, [0, 2]] <= exact[:, [0, 2]]).all())
    assert bool((wide[:, [1, 3]] >= exact[:, [1, 3]]).all())
    assert float((wide - exact).abs().max()) < 1e-3


def test_zero_margin_box_misses_a_passing_pixel():
    """Where the exact ellipse's edge falls a hair inside a pixel centre, the
    float32 weight can still round up to min_alpha: such a pixel passes the
    plain test but lies outside the zero-margin box. The margin's box holds
    it. Isotropic conics put the pixel at an exact q; opacities step by one
    float32 ulp around the value whose exact edge lies on the pixel."""
    ma = np.float32(MIN_ALPHA)
    misses = 0
    for dx, frac in ((2.0, 0.25), (2.5, 0.0), (4.0, 0.125), (3.0, 0.0)):
        op0 = np.float32(float(ma) * np.exp(dx * dx / 2))
        ops = [op0]
        lo = hi = op0
        for _ in range(100):
            lo = np.nextafter(lo, np.float32(0))
            hi = np.nextafter(hi, np.float32(1))
            ops += [lo, hi]
        n = len(ops)
        mx = 10.5 + frac
        packed = _rows(np.tile([mx, 10.5], (n, 1)), np.tile([1, 0, 1], (n, 1)),
                       np.array(ops))
        px = torch.tensor([[[mx + dx]]], dtype=torch.float32)
        ok = _passes(packed, px, torch.tensor([[[10.5]]]))[0]
        exact = _exact_boxes(packed)
        wide = footprint_boxes(packed, MIN_ALPHA)
        misses += int((ok & (exact[:, 1] < mx + dx)).sum())
        assert int((ok & (wide[:, 1] < mx + dx)).sum()) == 0
    assert misses > 0


def test_dead_rows_cull_everywhere():
    """op = 0 (dead slots, the sentinel row), a negative op, and an op just
    below min_alpha / (1 + eps): the empty box, no patch kept, and indeed no
    pixel passes."""
    n = 6
    ops = np.array([0.0, 0.0, -0.5, MA32 * 0.5, MA32 / (1 + 2 ** -19),
                    MA32 / (1 + 2 ** -19)])
    means = np.array([[10.5, 10.5]] * n)
    packed = _rows(means, np.tile([1.0, 0.0, 1.0], (n, 1)), ops)
    packed[1] = 0.0                                          # the sentinel
    ok, box = _assert_holds(packed)
    assert int(ok.sum()) == 0
    inf = float("inf")
    assert torch.equal(box, box.new_tensor([[inf, -inf, inf, -inf]] * n))
    keep = patch_keep(box.reshape(1, n, 4).expand(4, n, 4).contiguous(), 16, 2)
    assert not bool(keep.any())


def test_non_positive_definite_conics_are_never_culled():
    """det <= 0, ca <= 0, a conic too thin for the margin's bound, or a NaN
    attribute: the whole plane, every patch kept. A det < 0 conic passes
    pixels far from its mean along its asymptotes, which a bounded box would
    lose."""
    rows = [[1.0, 0.0, -0.5],      # det < 0: q = dx^2 - dy^2 / 2
            [1.0, 1.0, 1.0],       # det = 0
            [-1.0, 0.0, -1.0],     # ca < 0, det > 0
            [1.0, 0.0, 1e-7],      # kappa ~ 1e7 > 2^19
            [float("nan"), 0.0, 1.0]]
    n = len(rows)
    packed = _rows(np.array([[10.5, 10.5]] * n), np.array(rows),
                   np.full(n, 0.9))
    ok, box = _assert_holds(packed)
    inf = float("inf")
    assert torch.equal(box, box.new_tensor([[-inf, inf, -inf, inf]] * n))
    # the det < 0 row passes a pixel 14 px below and 10 right of its mean
    px, py = _pixels()
    far = (px[0, :, 0] == 20.5) & (py[0, :, 0] == 24.5)
    assert bool(ok[far, 0].all())
    keep = patch_keep(box.reshape(1, n, 4).expand(4, n, 4).contiguous(), 16, 2)
    assert bool(keep.all())


def _projected(tile_size, H, W):
    rng = np.random.default_rng(tile_size)
    n = 600

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W, device="cpu")
    return R.project_gaussians(
        t(rng.normal(size=(n, 3)) * 0.4),
        R.covariance3d(quat_normalize(t(rng.normal(size=(n, 4)))),
                       t(np.exp(rng.normal(size=(n, 3)) * 0.5) * 0.01)),
        t(rng.uniform(0.01, 0.99, size=(n,))), t(rng.uniform(0, 1, (n, 3))),
        cam.extrinsic[0], cam.intrinsics[0], H, W, tanfov=cam.tanfov[0])


@pytest.mark.parametrize("scene,tile_size", [
    ("projected", 8), ("projected", 16), ("projected", 24), ("projected", 32),
    ("grazing", 16), ("grazing", 32)])
def test_patch_keep_holds_every_passing_pair(scene, tile_size):
    """A binned scene -- projected, or ``tests_support.screen_gaussians``
    with box edges within a pixel of patch borders (the card tests' grazing
    scene): every (pixel, entry) pair the plain test passes lies in a patch
    the cull keeps for that entry, with the kernels' 8 x 4 patch map; and
    the cull drops most pairs."""
    H, W = 72, 96
    if scene == "projected":
        g = _projected(tile_size, H, W)
    else:
        g = tests_support.screen_gaussians(500, H, W, seed=tile_size,
                                           sigma=(0.5, 3.0), grazing=True)
    tl, tc, _ = R.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H, W,
                                tile_size, 256, 64)
    packed = B.pack_rows(g.means2d, g.conic, g.opacity * g.mask,
                         g.colors)[None]
    tl, tc = tl[None], tc[None]
    tiles_x = -(-W // tile_size)
    panels = BT._gather(packed, tl)                      # (1, T, K, 16)
    pix = B._tile_pixel_centres(tiles_x, tl.shape[1] // tiles_x, tile_size,
                                "cpu")
    _, _, _, _, w = BT._weights(panels, pix[..., 0:1], pix[..., 1:2], 0.999,
                                MIN_ALPHA)               # (1, T, P, K)
    live = torch.arange(tl.shape[2]) < tc[..., None]     # (1, T, K)
    ok = (w > 0) & live[:, :, None, :]
    keep = patch_keep(footprint_boxes(panels, MIN_ALPHA), tile_size, tiles_x)
    kept = keep[:, :, _patch_of_pixel(tile_size), :]    # (1, T, P, K)
    assert int(ok.sum()) > 1000
    assert int((ok & ~kept).sum()) == 0
    share = float((kept & live[:, :, None, :]).sum()) \
        / float(live.sum() * tile_size ** 2)
    assert share < 0.5


def test_patch_map_matches_the_kernels_layout():
    """Patches are 8 x 4, row-major in the tile, tile_size / 8 a row; a
    32 x 8 strip (a block of BLOCK_ROWS = 8 rows) holds 8 whole patches."""
    p = _patch_of_pixel(32).reshape(32, 32)
    assert int(p[0, 0]) == 0 and int(p[0, 8]) == 1 and int(p[4, 0]) == 4
    assert int(p[31, 31]) == 31
    for strip in range(4):
        rows = p[8 * strip:8 * strip + 8]
        assert sorted(set(rows.reshape(-1).tolist())) == list(
            range(8 * strip, 8 * strip + 8))
    assert torch.equal(torch.bincount(_patch_of_pixel(24)),
                       torch.full((18,), 32))
    assert B.BLOCK_ROWS % B.PATCH_H == 0


_C_TYPES = {"int": "I", "float": "F", "long long": "L"}


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signatures_match_the_c_exports(name):
    """Each ``extern "C"`` launch function of ``csrc/<name>.cu`` has the
    argument types ``kernels.SIGNATURES`` gives ctypes (pointers as void
    pointers), and every export is listed."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    exports = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split()[:-1]).replace("const ", "")
            kinds.append("P" if "*" in p else _C_TYPES[p])
        exports[fn] = kinds
    want = {fn: ["P" if t is kernels._P else "I" if t is kernels._I
                 else "F" if t is kernels._F else "L" for t in types]
            for fn, types in kernels.SIGNATURES[name].items()}
    assert exports == want


@pytest.mark.parametrize("plain", ["sorted", "table"])
def test_reached_counts_each_pixels_walk(plain):
    """The plain versions' ``stats["reached"]`` -- the entries each pixel
    reaches before its own stop, over which ``chip_smoke.py`` counts the
    culling kernels' work -- sums to ``pairs``, lies in [0, count], and is
    short of the count for a pixel that stops early."""
    H, W, ts = 48, 64, 16
    g = tests_support.screen_gaussians(400, H, W, seed=3, sigma=(2.0, 6.0))
    op = torch.full_like(g.opacity, 0.9)
    vals = torch.cat([g.colors, g.depth[:, None], torch.ones_like(op)[:, None]],
                     -1)
    stats = {}
    if plain == "sorted":
        s_idx, start, cnt, _ = R.bin_gaussians_sorted(
            g.means2d, g.radius, g.depth, g.mask, H, W, ts, 256, 64)
        B.blend_sorted_reference(s_idx, start, cnt, g.means2d, g.conic, op,
                                 vals, H, W, tile_size=ts, chunk=32,
                                 capacity=256, stats=stats)
        reached, counts = stats["reached"], cnt.long()
    else:
        tl, tc, _ = R.bin_gaussians(g.means2d, g.radius, g.depth, g.mask, H,
                                    W, ts, 256, 64)
        packed = B.pack_rows(g.means2d, g.conic, op, vals)[None]
        BT.blend_tiles_train_reference_fwd(tl[None], tc[None], packed, ts,
                                           -(-W // ts), chunk=32, stats=stats)
        reached, counts = stats["reached"][0], tc.long()
    assert reached.shape == (counts.numel(), ts * ts)
    assert int(reached.sum()) == stats["pairs"]
    assert bool((reached >= 0).all())
    assert bool((reached <= counts[:, None]).all())
    assert bool((reached < counts[:, None]).any())

"""The trainer steps on the card repeat to the bit within one process.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_repeat_gpu.py -m gpu --noconftest -q

* One stage-1 SDS step of a tiny NeRF (``scripts/repeat_check.py``'s: a
  16^2 x 8 triplane, a 16^3 grid, rays in checkpointed chunks, sigma
  guidance, volume sparsity, the background MLP) with the tiny float32
  guidance and its ControlNet, twice from copies of the same field, grid
  and draws, as ``resolve_device`` leaves cuDNN: the metrics, every
  gradient and every updated weight equal to the bit, with flash attention
  "on" (the kernels) and "off" (einsum). cuDNN's default float32
  convolution backward adds in no fixed order, and ``resolve_device``
  holds it to deterministic algorithms.
* ``nerf/export.py:export_point_cloud`` of one field at 400^3 with the
  isolated-cell filter, twice: the points, colours and counts equal.
* One stage-2 SDS step of the tiny avatar with its mesh part (64^2,
  tiles of 16, the tiny float32 guidance with its ControlNet, flash
  "on"), twice from copies of one model, state and generator: the
  metrics, every leaf after the update, its gradient and the densifier's
  statistics equal to the bit. B1's panel sum adds in a fixed order
  (``ops/blend_train.py:panel_grads``); ``index_add_`` did not.
* One DMTet SDS step (a tiny field, tet grid 12, the tiny guidance),
  twice from copies of one state and generator: the metrics, the field,
  sdf and deform after the update and their gradients equal to the bit
  (B1's panel sum and ``tet_laplacian_loss``'s fixed-order neighbour
  sums).
* ``panel_grads`` on the card adds a row's entries in (tile, slot) order:
  2^24, sixteen 1s, then -2^24 give 0 in float32, on every one of 20
  calls.
* ``ops/mesh.py:sample_faces`` on the card: 5,000 draws over the
  SMPL-X-sized body's faces from one generator state, 300 times, the same
  faces every time (``torch.multinomial`` drew another face in 2 of 300
  such calls on an H100).
"""
import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dreamwaltz_g_tpu_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("flash", ["on", "off"])
def test_stage1_step_repeats_to_the_bit(flash):
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC

    dev = _card()
    inputs = RC.stage1_inputs(dev)
    setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = flash
    try:
        (m1, g1, p1), (m2, g2, p2) = (RC.stage1_step(dev, *inputs)
                                      for _ in range(2))
    finally:
        TL.FLASH_ATTENTION = setting
    assert torch.backends.cudnn.deterministic
    assert m1 == m2
    assert max(float(g.abs().max()) for g in g1 if g.numel()) > 0.0
    assert RC.differ(g1, g2)["differing"] == 0
    assert RC.differ(p1, p2)["differing"] == 0


def test_export_repeats_to_the_bit():
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC

    (s1, c1), (s2, c2) = RC.export_twice(_card())
    assert s1 == s2 and s1["kept_cells"] > 0
    np.testing.assert_array_equal(c1.points, c2.points)
    np.testing.assert_array_equal(c1.colors, c2.colors)


S2, LATENT2 = 64, 32
RASTER2 = dict(tile_size=16, capacity=256, chunk=64)


def _tiny_guidance(dev):
    from dreamwaltz_g_tpu_torch import tests_support

    return tests_support.tiny_guidance(0, with_controlnet=True,
                                       latent_size=LATENT2, device=dev)


def _step_twice(make_base, run, snapshot):
    """``run(*copy of make_base())`` twice with one generator state."""
    base, gen = make_base()
    state = gen.get_state()
    out = []
    for _ in range(2):
        gen.set_state(state)
        out.append(snapshot(*run(*copy.deepcopy(base), gen)))
    return out


def test_stage2_step_repeats_to_the_bit():
    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import build_avatar_optimizer

    dev = _card()
    sd, gp = _tiny_guidance(dev)
    cam = make_camera_batch(2.0, 20.0, 90.0, 50.0, S2, S2,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    host = torch.Generator().manual_seed(0)
    txt = torch.randn((1, 4, 32), generator=host).to(dev)
    cond = torch.rand((1, S2, S2, 3), generator=host).to(dev)

    def make_base():
        setup = tests_support.tiny_avatar_setup(device=dev)
        tstate = G.init_avatar_train_state(
            setup.state, build_avatar_optimizer(RenderConfig(), 100),
            setup.model)
        return (setup.model, tstate, setup.observed), \
            torch.Generator(device=dev).manual_seed(0)

    def run(model, tstate, observed, gen):
        step = G.make_avatar_sds_step(model, sd, S2, S2, device=dev,
                                      **RASTER2)
        tstate, m = step(tstate, gp, observed, cam.extrinsic[0],
                         cam.intrinsics[0], cam.tanfov[0],
                         torch.zeros((S2, S2, 3), device=dev), txt,
                         torch.zeros_like(txt),
                         torch.tensor([500], device=dev), cond_image=cond,
                         guidance_scale=7.5, generator=gen)
        return model, tstate, m

    def snapshot(model, tstate, m):
        leaves = G._leaves(tstate.avatar, model)
        a = tstate.avatar
        return ({k: float(v) for k, v in m.items()},
                [t.detach().clone() for t in leaves],
                [torch.zeros(0) if t.grad is None else t.grad.clone()
                 for t in leaves],
                [a.alive, a.grad_accum, a.grad_denom, a.max_radii])

    setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = "on"
    BT.blend_train_bwd.launches = 0
    try:
        (m1, v1, g1, s1), (m2, v2, g2, s2) = _step_twice(make_base, run,
                                                         snapshot)
    finally:
        TL.FLASH_ATTENTION = setting
    assert BT.blend_train_bwd.launches == 2
    assert max(float(g.abs().max()) for g in g1 if g.numel()) > 0.0
    assert m1 == m2
    for a, b in ((v1, v2), (g1, g2), (s1, s2)):
        assert RC.differ(a, b)["differing"] == 0


def test_dmtet_step_repeats_to_the_bit():
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC
    from dreamwaltz_g_tpu_torch.training import dmtet_trainer as D
    from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer

    dev = _card()
    sd, gp = _tiny_guidance(dev)
    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, bound=1.0,
                     density_prior="gaussian")
    cam = make_camera_batch(2.5, 70.0, 30.0, 60.0, S2, S2, device=dev)
    host = torch.Generator().manual_seed(0)
    txt = torch.randn((1, 4, 32), generator=host).to(dev)
    bg = torch.rand((S2, S2, 3), generator=host).to(dev)
    cond = torch.rand((1, S2, S2, 3), generator=host).to(dev)

    def make_base():
        field = build_nerf(cfg, with_background=False,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
        model, dparams, edges = D.init_dmtet(field, 12, density_thresh=2.0)
        tstate = D.init_train_state(
            field, dparams, build_nerf_optimizer(cfg, 100),
            D.build_dmtet_optimizer(cfg, 100))
        return (tstate, model, edges), \
            torch.Generator(device=dev).manual_seed(0)

    def run(tstate, model, edges, gen):
        step = D.make_dmtet_sds_step(tstate.model, model, edges, sd, S2, S2,
                                     cfg, ambient_ratio=0.3, device=dev,
                                     capacity=2048, tile_size=16, chunk=64)
        new, m = step(tstate, gp, cam.extrinsic[0], cam.intrinsics[0],
                      cam.c2w[0][:3, 3], bg, txt, torch.zeros_like(txt),
                      torch.tensor([500], device=dev), generator=gen,
                      cond_image=cond, shading="lambertian")
        return new, m

    def snapshot(new, m):
        leaves = list(new.model.parameters()) + list(new.dmtet)
        return ({k: float(v) for k, v in m.items()},
                [t.detach().clone() for t in leaves],
                [torch.zeros(0) if t.grad is None else t.grad.clone()
                 for t in leaves])

    BT.blend_train_bwd.launches = 0
    (m1, v1, g1), (m2, v2, g2) = _step_twice(make_base, run, snapshot)
    assert BT.blend_train_bwd.launches == 2
    assert m1["mesh_laplacian_loss"] > 0
    assert m1 == m2
    assert RC.differ(v1, v2)["differing"] == 0
    assert RC.differ(g1, g2)["differing"] == 0


def test_panel_sum_order_on_the_card():
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    dev = _card()
    T, K, N = 6, 8, 10
    tl = torch.full((1, T, K), N, dtype=torch.int32)
    d = torch.zeros((1, T, K, 16))
    slots = [(t, k) for t in range(T) for k in (1, 3, 5)]
    for i, (t, k) in enumerate(slots):
        tl[0, t, k] = 3
        d[0, t, k] = 2.0 ** 24 if i == 0 else (
            -(2.0 ** 24) if i == len(slots) - 1 else 1.0)
    tl, d = tl.to(dev), d.to(dev)
    for _ in range(20):
        got = BT.panel_grads(d, tl, N + 1, 5)
        assert all(float(g[:, 3].abs().sum()) == 0.0 for g in got)


def test_sample_faces_repeat_on_the_card():
    from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model
    from dreamwaltz_g_tpu_torch.ops.mesh import sample_faces

    dev = _card()
    body = make_synthetic_model(num_vertices=10_475, num_joints=55,
                                num_betas=10, num_expr=10, device=dev)
    tri = body.v_template[torch.as_tensor(body.faces, device=dev).long()]
    area = torch.clamp(0.5 * torch.linalg.norm(torch.cross(
        tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1), dim=-1),
        min=1e-20)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = gen.get_state()
    first = sample_faces(area, 5000, gen)
    for _ in range(299):
        gen.set_state(state)
        assert torch.equal(sample_faces(area, 5000, gen), first)

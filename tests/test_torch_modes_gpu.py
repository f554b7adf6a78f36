"""The CLI's other modes on the card against the same calls on the CPU.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_modes_gpu.py -m gpu --noconftest -q

* ``make_nerf2gs_step`` (B1 forward and backward on the card, once each)
  on the tiny avatar from the same state and target: the loss within 1e-3
  relative, every leaf's gradient and the densification statistics within
  ``2e-3 |cpu| + 2e-4 peak`` (``chip_smoke.py``'s ``small_train``
  envelope); the CPU's plain blend under the kernels' per-pixel stop;
* ``ScoreDistillation.sample_images`` on the tiny float32 guidance with
  flash attention ``"on"`` (the kernels on the card, the plain version on
  the CPU), from the same noise, with and without the ControlNet (its
  zero convolutions given seeded values), on a DDIM grid that divides T
  and one that does not: the images within 5e-3
  (``chip_smoke.py``'s ``TOL_SMALL``), flash forwards launched, no
  backward;
* ``nerf.isosurface.export_mesh`` of a tiny field at resolution 16: the
  same face count within 1%, every vertex within 1e-4 of one of the
  CPU's and back, the vertex colors of matched vertices within 1e-4 (the
  density queries differ by float32 rounding, which can move a weld at
  the fifth decimal).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL_OF_MAX = 2e-3, 2e-4
REL_LOSS = 1e-3
TOL_IMAGE = 5e-3
TOL_MESH = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(x, dev):
    """Tensors and modules inside tuples, dicts and dataclasses, moved."""
    if torch.is_tensor(x) or isinstance(x, torch.nn.Module):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def _within(got, want, what, peak=None):
    got, want = got.detach().cpu(), want.detach().cpu()
    peak = want.abs().max() if peak is None else peak
    excess = float(((got - want).abs() - RTOL * want.abs()
                    - ATOL_OF_MAX * peak).max())
    assert excess <= 0.0, f"{what}: {excess} over the envelope"


def _nerf2gs(dev, S, target, alpha):
    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import (
        avatar_param_groups,
        build_avatar_optimizer,
    )

    tiny = tests_support.tiny_avatar_setup(device="cpu")
    model, state = _to(tiny.model, dev), _to(tiny.state, dev)
    tstate = G.init_avatar_train_state(
        state, build_avatar_optimizer(RenderConfig(), 5000), model)
    cam = make_camera_batch(2.0, 20.0, 90.0, 50.0, S, S,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    step = G.make_nerf2gs_step(model, S, S, tile_size=16, capacity=64,
                               chunk=32, device=dev)
    new, m = step(tstate, _to(tiny.observed, dev), cam.extrinsic[0],
                  cam.intrinsics[0], cam.tanfov[0],
                  torch.full((S, S, 3), 0.5, device=dev),
                  target.to(dev), alpha.to(dev))
    grads = {f"{k}[{i}]": p.grad for k, ps in avatar_param_groups(
        new.avatar.params, model).items() for i, p in enumerate(ps)}
    return float(m["loss"]), grads, new.avatar


def test_nerf2gs_step_card_matches_cpu(monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    S = 64
    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.uniform(size=(S, S, 3)), dtype=torch.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    alpha = torch.as_tensor(((yy - S / 2) ** 2 + (xx - S / 2) ** 2
                             < (S / 3) ** 2).astype(np.float32))
    want = _nerf2gs(torch.device("cpu"), S, target, alpha)
    BT.blend_train_fwd.launches = BT.blend_train_bwd.launches = 0
    got = _nerf2gs(dev, S, target, alpha)
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches) \
        == (1, 1)
    assert abs(got[0] - want[0]) <= REL_LOSS * abs(want[0])
    assert set(got[1]) == set(want[1])
    peak = max(float(g.abs().max()) for g in want[1].values()
               if g is not None)
    assert peak > 0.0
    for name, g in want[1].items():
        assert (got[1][name] is None) == (g is None), name
        if g is not None:
            _within(got[1][name], g, name, peak)
    for name in ("grad_accum", "grad_denom", "max_radii"):
        _within(getattr(got[2], name), getattr(want[2], name), name)


def _live_controlnet(cn):
    """The zero convolutions given values (seeded), so that the condition
    reaches the UNet."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for conv in [cn.controlnet_cond_embedding.conv_out,
                     cn.controlnet_mid_block, *cn.controlnet_down_blocks]:
            for t in (conv.weight, conv.bias):
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))


@pytest.mark.parametrize("steps", [10, 7])
@pytest.mark.parametrize("with_cond", [False, True])
def test_sample_images_card_matches_cpu(monkeypatch, steps, with_cond):
    dev = _card()
    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.guidance import flash as FL
    from dreamwaltz_g_tpu_torch.guidance import layers as TL

    monkeypatch.setattr(TL, "FLASH_ATTENTION", "on")
    L = 32           # 1,024 tokens in the tiny UNet's top level
    gen = torch.Generator().manual_seed(0)
    txt = torch.randn((1, 4, 32), generator=gen)
    unc = torch.zeros((1, 4, 32))
    noise = torch.randn((1, L, L, 4), generator=gen)
    cond = torch.rand((1, 2 * L, 2 * L, 3), generator=gen) \
        if with_cond else None
    images = {}
    for d in (torch.device("cpu"), dev):
        sd, gp = tests_support.tiny_guidance(0, with_controlnet=True,
                                             latent_size=L, device="cpu")
        _live_controlnet(gp.controlnet)
        gp = _to(gp, d)
        sd = dataclasses.replace(sd, schedule=sd.schedule.to(d))
        FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
        images[d.type] = sd.sample_images(
            gp, txt.to(d), unc.to(d), num_inference_steps=steps,
            guidance_scale=7.5, noise=noise.to(d),
            cond_image=None if cond is None else cond.to(d)).cpu()
    assert FL.flash_attn_fwd.launches > 0 and FL.flash_attn_bwd.launches == 0
    assert torch.isfinite(images["cuda"]).all()
    err = float((images["cuda"] - images["cpu"]).abs().max())
    assert err <= TOL_IMAGE, err


def test_export_mesh_card_matches_cpu():
    dev = _card()
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.nerf.isosurface import (
        export_mesh,
        make_tet_grid,
    )
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf

    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8)
    cpu = build_nerf(cfg, device="cpu")
    card = build_nerf(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    verts, _ = make_tet_grid(16, cpu.bound)
    with torch.no_grad():
        thresh = float(cpu.density(torch.as_tensor(verts))[0].median())
    (v0, f0, c0), (v1, f1, c1) = (
        export_mesh(m, resolution=16, density_thresh=thresh)
        for m in (cpu, card))
    assert len(f0) > 0 and abs(len(f1) - len(f0)) <= 0.01 * len(f0)
    assert f1.min() >= 0 and f1.max() < len(v1)
    d = torch.cdist(torch.as_tensor(v1), torch.as_tensor(v0),
                    compute_mode="donot_use_mm_for_euclid_dist")
    near = d.min(1)
    assert float(near.values.max()) <= TOL_MESH
    assert float(d.min(0).values.max()) <= TOL_MESH
    np.testing.assert_allclose(c1, c0[near.indices.numpy()], atol=TOL_MESH)

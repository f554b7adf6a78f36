"""The DMTet finetune and the vanilla avatar on the card against the same
calls on the CPU.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_geometry_gpu.py -m gpu --noconftest -q

Everything is built on the CPU and copied to the card, so both sides start
from the same field, tet band, avatar and guidance weights, and take the
same draws (the light, the SDS noise). The CPU's plain blends follow the
kernels' per-pixel stop (``PLAIN_STOP = "pixel"``). The DMTet render is
composited over a textured background: over a flat one the VAE's
GroupNorms see near-constant groups, where the card's and the CPU's
reductions part by ~5e-4 of the image gradient's largest entry before any
kernel of this path is reached.

* ``make_dmtet_sds_step`` at 64^2 (tiny triplane field, tet grid 12,
  tiny float32 guidance): B1 forward and backward once each; the loss
  within 1e-3 relative, the gradients of the field, sdf and deform within
  ``2e-3 |cpu| + 2e-4 peak`` (``chip_smoke.py``'s ``small_train``
  envelope). The tile capacity holds every entry (no overflow on either
  side): the entries a full tile drops are the deepest by a quantised
  depth key, which rounding can reorder between the devices;
* ``make_dmtet_eval_render``: B1's forward once, no backward; image,
  depth and alpha within 5e-3 (``chip_smoke.py``'s ``TOL_SMALL``);
* ``make_vanilla_sds_step`` on the tiny body's vanilla avatar: B1 once
  each; loss, the six ``GaussianParams`` gradients and the densification
  statistics in the same envelope;
* ``make_vanilla_render``: B2 once, no table blend; within 5e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL_OF_MAX = 2e-3, 2e-4
REL_LOSS = 1e-3
TOL_SMALL = 5e-3
S = 64
LATENT = S // 2
RASTER = dict(tile_size=16, capacity=256, chunk=64)
# the DMTet band's ~16k splat slots: no tile overflows at this capacity
DMTET_RASTER = dict(RASTER, capacity=2048)


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


def _within(got, want, what, peak=None, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got, want = got.detach().cpu(), want.detach().cpu()
    peak = want.abs().max() if peak is None else peak
    excess = float(((got - want).abs() - rtol * want.abs()
                    - atol_of_max * peak).max())
    assert excess <= 0.0, f"{what}: {excess} over the envelope"


def _guidance(dev):
    from dreamwaltz_g_tpu_torch import tests_support

    sd, gp = tests_support.tiny_guidance(0, latent_size=LATENT, device="cpu")
    return dataclasses.replace(sd, schedule=sd.schedule.to(dev)), \
        _to(gp, dev)


def _draws():
    gen = torch.Generator().manual_seed(0)
    return dict(txt=torch.randn((1, 4, 32), generator=gen),
                unc=torch.zeros((1, 4, 32)),
                t=torch.tensor([500]),
                noise=torch.randn((1, LATENT, LATENT, 4), generator=gen),
                light=torch.randn((3,), generator=gen),
                bg=torch.rand((S, S, 3), generator=gen))


def _dmtet(dev):
    """(field, DMTet model, train state, edges) built on the CPU, moved."""
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.training import dmtet_trainer as D
    from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer

    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, bound=1.0,
                     density_prior="gaussian")
    field = build_nerf(cfg, with_background=False,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    model, dparams, edges = D.init_dmtet(field, 12, density_thresh=2.0)
    field, model, dparams, edges = (_to(x, dev) for x in (field, model,
                                                          dparams, edges))
    tstate = D.init_train_state(field, dparams, build_nerf_optimizer(cfg, 100),
                                D.build_dmtet_optimizer(cfg, 100))
    return cfg, field, model, tstate, edges


def _run_dmtet(dev, x):
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.training import dmtet_trainer as D

    cfg, field, model, tstate, edges = _dmtet(dev)
    sd, gp = _guidance(dev)
    cam = make_camera_batch(2.5, 70.0, 30.0, 60.0, S, S, device=dev)
    step = D.make_dmtet_sds_step(field, model, edges, sd, S, S, cfg,
                                 ambient_ratio=0.3, device=dev,
                                 **DMTET_RASTER)
    new, m = step(tstate, gp, cam.extrinsic[0], cam.intrinsics[0],
                  cam.c2w[0][:3, 3], x["bg"].to(dev),
                  x["txt"].to(dev), x["unc"].to(dev), x["t"].to(dev),
                  light_noise=x["light"].to(dev), noise=x["noise"].to(dev),
                  shading="lambertian")
    grads = {n: p.grad for n, p in field.named_parameters()}
    grads.update(sdf=new.dmtet.sdf.grad, deform=new.dmtet.deform.grad)
    render = D.make_dmtet_eval_render(field, model, S, S, device=dev,
                                      **DMTET_RASTER)
    return float(m["loss"]), grads, (render, new, cam), \
        float(m["tile_overflow"])


def test_dmtet_step_and_eval_render_card_match_cpu(monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    x = _draws()
    want = _run_dmtet(torch.device("cpu"), x)
    BT.blend_train_fwd.launches = BT.blend_train_bwd.launches = 0
    got = _run_dmtet(dev, x)
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches) \
        == (1, 1)
    assert want[3] == got[3] == 0.0     # no tile overflows
    assert abs(got[0] - want[0]) <= REL_LOSS * abs(want[0])
    for name, g in want[1].items():
        assert (got[1][name] is None) == (g is None), name
        if g is not None:
            _within(got[1][name], g, name)
    assert float(want[1]["sdf"].abs().max()) > 0
    frames = []
    for (render, state, cam), d in ((want[2], "cpu"), (got[2], dev)):
        frames.append(render(state, cam.c2w[0], cam.intrinsics[0],
                             torch.full((3,), 0.5, device=d)))
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches) \
        == (2, 1)
    assert float(frames[0][2].max()) > 0.5
    for name, a, b in zip(("image", "depth", "alpha"), *frames):
        assert float((b.cpu() - a).abs().max()) <= TOL_SMALL * max(
            1.0, float(a.abs().max())), name


def _vanilla(dev, x):
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.human.smplx_model import (
        default_params,
        make_synthetic_model,
    )
    from dreamwaltz_g_tpu_torch.system import vanilla as V
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import (
        build_gaussian_optimizer,
    )

    smpl = make_synthetic_model(num_vertices=120, num_joints=6, num_betas=3,
                                num_expr=2, device="cpu")
    model = V.VanillaAvatarModel(smpl, default_params(smpl), max_scale=0.05)
    rng = np.random.default_rng(0)
    cloud = torch.as_tensor(rng.normal(size=(64, 3)) * 0.15 + [0, 0.7, 0],
                            dtype=torch.float32)
    state = V.init_vanilla_avatar(model, cloud, torch.as_tensor(
        rng.uniform(size=(64, 3)), dtype=torch.float32), capacity=96,
        init_scale=0.03, init_opacity=0.9)
    model, state = _to(model, dev), _to(state, dev)
    tstate = G.init_vanilla_train_state(
        state, build_gaussian_optimizer(RenderConfig(), 100))
    sd, gp = _guidance(dev)
    cam = make_camera_batch(2.0, 20.0, 90.0, 50.0, S, S,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    step = G.make_vanilla_sds_step(model, sd, S, S, device=dev, **RASTER)
    obs = default_params(model.smpl)
    args = (obs, cam.extrinsic[0], cam.intrinsics[0], cam.tanfov[0])
    new, m = step(tstate, gp, *args, torch.full((S, S, 3), 0.5, device=dev),
                  x["txt"].to(dev), x["unc"].to(dev), x["t"].to(dev),
                  campos=cam.c2w[0][:3, 3], noise=x["noise"].to(dev))
    g = new.avatar.gaussians
    grads = {n: getattr(g.params, n).grad for n in g.params._fields}
    image = G.make_vanilla_render(model, S, S, device=dev, **RASTER)(
        new.avatar, *args, torch.zeros((S, S, 3), device=dev))
    return float(m["loss"]), grads, g, image


def test_vanilla_step_and_render_card_match_cpu(monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch.ops import blend as B
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    x = _draws()
    want = _vanilla(torch.device("cpu"), x)
    BT.blend_train_fwd.launches = BT.blend_train_bwd.launches = 0
    B.blend_sorted.launches = BT.blend_tiles_eval_panels.launches = 0
    got = _vanilla(dev, x)
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches,
            B.blend_sorted.launches, BT.blend_tiles_eval_panels.launches) \
        == (1, 1, 1, 0)
    assert abs(got[0] - want[0]) <= REL_LOSS * abs(want[0])
    peak = max(float(g.abs().max()) for g in want[1].values())
    for name, g in want[1].items():
        if name == "quats":   # isotropic Gaussians: float32 noise in both
            assert float(got[1][name].abs().max()) <= 1e-5 * peak
            continue
        _within(got[1][name], g, name)
    for name in ("grad_accum", "grad_denom", "max_radii"):
        _within(getattr(got[2], name), getattr(want[2], name), name)
    assert float(want[3][1].max()) > 0.5
    for name, a, b in zip(("image", "alpha", "depth"), want[3], got[3]):
        assert float((b.cpu() - a).abs().max()) <= TOL_SMALL * max(
            1.0, float(a.abs().max())), name

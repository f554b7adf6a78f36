"""The B-view SDS steps of ``parallel/dp.py`` on the card against the same
calls on the CPU, at B = 2 views.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_dp_gpu.py -m gpu --noconftest -q

Everything is built on the CPU from seeds and copied to the card, so both
sides start from the same state and weights and take the same draws
(handed in); the CPU's plain blends follow the kernels' per-pixel stop
(``PLAIN_STOP = "pixel"``). Envelope of ``test_torch_scene_gpu.py``: the
loss within 1e-3 relative, every gradient within ``2e-3 |cpu| + 2e-4
peak``.

* ``make_avatar_sds_step_dp`` with a pose a view and the MLP background:
  B1 once forward and once backward for both views, each at V = 2; the
  flash forward of the tiny UNet at the CFG batch 4 and of its VAE at 2;
  the background's gradients too;
* ``make_vanilla_sds_step_dp`` with one pose: B1 (1, 1) at V = 2;
* ``make_nerf_sds_step_dp`` with sigma guidance, each view's jitter,
  noise and volume-sparsity draws handed in: no blend launch.
"""
import copy
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL_OF_MAX = 2e-3, 2e-4
REL_LOSS = 1e-3
B = 2
S = 64
LATENT = S // 2
RASTER = dict(tile_size=16, capacity=2048, chunk=64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(x, dev):
    """Tensors and modules inside tuples, lists, dicts and dataclasses,
    copied to ``dev`` (the CPU side too: each step updates its state in
    place)."""
    if torch.is_tensor(x):
        return x.detach().to(dev, copy=True)
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def _within(got, want, what):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    excess = float(((got - want).abs() - RTOL * want.abs()
                    - ATOL_OF_MAX * want.abs().max()).max())
    assert excess <= 0.0, f"{what}: {excess} over the envelope"


def _inputs():
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch

    gen = torch.Generator().manual_seed(0)
    cam = make_camera_batch([2.0, 2.3], [20.0, 60.0], [90.0, 150.0],
                            [50.0, 45.0], S, S, at_vector=((0.0, 0.7, 0.0),),
                            device="cpu")
    return dict(cam=cam, txt=torch.randn((B, 4, 32), generator=gen),
                unc=torch.zeros((B, 4, 32)), t=torch.tensor([500, 300]),
                noise=torch.randn((B, LATENT, LATENT, 4), generator=gen),
                bg=torch.rand((B, S, S, 3), generator=gen))


def _guidance():
    from dreamwaltz_g_tpu_torch import tests_support

    return tests_support.tiny_guidance(0, latent_size=LATENT, device="cpu")


def _on(dev, *xs):
    return [_to(x, dev) for x in xs]


def _compare(want, got, names):
    assert abs(got[0] - want[0]) <= REL_LOSS * abs(want[0])
    for name in names:
        g = want[1][name]
        assert (got[1][name] is None) == (g is None), name
        if g is not None:
            _within(got[1][name], g, name)


def _record(monkeypatch, seen):
    from dreamwaltz_g_tpu_torch.guidance import flash as FL
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    bt, fl = BT._launch, FL._launch
    monkeypatch.setattr(BT, "_launch", lambda name, *a: seen.append(
        (name, a[0].shape[0])) or bt(name, *a))
    monkeypatch.setattr(FL, "_launch", lambda name, dev, *a: seen.append(
        (name, a[0].shape[0])) or fl(name, dev, *a))


def test_avatar_dp_step_card_matches_cpu(monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.human.smplx_model import SMPLXParams
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.parallel.dp import make_avatar_sds_step_dp
    from dreamwaltz_g_tpu_torch.system.background import BackgroundMLPNet
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import (
        adan,
        build_avatar_optimizer,
    )

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    monkeypatch.setattr(TL, "FLASH_MIN_SEQ", 256)
    setup = tests_support.tiny_avatar_setup(device="cpu")
    obs = setup.observed
    gen = torch.Generator().manual_seed(4)
    obs = SMPLXParams(*[torch.cat([x, x + (0.3 * torch.randn(
        x.shape, generator=gen) if n == "body_pose" else 0.0)])
        for n, x in zip(obs._fields, obs)])
    net = BackgroundMLPNet(device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(3))
    sd, gp = _guidance()
    x = _inputs()
    res = {}
    seen = []
    for d in (torch.device("cpu"), dev):
        if d.type == "cuda":
            _record(monkeypatch, seen)
        model, state, o, bg_net, g, xd = _on(d, setup.model, setup.state,
                                             obs, net, gp, x)
        s = dataclasses.replace(sd, schedule=sd.schedule.to(d))
        tstate = G.init_avatar_train_state(
            state, build_avatar_optimizer(RenderConfig(), 100), model)
        tx = adan(1e-3, eps=1e-8, weight_decay=2e-5, max_grad_norm=5.0)
        step = make_avatar_sds_step_dp(
            model, s, S, S, per_view_poses=True, bg_net=bg_net, bg_tx=tx,
            device=d, **RASTER)
        cam = xd["cam"]
        new, _, m = step(tstate, g, o, cam.extrinsic, cam.intrinsics,
                         cam.tanfov, xd["bg"], xd["txt"], xd["unc"],
                         xd["t"], noise=xd["noise"],
                         bg_state=G.init_background_train_state(bg_net, tx),
                         c2w=cam.c2w)
        p = new.avatar.params
        grads = {n: getattr(p, n).grad
                 for n in ("positions", "log_scales", "lbs_weights")}
        grads["encoder"] = p.encoder[0].grad
        for name, q in list(model.sq_net.named_parameters()) + [
                (f"bg.{k}", v) for k, v in bg_net.named_parameters()]:
            grads[name] = q.grad
        grads["grad_accum"] = new.avatar.grad_accum
        res[d.type] = (float(m["loss"]), grads)
    assert sorted(set(seen)) == [("blend_train_bwd_f32", B),
                                 ("blend_train_fwd_f32", B),
                                 ("flash_attn_bwd", B),
                                 ("flash_attn_fwd", B),
                                 ("flash_attn_fwd", 2 * B)]
    assert seen.count(("blend_train_fwd_f32", B)) == 1
    assert seen.count(("blend_train_bwd_f32", B)) == 1
    _compare(res["cpu"], res["cuda"], res["cpu"][1])
    assert max(float(v.abs().max()) for k, v in res["cpu"][1].items()
               if k.startswith("bg.")) > 0


def test_vanilla_dp_step_card_matches_cpu(monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.human import smplx_model as SM
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.parallel.dp import make_vanilla_sds_step_dp
    from dreamwaltz_g_tpu_torch.system import vanilla as V
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import (
        build_gaussian_optimizer,
    )

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    smpl = SM.make_synthetic_model(120, 6, 3, 2, seed=0, device="cpu")
    vmodel = V.VanillaAvatarModel(smpl=smpl,
                                  canonical_inputs=SM.default_params(smpl),
                                  max_scale=0.05)
    gen = torch.Generator().manual_seed(1)
    cloud = torch.randn((64, 3), generator=gen) * 0.15 \
        + torch.tensor([0.0, 0.7, 0.0])
    vstate = V.init_vanilla_avatar(vmodel, cloud,
                                   torch.rand((64, 3), generator=gen),
                                   capacity=96, init_scale=0.03,
                                   init_opacity=0.9)
    sd, gp = _guidance()
    x = _inputs()
    res = {}
    for d in (torch.device("cpu"), dev):
        model, state, g, xd = _on(d, vmodel, vstate, gp, x)
        s = dataclasses.replace(sd, schedule=sd.schedule.to(d))
        ts = G.init_vanilla_train_state(
            state, build_gaussian_optimizer(RenderConfig(), 100))
        step = make_vanilla_sds_step_dp(model, s, S, S, device=d, **RASTER)
        BT.blend_train_fwd.launches = BT.blend_train_bwd.launches = 0
        cam = xd["cam"]
        new, m = step(ts, g, SM.default_params(model.smpl), cam.extrinsic,
                      cam.intrinsics, cam.tanfov, xd["bg"], xd["txt"],
                      xd["unc"], xd["t"], noise=xd["noise"])
        p = new.avatar.gaussians.params
        grads = {n: getattr(p, n).grad for n in ("means", "sh_dc",
                                                 "opacity_logit",
                                                 "log_scales")}
        grads["grad_accum"] = new.avatar.gaussians.grad_accum
        res[d.type] = (float(m["loss"]), grads)
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches) \
        == (1, 1)
    _compare(res["cpu"], res["cuda"], res["cpu"][1])


def test_nerf_dp_step_card_matches_cpu():
    dev = _card()
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.nerf.renderer import (
        init_occupancy,
        update_occupancy,
    )
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.parallel.dp import make_nerf_sds_step_dp
    from dreamwaltz_g_tpu_torch.training import nerf_trainer as N
    from dreamwaltz_g_tpu_torch.training.losses import (
        make_sigma_guidance_points,
        volume_sparsity_draws,
    )
    from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer
    from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model

    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, grid_size=16,
                     num_steps=16, compact_steps=8, lambda_opacity=1e-2)
    gen = torch.Generator().manual_seed(2)
    field = build_nerf(cfg, with_background=True, generator=gen,
                       device="cpu")
    grid = update_occupancy(init_occupancy(16, device="cpu"), field,
                            generator=gen, density_thresh=1e-4)
    smpl = make_synthetic_model(device="cpu")
    sigma = make_sigma_guidance_points(smpl.v_template, smpl.faces,
                                       num_points=64, generator=gen)
    sd, gp = _guidance()
    x = _inputs()
    draws = dict(
        jitter=torch.rand((B, S * S, 16), generator=gen),
        vs_draws=[volume_sparsity_draws(gen, field.bound, n_surface=S * S)
                  for _ in range(B)])
    bg = torch.rand((B, 3), generator=gen)
    res = {}
    for d in (torch.device("cpu"), dev):
        model, gr, g, xd, dr, sg, bgd = _on(d, field, grid, gp, x, draws,
                                            sigma, bg)
        s = dataclasses.replace(sd, schedule=sd.schedule.to(d))
        ts = N.init_train_state(model, build_nerf_optimizer(cfg, 100))
        step = make_nerf_sds_step_dp(model, s, S, S, cfg, num_steps=16,
                                     max_iteration=100, bg_mode="nerf",
                                     device=d)
        BT.blend_train_fwd.launches = 0
        cam = xd["cam"]
        _, m = step(ts, gr, g, cam.c2w, cam.intrinsics, bgd, xd["txt"],
                    xd["unc"], xd["t"], noise=xd["noise"], sigma_pts=sg,
                    use_sigma=True, **dr)
        res[d.type] = (float(m["loss"]), {n: q.grad for n, q in
                                          model.named_parameters()})
    assert BT.blend_train_fwd.launches == 0
    _compare(res["cpu"], res["cuda"], res["cpu"][1])

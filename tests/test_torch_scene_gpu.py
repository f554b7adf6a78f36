"""The scene options, the grid encoder and the guidance over a flat
background on the card against the same calls on the CPU.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_scene_gpu.py -m gpu --noconftest -q

Everything is built on the CPU and copied to the card, so both sides start
from the same avatar, background and guidance weights and take the same
draws. The CPU's plain blends follow the kernels' per-pixel stop
(``PLAIN_STOP = "pixel"``).

* ``make_avatar_sds_step_split`` in both branches (the MLP background's
  gradients and Adan update included) with the scene placement and a
  Gaussian background: B1 twice forward and once backward; the loss within
  1e-3 relative, every gradient within ``2e-3 |cpu| + 2e-4 peak``
  (``chip_smoke.py``'s ``small_train`` envelope);
* ``make_avatar_sds_step`` with the placement and the Gaussian background:
  B1 once each, the same envelope; the composed eval render
  (``make_avatar_render`` with an extra avatar, placed): B2 once, within
  5e-3 (``chip_smoke.py``'s ``TOL_SMALL``);
* ``grid_encode`` (8 levels, 2^16 tables, tiled and hash): the indices
  equal, the features within 1e-6 of the largest, the tables' gradient in
  the envelope;
* the tiny guidance's image gradient over a disc composited on a flat
  background and on noise (``ROADMAP.md`` queue C item 2), with the
  GroupNorms in float32 and in float64 on both devices: every case within
  the envelope; ``-s`` prints the gaps and the largest ``(mu^2 + var) /
  (var + eps)`` of the forward's groups;
* the DMTet eval render over a flat background fed to the guidance: on
  the same image (the CPU's) within the envelope; ``-s`` prints the two
  renders' difference and the gap of each device fed its own render.
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
RASTER = dict(tile_size=16, capacity=2048, chunk=64)
PLACEMENT = (0.9, (0.05, -0.02, 0.03))


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


def _excess(got, want, peak=None, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    peak = want.abs().max() if peak is None else peak
    return float(((got - want).abs() - rtol * want.abs()
                  - atol_of_max * peak).max())


def _within(got, want, what, **kw):
    excess = _excess(got, want, **kw)
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
                bg=torch.rand((S, S, 3), generator=gen))


def _background(tmp_path):
    """A seeded Gaussian scene on a shell around the tiny avatar."""
    from dreamwaltz_g_tpu_torch.system.background import (
        load_gaussian_background,
    )
    from dreamwaltz_g_tpu_torch.utils.point_cloud import save_gaussian_ply

    rng = np.random.default_rng(5)
    n = 300
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ply = save_gaussian_ply(
        str(tmp_path / "bg.ply"), d * 1.2 + np.asarray([0, 0.7, 0]),
        rng.normal(size=(n, 3)), None, rng.normal(size=n) + 1.0,
        np.full((n, 3), -2.5), rng.normal(size=(n, 4)))
    return load_gaussian_background(ply, device="cpu")


def _avatar(dev):
    from dreamwaltz_g_tpu_torch import tests_support

    setup = tests_support.tiny_avatar_setup(device="cpu")
    return _to(setup.model, dev), _to(setup.state, dev), \
        _to(setup.observed, dev)


def _bg_net(dev):
    from dreamwaltz_g_tpu_torch.system.background import BackgroundMLPNet

    net = BackgroundMLPNet(device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(3))
    return net.to(dev)


def _run_step(dev, x, bg, branch):
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G
    from dreamwaltz_g_tpu_torch.training.optim import (
        adan,
        build_avatar_optimizer,
    )

    model, state, obs = _avatar(dev)
    tstate = G.init_avatar_train_state(
        state, build_avatar_optimizer(RenderConfig(), 100), model)
    sd, gp = _guidance(dev)
    cam = make_camera_batch(2.0, 20.0, 90.0, 50.0, S, S,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    kw, bg_net, tx = {}, None, None
    if branch == "fused":
        step = G.make_avatar_sds_step(
            model, sd, S, S, device=dev, placement=PLACEMENT,
            static_gaussians=_to(bg, dev), max_tiles_per_gaussian=16,
            **RASTER)
    else:
        if branch == "mlp_background":
            bg_net = _bg_net(dev)
            tx = adan(1e-3, eps=1e-8, weight_decay=2e-5, max_grad_norm=5.0)
            kw = dict(bg_state=G.init_background_train_state(bg_net, tx),
                      c2w=cam.c2w[0])
        step = G.make_avatar_sds_step_split(
            model, sd, S, S, device=dev, placement=PLACEMENT,
            static_gaussians=_to(bg, dev), bg_net=bg_net,
            bg_tx=tx, **RASTER)
    res = step(tstate, gp, obs, cam.extrinsic[0], cam.intrinsics[0],
               cam.tanfov[0], x["bg"].to(dev), x["txt"].to(dev),
               x["unc"].to(dev), x["t"].to(dev), noise=x["noise"].to(dev),
               **kw)
    new, m = res[0], res[-1]
    p = new.avatar.params
    grads = {n: getattr(p, n).grad
             for n in ("positions", "log_scales", "lbs_weights")}
    grads["encoder"] = p.encoder[0].grad
    for net in ("color_mlp", "sq_net"):
        for n, q in getattr(model, net).named_parameters():
            grads[f"{net}.{n}"] = q.grad
    if bg_net is not None:
        for n, q in bg_net.named_parameters():
            grads[f"bg.{n}"] = q.grad
            grads[f"bg.{n}.updated"] = q.detach()
    return float(m["loss"]), grads, float(m["tile_overflow"])


@pytest.mark.parametrize("branch", ["fused", "plain", "mlp_background"])
def test_scene_steps_card_match_cpu(branch, tmp_path, monkeypatch):
    dev = _card()
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    x, bg = _draws(), _background(tmp_path)
    want = _run_step(torch.device("cpu"), x, bg, branch)
    BT.blend_train_fwd.launches = BT.blend_train_bwd.launches = 0
    got = _run_step(dev, x, bg, branch)
    assert (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches) \
        == ((1, 1) if branch == "fused" else (2, 1))
    assert want[2] == got[2] == 0.0          # no tile overflows
    assert abs(got[0] - want[0]) <= REL_LOSS * abs(want[0])
    for name, g in want[1].items():
        assert (got[1][name] is None) == (g is None), name
        if g is not None:
            _within(got[1][name], g, name)
    assert float(want[1]["positions"].abs().max()) > 0


def test_composed_render_card_matches_cpu(tmp_path):
    dev = _card()
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import blend as B
    from dreamwaltz_g_tpu_torch.training import gs_trainer as G

    bg = _background(tmp_path)
    frames = []
    for d in (torch.device("cpu"), dev):
        model, state, obs = _avatar(d)
        cam = make_camera_batch(2.5, 20.0, 90.0, 50.0, S, S,
                                at_vector=((0.0, 0.7, 0.0),), device=d)
        render = G.make_avatar_render(
            model, S, S, device=d, extra_models=(model,),
            placement=(0.9, ((0.25, 0.0, 0.0), (-0.25, 0.0, 0.0))),
            static_gaussians=_to(bg, d), max_tiles_per_gaussian=16,
            **RASTER)
        B.blend_sorted.launches = 0
        frames.append(render(state, obs, cam.extrinsic[0], cam.intrinsics[0],
                             cam.tanfov[0], torch.full((S, S, 3), 0.3,
                                                       device=d),
                             extra_states=(state,)))
    assert B.blend_sorted.launches == 1
    assert float(frames[0][1].mean()) > 0.3
    for name, a, b in zip(("image", "alpha", "depth"), *frames):
        assert float((b.cpu() - a).abs().max()) <= TOL_SMALL * max(
            1.0, float(a.abs().max())), name


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_grid_encode_card_matches_cpu(gridtype):
    dev = _card()
    from dreamwaltz_g_tpu_torch.nerf import encoder as E

    cfg = E.GridEncoderConfig(num_levels=8, log2_hashmap_size=16,
                              desired_resolution=512, gridtype=gridtype)
    gen = torch.Generator().manual_seed(0)
    tables = torch.randn((cfg.num_levels, cfg.max_table_size, 2),
                         generator=gen)
    pos = torch.rand((20_000, 3), generator=gen) * 2.2 - 1.1
    ct = torch.randn((20_000, cfg.output_dim), generator=gen)
    res = {}
    for d in (torch.device("cpu"), dev):
        t = tables.to(d).detach().requires_grad_(True)
        o = E.grid_encode(E.GridEncoderParams(t), cfg, pos.to(d))
        (o * ct.to(d)).sum().backward()
        res[d.type] = dict(out=o.detach().cpu(), grad=t.grad.cpu(), idx=[
            E._level_indices(torch.clamp((pos.to(d) + 1.0) * 0.5, 0.0, 1.0),
                             cfg.level_scale(lv), cfg.level_resolution(lv),
                             cfg.level_table_size(lv), gridtype)[0].cpu()
            for lv in range(cfg.num_levels)])
    want, got = res["cpu"], res[dev.type]
    assert float((got["out"] - want["out"]).abs().max()) <= 1e-6 * float(
        want["out"].abs().max())
    _within(got["grad"], want["grad"], "tables")
    for lv in range(cfg.num_levels):
        assert torch.equal(got["idx"][lv], want["idx"][lv]), lv


def _flat_render(radius: int, textured: bool):
    """A 64^2 render: a seeded textured disc of ``radius`` pixels over a
    flat gray background (or over noise with ``textured``)."""
    gen = torch.Generator().manual_seed(1)
    yy, xx = torch.meshgrid(torch.arange(S), torch.arange(S), indexing="ij")
    disc = ((yy - S / 2) ** 2 + (xx - S / 2) ** 2 < radius ** 2)[..., None]
    fg = torch.rand((S, S, 3), generator=gen)
    bg = torch.rand((S, S, 3), generator=gen) if textured \
        else torch.full((S, S, 3), 0.5)
    return torch.where(disc, fg, bg)


def _image_gradient(dev, image, x, group_norm_f64, kappas=None):
    from dreamwaltz_g_tpu_torch.guidance import layers as L

    orig = L.GroupNorm.forward

    def forward(self, h):
        if kappas is not None:
            g = h.detach().double().reshape(h.shape[0], self.num_groups, -1)
            mu, var = g.mean(-1), g.var(-1, unbiased=False)
            kappas.append(float(((mu * mu + var) / (var + self.eps)).max()))
        if not group_norm_f64:
            return orig(self, h)
        hh, w, b = L.promote(h, self.weight, self.bias)
        return torch.nn.functional.group_norm(
            hh.double(), self.num_groups, w.double(), b.double(),
            self.eps).to(hh.dtype)

    sd, gp = _guidance(dev)
    img = image.to(dev)[None].clone().requires_grad_(True)
    L.GroupNorm.forward = forward
    try:
        out = sd(gp, img, x["txt"].to(dev), x["unc"].to(dev),
                 x["t"].to(dev), noise=x["noise"].to(dev))
        out["loss"].backward()
    finally:
        L.GroupNorm.forward = orig
    return img.grad[0].cpu()


def test_flat_background_guidance_card_matches_cpu():
    """The image gradient of a small and a large disc over a flat gray
    background and over noise, card against CPU, with the GroupNorms in
    float32 and in float64: within the envelope in every case."""
    dev = _card()
    x = _draws()
    report = {}
    for radius in (3, 16):
        for textured in (False, True):
            image = _flat_render(radius, textured)
            kappas = []
            grads = {}
            for f64 in (False, True):
                want = _image_gradient(torch.device("cpu"), image, x, f64,
                                       None if f64 else kappas)
                got = _image_gradient(dev, image, x, f64)
                grads[f64] = (got, want)
            peak = float(grads[False][1].abs().max())
            report[(radius, textured)] = dict(
                gap_f32=float((grads[False][0] - grads[False][1]).abs().max())
                / peak,
                gap_group_norm_f64=float(
                    (grads[True][0] - grads[True][1]).abs().max()) / peak,
                kappa=max(kappas),
                excess=max(_excess(*grads[False]), _excess(*grads[True])))
    print("flat_background", report)
    for key, r in report.items():
        assert r["excess"] <= 0.0, (key, r)


def test_dmtet_render_over_a_flat_background_guidance(monkeypatch):
    """The DMTet eval render over a flat background (the case PR 15's card
    run parted on), fed to the guidance: on the same image (the CPU's) the
    card's image gradient is the CPU's within the envelope; fed each
    device's own render, the two renders' float32 difference is what the
    gradients part by, amplified by the guidance over the flat area."""
    dev = _card()
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.training import dmtet_trainer as D

    monkeypatch.setattr(BT, "PLAIN_STOP", "pixel")
    x = _draws()
    imgs = {}
    # test_torch_geometry_gpu.py's DMTet field and band, on the CPU, moved
    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, bound=1.0,
                     density_prior="gaussian")
    field = build_nerf(cfg, with_background=False,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    model, dparams, _ = D.init_dmtet(field, 12, density_thresh=2.0)
    for d in (torch.device("cpu"), dev):      # the field moves, in place
        cam = make_camera_batch(2.5, 70.0, 30.0, 60.0, S, S, device=d)
        render = D.make_dmtet_eval_render(
            _to(field, d), _to(model, d), S, S, device=d,
            **dict(RASTER, capacity=2048))
        with torch.no_grad():
            img, _, alpha = render(
                D.DMTetTrainState(field, _to(dparams, d), None, 0),
                cam.c2w[0], cam.intrinsics[0],
                torch.full((3,), 0.5, device=d))
        imgs[d.type] = img.cpu()
    cpu_img = imgs["cpu"]
    want = _image_gradient(torch.device("cpu"), cpu_img, x, False)
    same = _image_gradient(dev, cpu_img, x, False)
    own = _image_gradient(dev, imgs[dev.type], x, False)
    peak = float(want.abs().max())
    report = dict(
        render_gap=float((imgs[dev.type] - cpu_img).abs().max()),
        flat_share=float((alpha.cpu() < 1e-3).float().mean()),
        gap_same_image=float((same - want).abs().max()) / peak,
        gap_own_render=float((own - want).abs().max()) / peak,
        excess_same_image=_excess(same, want),
        excess_own_render=_excess(own, want))
    print("dmtet_flat_background", report)
    assert report["excess_same_image"] <= 0.0

"""The stage-1 NeRF SDS step of the port against the JAX package, whole: a
tiny triplane field (carried over by ``convert.nerf_state_from_numpy``)
and the tiny guidance with its ControlNet (weights through
``convert.py``), in float32 on the CPU, with the JAX draws handed to the
port: the render's jitter (the JAX step's ``k_render``), the SDS noise
(``k_sds``) and the volume-sparsity points and picks (``k_vs``).

JAX side: ``jax.value_and_grad`` of the step's loss, built as
``make_nerf_sds_step``'s ``loss_fn`` is, then the optax update (times the
'ddpm' weight where the step has one). The loss and the sigma loss within
1e-4 relative, each gradient within 2e-3 relative plus 2e-4 of its largest
entry, the updated parameters where the gradient is well above rounding
(Adam's first step is +-lr sign(g) at eps = 1e-15) within 1e-6. The SDS
loss, sum(latents * grad), is a sum whose terms cancel to ~0.2% of their
magnitudes on these renders (0.296 of sum |latents * grad| = 164), so it
is held to 1e-4 of that sum: on the same image the two guidance stacks
alone differ by 6e-5 relative in it, with latent gradients equal to 3e-6
of their largest entry.

Case "plain": no ray chunks, the background MLP composited (``bg_mode =
"nerf"``), ray sparsity (``lambda_opacity``), volume sparsity and sigma
guidance. Case "chunked_flash": the same with the rays marched in
checkpointed chunks of 300 (the last one padded; every chunk takes the
same jitter, as in the JAX package), ``FLASH_ATTENTION = "on"`` in both
packages with the length gate at the tiny models' 256 tokens (the JAX
side through its interpreted TPU kernel, the port through the flash
wrapper's plain version), ``detach_bg_weights_sum``, the masked
pixel-gradient hook and the 'ddpm' per-timestep lr weights.

Then ``make_pretrain_step`` against the JAX step (one update), and the
entry points' CUDA default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import GuideConfig as JGuideConfig
from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.guidance import layers as JL
from dreamwaltz_g_tpu.guidance import sds as JS
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.guidance.time_prior import TimePrioritizedLR as JTPLR
from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model as jsmpl
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf import renderer as JR
from dreamwaltz_g_tpu.training import losses as JLo
from dreamwaltz_g_tpu.training import nerf_trainer as JT
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import GuideConfig, NeRFConfig
from dreamwaltz_g_tpu_torch.guidance import layers as TL
from dreamwaltz_g_tpu_torch.guidance import sds as TS
from dreamwaltz_g_tpu_torch.guidance.time_prior import TimePrioritizedLR
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.nerf.renderer import OccupancyGrid
from dreamwaltz_g_tpu_torch.training import nerf_trainer as TT
from dreamwaltz_g_tpu_torch.training.losses import (SigmaGuidancePoints,
                                                    VolumeSparsityDraws)
from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer
import tests.torch_threads  # noqa: F401  (per-worker threads)

H = W = 32
LATENT = 16                 # the tiny VAE halves: a 32^2 render
STEPS = 16
MAX_IT = 100
FIELD = dict(triplane_resolution=16, triplane_dim=8, grid_size=16,
             num_steps=STEPS, compact_steps=8, lambda_opacity=1e-2)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4
UPDATE_MIN_GRAD = 1e-3
CASES = {
    "plain": dict(ray_chunk=0, flash=False, detach=False, hook=None,
                  tp_lr=False),
    "chunked_flash": dict(ray_chunk=300, flash=True, detach=True,
                          hook=dict(grad_rgb_clip=True,
                                    grad_rgb_clip_mask_guidance=True),
                          tp_lr=True),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _guidance_trees():
    """The JAX tiny guidance's trees, the ControlNet's zero convs given
    values so that it reaches the UNet."""
    jsd, jgp = jts.tiny_guidance(jax.random.PRNGKey(0), with_controlnet=True,
                                 latent_size=LATENT)
    rng = np.random.default_rng(1)
    trees = {k: jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       getattr(jgp, k))
             for k in ("unet", "vae", "controlnet")}
    for name, mod in trees["controlnet"]["params"].items():
        if name.startswith("controlnet_") and \
                name != "controlnet_cond_embedding":
            for k in mod:
                mod[k] = rng.normal(size=mod[k].shape).astype(np.float32) * .2
    return jsd, trees


def _field(cfg_fields):
    """The JAX field, a grid refreshed once from it, and the port's twins."""
    jcfg = JNeRFConfig(**cfg_fields)
    jmodel = JN.build_nerf(jcfg, with_background=True)
    params = jmodel.init(jax.random.PRNGKey(1))
    grid = JR.update_occupancy(JR.init_occupancy(jcfg.grid_size), jmodel,
                               params, jax.random.PRNGKey(2))
    tmodel = TN.build_nerf(NeRFConfig(**cfg_fields), with_background=True,
                           device="cpu")
    convert.nerf_state_from_numpy(_np(params), tmodel)
    tgrid = OccupancyGrid(*[torch.as_tensor(np.array(x)) for x in grid])
    return jcfg, jmodel, params, grid, tmodel, tgrid


# the csd family's annealed mix: the negative branch and the run's progress
CSD = dict(loss_type="csd", progress=0.4)


def _make_case(name, family=None):
    """The case's JAX results and the port's twin inputs; ``family`` (e.g.
    ``CSD``) sets the loss family and the step's ``progress``, with a
    negative branch drawn here."""
    c = CASES[name]
    fields = dict(FIELD, detach_bg_weights_sum=c["detach"])
    jcfg, jmodel, params, grid, tmodel, tgrid = _field(fields)
    occ = float(np.asarray(grid.occupied).mean())
    assert 0.1 < occ < 0.9, occ              # the compaction has work
    jsd, trees = _guidance_trees()
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})
    jc = jcamera(2.5, 30.0, 80.0, 50.0, H, W)
    smpl = jsmpl(num_vertices=120, num_joints=6, seed=0)
    sigma_pts = JLo.make_sigma_guidance_points(
        jax.random.PRNGKey(4), smpl.v_template, jnp.asarray(smpl.faces),
        num_points=64)
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = dict(txt=rng.normal(size=(1, 4, 32)).astype(f32),
             unc=np.zeros((1, 4, 32), f32), t=np.array([600], np.int32),
             cond=rng.uniform(size=(1, H, W, 3)).astype(f32),
             bg=np.array([0.3, 0.5, 0.7], f32))
    fam = {}
    if family is not None:
        import dataclasses

        jsd = dataclasses.replace(jsd, loss_type=family["loss_type"])
        x["neg"] = rng.normal(size=(1, 4, 32)).astype(f32)
        fam = dict(neg_embeds=x["neg"], progress=family["progress"])
    key = jax.random.PRNGKey(3)
    k_render, k_sds, k_vs = jax.random.split(key, 3)
    b = jcfg.bound
    n_sh = 4096 // 2
    k_u, k_pick, k_axis, k_coord = jax.random.split(k_vs, 4)
    draws = dict(
        jitter=jax.random.uniform(k_render, TT.jitter_shape(
            H, W, c["ray_chunk"], STEPS)),
        noise=jax.random.normal(jax.random.split(k_sds)[0],
                                (1, LATENT, LATENT, 4)),
        vs=VolumeSparsityDraws(
            uniform=jax.random.uniform(k_u, (4096 - n_sh, 3), minval=-b,
                                       maxval=b),
            pick=jax.random.randint(k_pick, (n_sh,), 0, H * W),
            axis=jax.random.randint(k_axis, (n_sh,), 0, 3),
            coord=jax.random.uniform(k_coord, (n_sh, 1), minval=-b,
                                     maxval=b),
            fallback=jax.random.uniform(k_pick, (n_sh, 3), minval=-b,
                                        maxval=b)))
    jpgc = None if c["hook"] is None else JS.build_pixel_grad_hook(
        JGuideConfig(**c["hook"]))

    def loss_fn(p):
        # make_nerf_sds_step's loss_fn, step 0
        img, ren_depth, wsum = JT._render_image(
            jmodel, p, grid, jc.c2w[0], jc.intrinsics[0], H, W, k_render,
            STEPS, x["bg"], bg_mode="nerf", ray_chunk=c["ray_chunk"],
            min_near=jcfg.min_near, compact_steps=jcfg.compact_steps,
            detach_bg_ws=jcfg.detach_bg_weights_sum)
        if jpgc is not None:
            img = jpgc(img, jax.lax.stop_gradient(wsum)[..., None])
        sds = jsd(jgp, img[None], x["txt"], x["unc"], x["t"], k_sds,
                  cond_image=x["cond"], **fam)
        terms = jnp.sum(jnp.abs(jax.lax.stop_gradient(sds["latents"])
                                * sds["gradients"]))
        loss = sds["loss"] + JLo.sparsity_loss(wsum.reshape(-1), jcfg, 0,
                                               MAX_IT)
        rays_o, rays_d = JT.get_rays(jc.c2w[0][None], jc.intrinsics[0][None],
                                     H, W)
        surf = rays_o[0] + rays_d[0] * jax.lax.stop_gradient(
            ren_depth).reshape(-1, 1)
        loss = loss + jcfg.triplane_volume_sparsity * \
            JLo.volume_sparsity_loss(
                jmodel, p, k_vs, surface_points=surf,
                surface_valid=jax.lax.stop_gradient(wsum).reshape(-1) > 0.5)
        sg = JLo.sigma_margin_loss(jmodel, p, sigma_pts)
        return loss + sg, (sds["loss"], terms, sg, wsum)

    if c["flash"]:
        old = (JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ)
        JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ = "on", 256
        try:
            with pltpu.force_tpu_interpret_mode():
                out = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                    params)
        finally:
            JL.FLASH_ATTENTION, JL.FLASH_MIN_SEQ = old
    else:
        out = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    (loss, (sds_loss, sds_terms, sg, wsum)), grads = out
    assert float(np.asarray(wsum).max()) > 0.3       # the field shows
    tx = JO.build_nerf_optimizer(jcfg, MAX_IT)
    upd, _ = tx.update(grads, tx.init(params), params)
    weights = None
    if c["tp_lr"]:
        weights = JTPLR(jsd.schedule).weights
        np.testing.assert_array_equal(
            TimePrioritizedLR(TS.make_schedule(device="cpu")).weights, weights)
        upd = jax.tree_util.tree_map(lambda u: u * weights[x["t"][0]], upd)
    new = optax.apply_updates(params, upd)
    jax_out = dict(loss=float(loss), sds_loss=float(sds_loss),
                   sds_terms=float(sds_terms), sigma_loss=float(sg),
                   grads=_np(grads), new=_np(new))

    tsd, tgp = tts.tiny_guidance(1, with_controlnet=True, latent_size=LATENT,
                                 device="cpu")
    if family is not None:
        tsd.loss_type = family["loss_type"]
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    T = torch.as_tensor
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    tc = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W, device="cpu")
    port = dict(
        cfg=NeRFConfig(**fields), model=tmodel, grid=tgrid, sd=tsd, gp=tgp,
        cam=(tc.c2w[0], tc.intrinsics[0]),
        x={k: T(v) for k, v in x.items()},
        draws=dict(jitter=T(np.asarray(draws["jitter"])),
                   noise=T(np.asarray(draws["noise"])),
                   vs_draws=VolumeSparsityDraws(
                       *[T(np.asarray(d)) for d in draws["vs"]])),
        sigma_pts=SigmaGuidancePoints(*[T(np.asarray(p))
                                        for p in sigma_pts]),
        tp_lr_weights=None if weights is None else T(
            TimePrioritizedLR(tsd.schedule).weights),
        pgc=None if c["hook"] is None else TS.build_pixel_grad_hook(
            GuideConfig(**c["hook"])),
        progress=None if family is None else family["progress"])
    return c, jax_out, port


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _make_case(request.param)


def _pairs(model, tree):
    """(name, torch parameter, JAX array in torch layout) for every
    weight of the field."""
    out = [(model.enc_name, getattr(model, model.enc_name),
            tree.encoder[0])]
    for mlp in ("sigma_mlp", "bg_mlp"):
        for lname, lin in getattr(model, mlp).named_children():
            leaf = getattr(tree, mlp)["params"][lname]
            out.append((f"{mlp}.{lname}.kernel", lin.weight,
                        np.asarray(leaf["kernel"]).T))
            out.append((f"{mlp}.{lname}.bias", lin.bias, leaf["bias"]))
    return out


def _check_grad(name, got, want):
    want = np.asarray(want)
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float((err - bound).max()),
                                  float(np.abs(want).max()))


def test_nerf_sds_step_matches_jax(case, monkeypatch):
    """``make_nerf_sds_step`` on the CPU: the loss and its parts, every
    weight's gradient, and the updated weights after one step."""
    c, jax_out, port = case
    calls = []
    if c["flash"]:
        monkeypatch.setattr(TL, "FLASH_ATTENTION", "on")
        monkeypatch.setattr(TL, "FLASH_MIN_SEQ", 256)
        flash = TL.flash_self_attention
        monkeypatch.setattr(TL, "flash_self_attention",
                            lambda *a: calls.append(a[0].shape) or flash(*a))
    model = port["model"]
    before = {id(p): p.detach().clone() for p in model.parameters()}
    tstate = TT.init_train_state(model, build_nerf_optimizer(port["cfg"],
                                                             MAX_IT))
    step = TT.make_nerf_sds_step(
        model, port["sd"], H, W, port["cfg"], num_steps=STEPS,
        max_iteration=MAX_IT, bg_mode="nerf", ray_chunk=c["ray_chunk"],
        pgc=port["pgc"], tp_lr_weights=port["tp_lr_weights"],
        neg_embeds=port["x"].get("neg"), device="cpu")
    x = port["x"]
    new, metrics = step(tstate, port["grid"], port["gp"], *port["cam"],
                        x["bg"], x["txt"], x["unc"], x["t"],
                        cond_image=x["cond"], sigma_pts=port["sigma_pts"],
                        use_sigma=True, progress=port["progress"],
                        **port["draws"])
    assert new.step == 1
    for k in ("loss", "sigma_loss"):
        np.testing.assert_allclose(float(metrics[k]), jax_out[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert abs(float(metrics["sds_loss"]) - jax_out["sds_loss"]) \
        <= LOSS_RTOL * jax_out["sds_terms"]
    if c["flash"]:
        assert sorted(set(calls)) == [(1, 256, 1, 64), (2, 256, 2, 16)]
    g = jax_out["grads"]
    for name, p, want in _pairs(model, g):
        _check_grad(name, p.grad.numpy(), want)
    assert float(np.abs(np.asarray(g.bg_mlp["params"]["dense_0"]["kernel"])
                        ).max()) > 0           # the background is trained
    jnew = jax_out["new"]
    for (name, p, want), (_, _, gw) in zip(_pairs(model, jnew),
                                           _pairs(model, g)):
        gw = np.abs(np.asarray(gw))
        sure = gw > UPDATE_MIN_GRAD * max(gw.max(), 1e-30)
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   np.asarray(want)[sure], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        assert not torch.equal(p.detach(), before[id(p)]), name


def test_nerf_sds_step_csd_with_progress_matches_jax(monkeypatch):
    """The "plain" case on the csd family's annealed mix: the constructor's
    ``neg_embeds`` and the step's ``progress`` reach the guidance."""
    test_nerf_sds_step_matches_jax(_make_case("plain", family=CSD),
                                   monkeypatch)


def test_pretrain_step_matches_jax():
    """``make_pretrain_step``: one update of the depth / mask fit with the
    volume-sparsity prior seeded from the ground-truth surface."""
    jcfg, jmodel, params, grid, tmodel, tgrid = _field(FIELD)
    jc = jcamera(2.5, 30.0, 80.0, 50.0, H, W)
    rng = np.random.default_rng(5)
    gt_mask = rng.uniform(size=(H, W)) < 0.4
    gt_depth = rng.uniform(1.5, 3.5, (H, W)).astype(np.float32)
    tx = JO.build_nerf_optimizer(jcfg, MAX_IT)
    jstep = JT.make_pretrain_step(jmodel, tx, H, W, num_steps=STEPS,
                                  compact_steps=jcfg.compact_steps)
    key = jax.random.PRNGKey(7)
    jnew, jm = jstep(JT.init_train_state(jmodel, tx, None, params), grid,
                     jc.c2w[0], jc.intrinsics[0], jnp.asarray(gt_depth),
                     jnp.asarray(gt_mask), key)
    k_render, k_vs = jax.random.split(key)
    n_sh = 2048
    k_u, k_pick, k_axis, k_coord = jax.random.split(k_vs, 4)
    b = jcfg.bound
    vs = VolumeSparsityDraws(*[torch.as_tensor(np.asarray(a)) for a in (
        jax.random.uniform(k_u, (4096 - n_sh, 3), minval=-b, maxval=b),
        jax.random.randint(k_pick, (n_sh,), 0, H * W),
        jax.random.randint(k_axis, (n_sh,), 0, 3),
        jax.random.uniform(k_coord, (n_sh, 1), minval=-b, maxval=b),
        jax.random.uniform(k_pick, (n_sh, 3), minval=-b, maxval=b))])
    jitter = torch.as_tensor(np.asarray(jax.random.uniform(
        k_render, (H * W, STEPS))))
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    tc = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W, device="cpu")
    tstate = TT.init_train_state(tmodel, build_nerf_optimizer(
        NeRFConfig(**FIELD), MAX_IT))
    tstep = TT.make_pretrain_step(tmodel, H, W, num_steps=STEPS,
                                  compact_steps=FIELD["compact_steps"],
                                  device="cpu")
    new, m = tstep(tstate, tgrid, tc.c2w[0], tc.intrinsics[0],
                   torch.as_tensor(gt_depth), torch.as_tensor(gt_mask),
                   jitter=jitter, vs_draws=vs)
    for k in ("loss", "mask_loss", "depth_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    grads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()
             if p.grad is not None}
    assert grads["planes"].any()
    for name, p, want in _pairs(tmodel, _np(jnew.params)):
        if name.startswith("bg_mlp"):       # the pretrain has no background
            continue
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-6, err_msg=name)


def _entry_points():
    cfg = NeRFConfig(**FIELD)

    def model():
        return TN.build_nerf(cfg, device="cpu")

    sd, _ = tts.tiny_guidance(0, device="cpu")
    return {
        "build_nerf": lambda: TN.build_nerf(cfg),
        "make_nerf_sds_step": lambda: TT.make_nerf_sds_step(
            model(), sd, 8, 8, cfg),
        "make_pretrain_step": lambda: TT.make_pretrain_step(model(), 8, 8),
        "make_eval_render": lambda: TT.make_eval_render(model(), 8, 8),
    }


@pytest.mark.parametrize("name", ["build_nerf", "make_nerf_sds_step",
                                  "make_pretrain_step", "make_eval_render"])
def test_stage1_entry_point_defaults_to_cuda(name):
    """Without ``device=`` a stage-1 entry point asks for CUDA, and on a
    machine without it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_eval_render_and_occupancy_cadence():
    """``maybe_update_occupancy`` refreshes at steps divisible by the
    interval only; ``make_eval_render`` gives finite (H, W) outputs with
    weights in [0, 1]."""
    cfg = NeRFConfig(**FIELD)
    model = TN.build_nerf(cfg, device="cpu")
    tstate = TT.init_train_state(model, build_nerf_optimizer(cfg, MAX_IT))
    from dreamwaltz_g_tpu_torch.nerf.renderer import init_occupancy
    grid = init_occupancy(cfg.grid_size, device="cpu")
    gen = torch.Generator().manual_seed(0)
    same = TT.maybe_update_occupancy(tstate._replace(step=3), grid, model,
                                     generator=gen)
    assert same is grid
    grid = TT.maybe_update_occupancy(tstate, grid, model, generator=gen)
    assert 0 < float(grid.occupied.float().mean()) < 1
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    tc = make_camera_batch(2.5, 30.0, 80.0, 50.0, 16, 16, device="cpu")
    img, depth, ws = TT.make_eval_render(model, 16, 16, num_steps=STEPS,
                                         device="cpu")(
        grid, tc.c2w[0], tc.intrinsics[0], torch.zeros(3))
    assert img.shape == (16, 16, 3) and depth.shape == ws.shape == (16, 16)
    assert bool(torch.isfinite(img).all())
    assert float(ws.min()) >= 0 and float(ws.max()) <= 1 + 1e-6

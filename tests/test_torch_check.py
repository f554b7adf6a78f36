"""The sanity exports and the NeRF pretrain of the port against the JAX
package, on the CPU: ``ScoreDistillation.sample_images`` (the
``--log.check_sd`` DDIM sampler), ``Trainer.check`` / ``_check_sd`` and
``Trainer.pretrain``.

* ``sample_images`` on the tiny float32 guidance (the JAX package's tiny
  UNet, VAE and ControlNet with seeded weights, converted to the port by
  ``convert.py``), from the JAX draw of the noise, with and without a
  ControlNet image, on a DDIM grid that divides T = 1000 (10 steps) and
  one that does not (7 steps, stride 142: the last step's t_next is
  negative and alpha-bar is 1 there): the images within 1e-4 of their
  largest pixel (float32 through every step of the UNet and ControlNet
  and the VAE decoder in two frameworks);
* ``check``: the condition images at the four azimuths equal to the ones
  the JAX trainer's own ``check`` writes (run on a namespace of the JAX
  providers), the timestep curve written by both, the scheduler's
  generator left in the same state; with ``check_sd`` the samples' files;
* ``pretrain``: the JAX trainer's own method on a namespace of the JAX
  providers, its step replaced by a recorder, hands its step the same
  cameras (within 1e-5), SMPL-X depths (within 1e-4) and masks (equal) as
  the port's trainer hands its real step (``make_pretrain_step`` itself is
  held to the JAX step in ``tests/test_torch_nerf_step.py``); the port's
  run writes its checkpoint and ``--log.resume_pretrain`` reuses it.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.guidance.controlnet import ControlNet as JControlNet
from dreamwaltz_g_tpu.guidance.sds import GuidanceParams as JGP
from dreamwaltz_g_tpu.guidance.sds import ScoreDistillation as JSD
from dreamwaltz_g_tpu.guidance.unet import UNet2DCondition as JUNet
from dreamwaltz_g_tpu.guidance.unet import tiny_unet_config as jtiny_unet
from dreamwaltz_g_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamwaltz_g_tpu.guidance.vae import tiny_vae_config as jtiny_vae
from dreamwaltz_g_tpu.training import nerf_trainer as JNT
from dreamwaltz_g_tpu.training.trainer import Trainer as JTrainer
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import parse_args
from dreamwaltz_g_tpu_torch.main import main
from dreamwaltz_g_tpu_torch.training.trainer import Trainer
from dreamwaltz_g_tpu_torch.utils.media import load_image
import tests.torch_threads  # noqa: F401  (per-worker threads)

LATENT = 16          # the tiny VAE doubles: 32^2 images
IMAGE_TOL_OF_MAX = 1e-4


def _seeded(tree, rng):
    """A Flax parameter tree of ``tree``'s shapes: fan-in-scaled normal
    kernels, norm scales near 1, small biases."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            w = 0.1 * rng.normal(size=s.shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def guidance():
    """The JAX tiny stack with seeded weights (shapes from ``eval_shape``:
    no Flax initialisation runs) and the port's twin."""
    ucfg = jtiny_unet()
    unet, vae = JUNet(ucfg), JVAE(jtiny_vae())
    cn = JControlNet(ucfg, cond_block_channels=(16, 32))
    key = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, LATENT, LATENT, 4))
    t = jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 4, ucfg.cross_attention_dim))
    rng = np.random.default_rng(0)
    trees = {
        "unet": _seeded(jax.eval_shape(unet.init, key, lat, t, ctx), rng),
        "vae": _seeded(jax.eval_shape(
            lambda k: vae.init(k, image_size=2 * LATENT), key), rng),
        "controlnet": _seeded(jax.eval_shape(
            cn.init, key, lat, t, ctx,
            jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3))), rng)}
    jsd = JSD(unet=unet, vae=vae, controlnet=cn, latent_size=LATENT,
              guidance_scale=7.5)
    jgp = JGP(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                 for k, v in trees.items()})
    tsd, tgp = tts.tiny_guidance(0, with_controlnet=True, latent_size=LATENT,
                                 device="cpu")
    convert.unet_from_flax(tgp.unet, trees["unet"])
    convert.vae_from_flax(tgp.vae, trees["vae"])
    convert.controlnet_from_flax(tgp.controlnet, trees["controlnet"])
    return jsd, jgp, tsd, tgp


@pytest.mark.parametrize("steps, with_cond", [(10, False), (7, True)])
def test_sample_images_matches_jax(guidance, steps, with_cond):
    jsd, jgp, tsd, tgp = guidance
    rng = np.random.default_rng(steps)
    txt = rng.normal(size=(1, 4, 32)).astype(np.float32)
    unc = np.zeros((1, 4, 32), np.float32)
    cond = rng.uniform(size=(1, 2 * LATENT, 2 * LATENT, 3)).astype(
        np.float32) if with_cond else None
    key = jax.random.PRNGKey(steps)
    want = np.asarray(jsd.sample_images(
        jgp, jnp.asarray(txt), jnp.asarray(unc), key,
        num_inference_steps=steps, guidance_scale=6.0,
        cond_image=None if cond is None else jnp.asarray(cond)))
    # the JAX sampler's draw, handed to the port
    noise = jax.random.normal(key, (1, LATENT, LATENT, 4), jnp.float32)
    got = tsd.sample_images(
        tgp, torch.as_tensor(txt), torch.as_tensor(unc),
        num_inference_steps=steps, guidance_scale=6.0,
        noise=torch.as_tensor(np.array(noise)),
        cond_image=None if cond is None else torch.as_tensor(cond)).numpy()
    assert got.shape == want.shape == (1, 2 * LATENT, 2 * LATENT, 3)
    assert 0.05 < float(want.std())                      # not flat
    assert 0.0 < float((want > 0.0).mean()) and (want < 1.0).mean() > 0.5
    err = np.abs(got - want).max()
    assert err <= IMAGE_TOL_OF_MAX * np.abs(want).max(), err


def test_sample_images_draws_from_the_generator(guidance):
    """Without ``noise=`` the start is a standard normal draw from the
    generator (the same draw twice gives the same image), and the
    ControlNet's condition changes the image."""
    _, _, tsd, tgp = guidance
    txt, unc = torch.randn((1, 4, 32)), torch.zeros((1, 4, 32))
    a, b = (tsd.sample_images(tgp, txt, unc, torch.Generator().manual_seed(1),
                              num_inference_steps=3) for _ in range(2))
    assert torch.equal(a, b)
    c = tsd.sample_images(
        tgp, txt, unc, torch.Generator().manual_seed(1),
        num_inference_steps=3,
        cond_image=torch.rand((1, 2 * LATENT, 2 * LATENT, 3)))
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise= or generator="):
        tsd.sample_images(tgp, txt, unc, num_inference_steps=3)


# -- the trainer's modes ------------------------------------------------------

def _argv(tmp_path, name, *extra, stage="gs"):
    return ["--stage", stage, "--log.debug", "true",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--optim.seed", "3", "--guide.text", "a dancer",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--render.n_gaussians", "64",
            "--data.train_w", "24", "--data.train_h", "24",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0",
            "--render.tile_size", "8", "--render.tile_capacity", "64",
            "--render.chunk", "16", *extra]


def _jax_providers(jcfg, exp_dir):
    """The JAX trainer's prompt, training camera and timestep scheduler,
    built as its Trainer builds them (the debug body)."""
    from dreamwaltz_g_tpu.data.sampler import RandomCamera4Avatar
    from dreamwaltz_g_tpu.guidance.time_prior import TimePrioritizedScheduler
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model

    smpl = make_synthetic_model()
    prompt = SMPLPrompt(jcfg.prompt, smpl,
                        cond_type=list(jcfg.guide.controlnet_condition),
                        height=512, width=512, seed=jcfg.optim.seed)
    res = int(jcfg.data.train_w)
    cam = RandomCamera4Avatar(jcfg.data, res, res, seed=jcfg.optim.seed)
    kp = np.asarray(openpose_keypoints(smpl, prompt.canonical_outputs,
                                       prompt.condition.landmarks))
    if np.isfinite(kp[:, :18]).all():
        cam.setup_camera_offset(kp)
    return types.SimpleNamespace(
        cfg=jcfg, smpl=smpl, prompt=prompt, train_camera=cam, train_res=res,
        exp_dir=Path(exp_dir), max_iteration=jcfg.optim.iters, train_step=0,
        t_scheduler=TimePrioritizedScheduler(jcfg.guide,
                                             seed=jcfg.optim.seed))


@pytest.mark.parametrize("conditions", ["pose", "pose,depth_raw,depth"])
def test_check_matches_jax(tmp_path, conditions):
    argv = _argv(tmp_path, "port", "--optim.iters", "20",
                 "--guide.controlnet_condition", conditions,
                 "--log.check", "true", "--log.check_sd", "true",
                 "--log.check_sd_steps", "2")
    tr = Trainer(parse_args(argv + ["--log.platform", "cpu"]))
    jcfg = jparse(argv)
    jcfg.log.check_sd = False
    ns = _jax_providers(jcfg, tmp_path / "jax")
    ns.cond_size = tr.cond_size
    JTrainer.check(ns)
    tdir, jdir = tr.exp_dir / "check", ns.exp_dir / "check"
    jfiles = sorted(p.name for p in jdir.glob("*.png"))
    conds = [c for c in conditions.split(",") if c != "depth_raw"]
    assert jfiles == sorted(["timestep_curve.png"] + [
        f"cond_{c}_az{a}.png" for c in conds for a in (0, 90, 180, 270)])
    tfiles = sorted(p.name for p in tdir.glob("*.png"))
    samples = [f"control_az{a}.png" for a in (0, 90, 180, 270)] \
        + ["sd_50.png", "sd_7.5.png"]
    assert tfiles == sorted(jfiles + samples)
    for name in jfiles:
        if name.startswith("cond_"):
            np.testing.assert_array_equal(load_image(str(tdir / name)),
                                          load_image(str(jdir / name)))
            assert load_image(str(tdir / name)).std() > 0
    for name in samples:
        img = load_image(str(tdir / name))
        assert img.shape == (2 * tr.guidance.latent_size,) * 2 + (3,)
    assert tr.t_scheduler.rng.bit_generator.state \
        == ns.t_scheduler.rng.bit_generator.state


def test_check_of_a_zero_step_run(tmp_path):
    """``--optim.iters 0`` (construction only): no curve, the exports
    written; then ``run`` trains nothing."""
    tr = main(_argv(tmp_path, "zero", "--optim.iters", "0",
                    "--log.check", "true", "--log.platform", "cpu"))
    names = sorted(p.name for p in (tr.exp_dir / "check").glob("*.png"))
    assert names == [f"cond_pose_az{a}.png" for a in (0, 180, 270, 90)]
    assert tr.train_step == 0


def test_pretrain_matches_jax(tmp_path, monkeypatch):
    argv = _argv(tmp_path, "pre", "--log.pretrain_only", "true",
                 "--optim.iters", "3", "--prompt.scene", "canonical",
                 stage="nerf")
    # JAX: its own method on its providers, the step a recorder
    jcfg = jparse(argv)
    ns = _jax_providers(jcfg, tmp_path / "jax")
    jseen = []

    def jstep(state, grid, c2w, intr, depth, mask, key):
        jseen.append([np.asarray(a) for a in (c2w, intr, depth, mask)])
        return state, {"loss": jnp.float32(0.0)}

    def no_checkpoint():
        raise FileNotFoundError

    monkeypatch.setattr(JNT, "maybe_update_occupancy",
                        lambda state, grid, *a, **kw: grid)
    ns.__dict__.update(
        pretrain_step_fn=jstep, state=None, grid=None, nerf=None,
        load_checkpoint=no_checkpoint, save_checkpoint=lambda: None,
        _next_key=lambda: jax.random.PRNGKey(0))
    JTrainer.pretrain(ns)

    # the port: the real step, its inputs recorded
    tseen = []
    build = Trainer._build_pretrain_step

    def recorded(self, H):
        build(self, H)
        step = self.pretrain_step_fn

        def fn(tstate, grid, c2w, intr, depth, mask, **kw):
            tseen.append([t.detach().numpy().copy()
                          for t in (c2w, intr, depth, mask)])
            return step(tstate, grid, c2w, intr, depth, mask, **kw)
        self.pretrain_step_fn = fn

    monkeypatch.setattr(Trainer, "_build_pretrain_step", recorded)
    tr = main(argv + ["--log.platform", "cpu"])
    assert len(tseen) == len(jseen) == 3 and tr.train_step == 3
    assert tr.cfg.guide.controlnet_condition == ["depth_raw"]
    for t, j in zip(tseen, jseen):
        np.testing.assert_allclose(t[0], j[0], atol=1e-5)
        np.testing.assert_allclose(t[1], j[1], atol=1e-5)
        np.testing.assert_allclose(t[2], j[2], atol=1e-4)
        np.testing.assert_array_equal(t[3], j[3])
        assert t[3].mean() > 0.02                  # the body covers pixels
    assert np.isfinite(tr.losses).all() and len(tr.losses) == 3
    assert (tr.exp_dir / "checkpoints" / "step_00000003").is_dir()
    # resume_pretrain (the default): the checkpoint is reused, no step runs
    tseen.clear()
    again = main(argv + ["--log.platform", "cpu"])
    assert again.train_step == 3 and not tseen
    for k, v in again.nerf.state_dict().items():
        assert torch.equal(v, tr.nerf.state_dict()[k]), k

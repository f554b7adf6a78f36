"""The trainer at ``--optim.batch_size 2`` (multi-view SDS through
``parallel/dp.py``), on the CPU.

* ``Trainer._train_batch`` against the JAX trainer's B-view batch
  assembly, composed from the JAX package's providers as its
  ``_train_batch`` composes them (``test_torch_trainer.py``'s approach):
  the B cameras within 1e-5, the view indices, parts, timesteps and
  guidance scale equal, each view's text the prompt's embedding at its
  view index, the condition canvases equal on at least 99.9% of their
  pixels, and with ``--data.per_view_poses`` in stage gs each view's pose
  the prompt's draw at ``batch_idx = step * B + i``, its canvas from its
  own pose. The body's shape follows ``--prompt.observed_betas`` from the
  canonical to the observed betas over the first 20 draws, so each
  draw's betas (within 1e-6) show its ``batch_idx``; the random pose
  samplers' normals come from the port's own generator, not from JAX's
  keys, so a random scene would not compare draw by draw.
* Stage 1, the hybrid avatar (one pose a view), the vanilla avatar (one
  pose a view) and the hybrid avatar with the MLP background through
  ``main`` for 2 steps: the B-view step was built, the loss is finite,
  and a run resumed after step 1 from its checkpoint equals an
  uninterrupted one to the bit (the model, the optimizers' states, the
  background's, every generator; one CPU thread).
"""
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu_torch.configs import parse_args
from tests.test_torch_trainer import _flat, _tiny_common
import tests.torch_threads  # noqa: F401  (per-worker threads)

B = 2


def _jax_batches(argv, steps):
    """The JAX trainer's B-view ``_train_batch`` for ``steps``, from the
    JAX package's providers (debug body, the tiny guidance's 16^2
    condition size)."""
    from dreamwaltz_g_tpu.configs import parse_args as jparse
    from dreamwaltz_g_tpu.data.sampler import RandomCamera4Avatar
    from dreamwaltz_g_tpu.guidance.text_aug import TextAugmentation
    from dreamwaltz_g_tpu.guidance.time_prior import TimePrioritizedScheduler
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model

    cfg = jparse(argv)
    smpl = make_synthetic_model()
    prompt = SMPLPrompt(cfg.prompt, smpl,
                        cond_type=list(cfg.guide.controlnet_condition),
                        height=512, width=512, seed=cfg.optim.seed)
    view = TextAugmentation(cfg.guide.text or "a person",
                            mode=cfg.prompt.text_augmentation_mode,
                            angle_front=cfg.prompt.angle_front,
                            angle_overhead=cfg.prompt.angle_overhead)
    sched = TimePrioritizedScheduler(cfg.guide, seed=cfg.optim.seed)
    res = int(str(cfg.data.train_w).split(",")[0])
    camera = RandomCamera4Avatar(cfg.data, res, res, seed=cfg.optim.seed)
    kp = np.asarray(openpose_keypoints(smpl, prompt.canonical_outputs, None))
    if np.isfinite(kp[:, :18]).all():
        camera.setup_camera_offset(kp)
    per_view = cfg.data.per_view_poses and cfg.stage == "gs"
    out = []
    for step in steps:
        prompt.training_ratio = camera.training_ratio = step / cfg.optim.iters
        if per_view:
            draws = [prompt(batch_idx=step * B + i) for i in range(B)]
            poses = np.concatenate([np.asarray(d[0].betas) for d in draws])
            outs = [d[1] for d in draws]
        else:
            inputs, outputs = prompt(batch_idx=step)
            poses, outs = np.asarray(inputs.betas), [outputs] * B
        cams, parts, idx = [], [], []
        for _ in range(B):
            cam, part = camera(1)
            cams.append(cam)
            parts.append(part)
            idx.append(int(view(np.asarray(cam.azimuth),
                                np.asarray(cam.elevation), part)[0]))
        extr = np.concatenate([np.asarray(c.extrinsic) for c in cams])
        intr = np.concatenate([np.asarray(c.intrinsics) for c in cams])
        conds = prompt.get_cond_images_batch(
            outs, extr, intr, cond_type=cfg.guide.controlnet_condition[0],
            height=16, width=16)
        out.append(dict(cams=cams, parts=parts, idx=idx, conds=conds,
                        poses=poses,
                        t=sched.get_timestep(B, step, cfg.optim.iters),
                        gs=sched.get_guidance_scale(step, cfg.optim.iters)))
    return out


@pytest.mark.parametrize("stage,per_view", [("nerf", False), ("gs", False),
                                            ("gs", True)])
def test_multiview_train_batch_matches_jax(tmp_path, stage, per_view):
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    argv = ["--stage", stage, "--log.debug", "true",
            "--log.exp_root", str(tmp_path), "--log.exp_name", "b",
            "--optim.seed", "3", "--optim.iters", "40",
            "--optim.batch_size", str(B),
            "--data.per_view_poses", str(per_view).lower(),
            "--prompt.observed_betas", "((0, 0, 0, 0), (1.0, -1.0, 0.5, 0.5))",
            "--prompt.max_beta_iteration", "20",
            "--guide.text", "a dancer",
            "--data.train_w", "16", "--data.train_h", "16",
            "--data.face_prob", "0.3", "--data.hand_prob", "0.3",
            "--render.n_gaussians", "64",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0"]
    tr = Trainer(parse_args(argv + ["--log.platform", "cpu"]))
    steps = range(1, 6)
    for step, w in zip(steps, _jax_batches(argv, steps)):
        tr.prompt.training_ratio = tr.train_camera.training_ratio = \
            step / tr.max_iteration
        b = tr._train_batch(step)
        assert b["view_indices"] == w["idx"] and b["part"] == w["parts"][0]
        assert b["cam"].extrinsic.shape[0] == B
        for i, cam in enumerate(w["cams"]):
            for name in ("extrinsic", "intrinsics", "tanfov", "azimuth"):
                np.testing.assert_allclose(
                    getattr(b["cam"], name)[i: i + 1].numpy(),
                    np.asarray(getattr(cam, name)), atol=1e-5)
        np.testing.assert_array_equal(b["t"].numpy(), np.asarray(w["t"]))
        assert b["t"].shape == (B,)
        assert b["guidance_scale"] == w["gs"]
        assert b["text"].shape[0] == b["uncond"].shape[0] == B
        for i, idx in enumerate(w["idx"]):
            assert torch.equal(b["text"][i], tr.text_embeds[idx])
            got = (b["cond_image"][i].numpy() * 255.0).round().astype(
                np.uint8)
            assert np.any(got != w["conds"][i], axis=-1).mean() <= 1e-3
        if stage == "gs":
            np.testing.assert_allclose(b["smpl_inputs"].betas.numpy(),
                                       w["poses"], atol=1e-6)
            assert b["smpl_inputs"].betas.shape[0] == (B if per_view else 1)
    if per_view:   # the views' shapes differ, and so do their canvases
        assert not np.array_equal(w["poses"][0], w["poses"][1])
        assert not np.array_equal(w["conds"][0], w["conds"][1])


RUNS = {
    "nerf": ["--stage", "nerf"],
    "hybrid": ["--stage", "gs", "--data.per_view_poses", "true"],
    "vanilla": ["--stage", "gs", "--render.gs_type", "vanilla",
                "--data.per_view_poses", "true"],
    "hybrid_mlp_background": ["--stage", "gs",
                              "--render.use_mlp_background", "true"],
}


def _args(tmp_path, run, name, save_interval):
    extra = [] if run == "nerf" else [
        "--render.n_gaussians", "96", "--prompt.scene", "canonical-R",
        "--render.use_densifier", "true", "--render.densify_from_iter", "1",
        "--render.densification_interval", "1",
        "--render.densify_grad_threshold", "0"]
    return ["--optim.iters", "2", "--optim.batch_size", str(B),
            "--log.save_interval", str(save_interval),
            "--log.max_keep_ckpts", "0",
            "--data.train_w", "16", "--data.train_h", "16"] \
        + RUNS[run] + extra + _tiny_common(tmp_path, name)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_multiview_cli_trains_and_resumes(tmp_path, run):
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import _opt_tree

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = main(_args(tmp_path, run, "whole", 0))
        first = main(_args(tmp_path, run, "split", 1))
        assert first.checkpointer.all_steps() == [1, 2]
        (tmp_path / "split" / "checkpoints" / "step_00000002").rename(
            tmp_path / "step_2_aside")
        resumed = main(_args(tmp_path, run, "split", 0)
                       + ["--optim.resume", "true"])
    finally:
        torch.set_num_threads(threads)
    step_fn = whole.sds_step_fn
    assert step_fn.__qualname__.startswith(
        "make_nerf_sds_step_dp" if run == "nerf" else
        "make_vanilla_sds_step_dp" if run == "vanilla" else
        "make_avatar_sds_step_dp"), step_fn.__qualname__
    assert resumed.train_step == whole.train_step == 2
    assert len(whole.losses) == 2 and np.isfinite(whole.losses).all()
    assert resumed.losses == whole.losses[1:]
    for tr in (whole, resumed):
        model = tr.nerf.state_dict() if run == "nerf" \
            else tr._avatar_params_tree()
        tr.tree = {"model": model, "opt": _opt_tree(tr.state.opt_state),
                   "rng": tr._rng_tree()}
        if tr.bg_state is not None:
            tr.tree["bg"] = {"net": tr.bg_net.state_dict(),
                             "opt": tr.bg_state.opt_state}
    assert ("bg" in whole.tree) == (run == "hybrid_mlp_background")
    got, want = dict(_flat(resumed.tree)), dict(_flat(whole.tree))
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    whole._snapshot(whole._train_batch(3))

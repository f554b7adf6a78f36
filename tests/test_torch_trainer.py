"""The port's orchestrator and CLI (``training/trainer.py``,
``dreamwaltz_g_tpu_torch.main``) against the JAX package, on the CPU.

* ``parse_args`` on every command line of ``scripts/train_w_expr.sh``
  steps 1.1-2.3 gives the JAX package's config, field by field
  (``to_dict`` equal).
* The two-stage chain of ``tests/test_two_stage_handoff.py`` at its tiny
  sizes, through ``python -m dreamwaltz_g_tpu_torch.main``'s ``main``:
  stage nerf (step 1.1's progressive resolutions) then stage gs seeded
  from its checkpoint: the exported cloud (not the mesh) seeds the avatar,
  the stage-1 planes arrive verbatim and then move.
* ``Trainer._train_batch`` against the JAX trainer's batch assembly,
  composed from the JAX package's own providers (camera sampler, view
  prompt, pose prompt with its condition renderer, timestep scheduler) as
  its ``Trainer._train_batch`` composes them. The JAX ``Trainer`` itself
  is not built: its construction alone takes ~50 s here (the tiny
  guidance's Flax init). Cameras within 1e-5, timesteps, guidance scales,
  view indices and parts equal, the 16^2 pose canvases equal on at least
  99.9% of their pixels (none differs on these inputs).
* Unported paths refuse at construction, and the DMTet finetune with
  ``--optim.batch_size > 1``.
* The other geometries through ``main``: the DMTet finetune (the twin of
  ``tests/test_dmtet_train.py``'s CLI test), the vanilla avatar with
  densification and the opacity reset, and the hash avatar, each for 2
  steps: a resumed run equals an uninterrupted one to the bit (one CPU
  thread), and ``evaluate`` renders finite frames.
"""
import shlex

import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.configs import to_dict as jto_dict
from dreamwaltz_g_tpu_torch.configs import parse_args, to_dict
import tests.torch_threads  # noqa: F401  (per-worker threads)

SCRIPT = "scripts/train_w_expr.sh"


def _script_argvs():
    """The ``python main.py`` command lines of steps 1.1-2.3, with the
    script's variables filled in."""
    text = "a wizard in a blue robe"
    subs = {"${text}": text, "${predefined_body_parts}": "hands,face",
            "${random_pose_sampler}": "random-body,hand,expr",
            "${exp_name}": "a_wizard/nerf,64-256,10k",
            "${last_ckpt}": "outputs/a_wizard/last",
            "${from_nerf_ckpt}": "outputs/a_wizard/nerf"}
    lines = open(SCRIPT).read().split("python main.py")[1:]
    argvs = []
    for block in lines:
        cmd = []
        for ln in block.splitlines():
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                if cmd:
                    break
                continue
            cmd.append(ln.rstrip("\\").strip())
            if not ln.endswith("\\"):
                break
        s = " ".join(cmd)
        for k, v in subs.items():
            s = s.replace(k, v)
        argvs.append(shlex.split(s))
    return argvs[:5]      # 1.1, 1.2, 2.1, 2.2, 2.3


@pytest.mark.parametrize("step", range(5))
def test_parse_args_matches_jax_on_the_script(step):
    argv = _script_argvs()[step]
    assert "--stage" in argv
    assert to_dict(parse_args(argv)) == to_dict(jparse(argv)) \
        == jto_dict(jparse(argv))


def test_parse_args_matches_jax_on_defaults_and_coercions():
    for argv in ([], ["--guide.min_timestep", "(0, 0.5, 0.02, 1000)",
                      "--data.grid_milestone", "[0.3, 0.6]",
                      "--render.use_constant_colors", "(0.5,0.5,0.5)",
                      "--log.eval_only", "true", "--stage", "nerf",
                      "--data.azimuth_range", "(0, 90),(270,360)"]):
        assert to_dict(parse_args(argv)) == jto_dict(jparse(argv))
    for bad in (["--nope.x", "1"], ["--render.nope", "1"], ["--stage"]):
        with pytest.raises(ValueError):
            parse_args(bad)


def _tiny_common(tmp_path, name):
    return [
        "--log.debug", "true", "--log.exp_root", str(tmp_path),
        "--log.exp_name", name, "--log.platform", "cpu",
        "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
        "--data.eval_h", "16", "--data.eval_w", "16",
        "--data.test_h", "16", "--data.test_w", "16",
        "--log.snapshot_interval", "0", "--log.evaluate_interval", "0",
    ]


def test_two_stage_handoff_cli(tmp_path):
    from dreamwaltz_g_tpu_torch.main import main

    # ---- stage 1: step 1.1's progressive resolutions, checkpointed ----
    tr1 = main(["--stage", "nerf", "--optim.iters", "3",
                "--log.save_interval", "3",
                "--data.train_w", "8,16", "--data.train_h", "8,16",
                "--data.progressive_grid", "true"]
               + _tiny_common(tmp_path, "s1"))
    assert tr1.train_step == 3
    assert tr1.train_resolutions == [8, 16] and tr1._res_index == 1
    assert tr1.train_res == tr1.train_camera.image_height == 16
    assert len(tr1.losses) == 3 and np.isfinite(tr1.losses).all()
    assert list((tr1.exp_dir / "checkpoints").glob("step_*"))
    planes1 = tr1.nerf.planes.detach().clone()

    # ---- stage 2: the avatar seeded from the stage-1 field ----
    seen = {}
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    train = Trainer.train

    def before(self):
        seen["planes"] = self.state.avatar.params.encoder.planes.detach() \
            .clone()
        seen["nerf"] = self._nerf_guidance is not None
        seen["alive"] = int(self.state.avatar.alive.sum())
        seen["stats"] = dict(self.export_stats)
        return train(self)

    Trainer.train = before
    try:
        tr2 = main(["--stage", "gs", "--optim.iters", "1",
                    "--render.from_nerf", str(tr1.exp_dir),
                    "--render.n_gaussians", "128",
                    "--render.nerf_resolution", "24",
                    "--nerf.density_thresh", "1e-4",
                    "--data.train_w", "16", "--data.train_h", "16",
                    "--log.save_interval", "0"]
                   + _tiny_common(tmp_path, "s2"))
    finally:
        Trainer.train = train
    # the exported cloud seeded the avatar, not the SMPL-X mesh fallback
    assert seen["nerf"] and seen["alive"] > 0
    assert seen["stats"]["points"] == 128 and seen["stats"]["capacity"] \
        == 128
    assert seen["stats"]["dense_cells"] >= seen["stats"]["kept_cells"] > 0
    # the stage-1 tables carried over verbatim, then trained on
    assert torch.equal(seen["planes"], planes1)
    assert tr2.train_step == 1
    after = tr2.state.avatar.params.encoder.planes.detach()
    assert float((after - planes1).abs().max()) > 0.0
    # the head carried over too: the avatar's color MLP is the field's
    stage1 = tr1.nerf.sigma_mlp.state_dict()
    assert set(tr2.avatar_model.color_mlp.state_dict()) == set(stage1)


def _jax_batches(cfg_argv, steps):
    """The JAX trainer's ``_train_batch`` for ``steps``, composed from the
    JAX package's providers as its Trainer builds and calls them (debug
    body, tiny guidance's 16^2 condition size)."""
    from dreamwaltz_g_tpu.data.sampler import RandomCamera4Avatar
    from dreamwaltz_g_tpu.guidance.text_aug import TextAugmentation
    from dreamwaltz_g_tpu.guidance.time_prior import TimePrioritizedScheduler
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model

    cfg = jparse(cfg_argv)
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
    out = []
    for step in steps:
        prompt.training_ratio = camera.training_ratio = step / cfg.optim.iters
        _, outputs = prompt(batch_idx=step)
        cam, part = camera(1)
        idx = int(view(np.asarray(cam.azimuth), np.asarray(cam.elevation),
                       part)[0])
        img = prompt.get_cond_images_batch(
            [outputs], cam.extrinsic, cam.intrinsics,
            cond_type=cfg.guide.controlnet_condition[0], height=16,
            width=16)[0]
        out.append(dict(cam=cam, part=part, view_idx=idx, cond=img,
                        t=sched.get_timestep(1, step, cfg.optim.iters),
                        gs=sched.get_guidance_scale(step, cfg.optim.iters)))
    return out


@pytest.mark.parametrize("stage", ["nerf", "gs"])
def test_train_batch_matches_jax(tmp_path, stage):
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    argv = ["--stage", stage, "--log.debug", "true",
            "--log.exp_root", str(tmp_path), "--log.exp_name", "b",
            "--optim.seed", "3", "--optim.iters", "40",
            "--guide.text", "a dancer",
            "--data.train_w", "16", "--data.train_h", "16",
            "--data.face_prob", "0.3", "--data.hand_prob", "0.3",
            "--render.n_gaussians", "64",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0"]
    tr = Trainer(parse_args(argv + ["--log.platform", "cpu"]))
    assert tr.cond_size == 16
    steps = range(1, 9)
    want = _jax_batches(argv, steps)
    for step, w in zip(steps, want):
        tr.prompt.training_ratio = tr.train_camera.training_ratio = \
            step / tr.max_iteration
        b = tr._train_batch(step)
        assert b["part"] == w["part"] and b["view_idx"] == w["view_idx"]
        for name in ("extrinsic", "intrinsics", "tanfov", "azimuth"):
            np.testing.assert_allclose(getattr(b["cam"], name).numpy(),
                                       np.asarray(getattr(w["cam"], name)),
                                       atol=1e-5)
        np.testing.assert_array_equal(b["t"].numpy(), np.asarray(w["t"]))
        assert b["guidance_scale"] == w["gs"]
        got = (b["cond_image"][0].numpy() * 255.0).round().astype(np.uint8)
        assert np.any(got != w["cond"], axis=-1).mean() <= 1e-3
        assert torch.equal(b["text"][0], tr.text_embeds[w["view_idx"]])


@pytest.mark.parametrize("flags", [
    ["--nerf.backbone", "hashgrid"],
    ["--render.use_gs_background", "bg.ply"],
    ["--render.avatar_scale", "1.0"],
    ["--render.use_mlp_background", "true"], ["--optim.batch_size", "2"],
    ["--guide.diffusion", "sdxl10"], ["--optim.ckpt_extra", "other"],
    ["--parallel.tp", "2"],
    ["--stage", "nerf", "--nerf.dmtet", "true", "--optim.batch_size", "2"]])
def test_unported_paths_refuse(tmp_path, flags):
    """Each flag combination the JAX trainer asserts against raises at
    construction, also in the multi-prompt batch, which names the prompts
    that failed: tensor parallelism over more ranks than the process group
    holds (tp must divide the ranks), and the DMTet finetune with several
    views (it runs single-view). The scene options, the grid backbones,
    the SDXL card and multi-view SDS (``--optim.batch_size 2``) are
    ported: their flags pass the check (the CLI tests of
    ``test_torch_scene.py``, ``test_torch_grid.py``,
    ``test_torch_guidance_cli.py`` and ``test_torch_trainer_multiview.py``
    run them)."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    base = ["--stage", "gs", "--log.debug", "true", "--log.platform", "cpu",
            "--log.exp_root", str(tmp_path), "--log.exp_name", "x",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0"]
    if flags[0] in ("--nerf.backbone", "--render.use_gs_background",
                    "--render.avatar_scale", "--render.use_mlp_background",
                    "--optim.ckpt_extra", "--guide.diffusion",
                    "--optim.batch_size"):
        tr = Trainer.__new__(Trainer)
        tr.cfg = parse_args(base + flags)
        tr._refuse_unported()
        return
    exc, match = (ValueError, "single-view") if "--nerf.dmtet" in flags \
        else (ValueError, "must divide the 1 ranks")
    with pytest.raises(exc, match=match):
        main(base + flags)
    with pytest.raises(RuntimeError, match="1 prompt") as e:
        main(base + flags + ["--guide.text_set", "demo,1-1"])
    assert isinstance(e.value.__cause__, exc)


def _card_defaults():
    """The constructors the trainer calls, each without ``device=``."""
    from dreamwaltz_g_tpu_torch.configs import DataConfig, GuideConfig
    from dreamwaltz_g_tpu_torch.data.camera import to_screen
    from dreamwaltz_g_tpu_torch.data.sampler import (
        CyclicalCamera4Avatar,
        RandomCamera4Avatar,
    )
    from dreamwaltz_g_tpu_torch.guidance.sds import ScoreDistillation
    from dreamwaltz_g_tpu_torch.guidance.time_prior import (
        TimePrioritizedScheduler,
        make_schedule,
    )
    from dreamwaltz_g_tpu_torch.human.condition import conditions_to_batch
    from dreamwaltz_g_tpu_torch.human.poses import canonical_body_pose
    from dreamwaltz_g_tpu_torch.human.prompt import parse_betas
    from dreamwaltz_g_tpu_torch.nerf.renderer import init_occupancy
    from dreamwaltz_g_tpu_torch.system.background import VideoBackground
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer
    from dreamwaltz_g_tpu_torch.utils import r_precision as RP

    return {
        "VideoBackground": lambda: VideoBackground(
            np.zeros((2, 8, 8, 3), np.float32)),
        "RPrecision": lambda: RP.RPrecision(
            RP.CLIPVisionModel(RP.tiny_vision_config()),
            RP.CLIPTextTower(RP.tiny_text_config(), 16)),
        "make_tiny_r_precision": lambda: RP.make_tiny_r_precision(
            torch.Generator()),
        "preprocess_images": lambda: RP.preprocess_images(
            np.zeros((1, 8, 8, 3), np.float32), 4),
        "CyclicalCamera4Avatar": lambda: CyclicalCamera4Avatar(
            DataConfig(), 8, 8),
        "init_occupancy": lambda: init_occupancy(8),
        "make_schedule": lambda: make_schedule(),
        "to_screen": lambda: to_screen(1, 8, 8),
        "parse_betas": lambda: parse_betas("(0.5, -0.5)", 10),
        "ScoreDistillation": lambda: ScoreDistillation(),
        "TimePrioritizedScheduler": lambda: TimePrioritizedScheduler(
            GuideConfig()),
        "RandomCamera4Avatar": lambda: RandomCamera4Avatar(DataConfig(),
                                                           8, 8),
        "canonical_body_pose": lambda: canonical_body_pose("canonical"),
        "conditions_to_batch": lambda: conditions_to_batch(
            [np.zeros((8, 8, 3), np.uint8)]),
        "Trainer": lambda: Trainer(parse_args(
            ["--stage", "nerf", "--log.snapshot_interval", "0",
             "--log.evaluate_interval", "0"])),
    }


@pytest.mark.parametrize("name", ["init_occupancy", "make_schedule",
                                  "to_screen", "parse_betas",
                                  "ScoreDistillation",
                                  "TimePrioritizedScheduler",
                                  "RandomCamera4Avatar",
                                  "canonical_body_pose",
                                  "conditions_to_batch", "Trainer",
                                  "VideoBackground", "RPrecision",
                                  "make_tiny_r_precision",
                                  "preprocess_images",
                                  "CyclicalCamera4Avatar"])
def test_constructor_defaults_to_cuda(name):
    """Without ``device=`` (the trainer: without ``--log.platform``) each
    asks for CUDA, and on a machine without it raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _card_defaults()[name]()


def test_train_without_prefetch_gives_the_same_run(tmp_path):
    """``train(prefetch=False)`` builds each batch on the main thread just
    before its step, and the run equals the prefetch worker's to the bit
    (the worker draws only from generators of its own); ``on_step`` sees
    every step, in order. One CPU thread, so both runs add alike."""
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for prefetch in (True, False):
            tr = Trainer(parse_args(
                ["--stage", "nerf", "--optim.iters", "3",
                 "--log.save_interval", "0",
                 "--data.train_w", "16", "--data.train_h", "16"]
                + _tiny_common(tmp_path, f"p{int(prefetch)}")))
            seen = []
            tr.train(on_step=seen.append, prefetch=prefetch)
            assert seen == [1, 2, 3]
            runs[prefetch] = (tr.losses, tr.nerf.planes.detach().clone())
    finally:
        torch.set_num_threads(threads)
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])


def test_timing_spans_time_the_handoff(tmp_path):
    """With ``utils.timing.enabled`` the stage-2 trainer's construction
    records one span each of the export, the avatar's initialisation and
    the LBS smoothing inside it (host ms only on the CPU); off, a span
    records nothing."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer
    from dreamwaltz_g_tpu_torch.utils import timing

    tr1 = main(["--stage", "nerf", "--optim.iters", "1",
                "--log.save_interval", "1",
                "--data.train_w", "16", "--data.train_h", "16"]
               + _tiny_common(tmp_path, "s1"))
    argv = ["--stage", "gs", "--optim.iters", "1",
            "--render.from_nerf", str(tr1.exp_dir),
            "--render.n_gaussians", "128", "--render.nerf_resolution", "24",
            "--nerf.density_thresh", "1e-4",
            "--render.lbs_weight_smooth", "true",
            "--render.lbs_weight_smooth_N", "3",
            "--data.train_w", "16", "--data.train_h", "16"] \
        + _tiny_common(tmp_path, "s2")
    timing.records.clear()
    timing.enabled = True
    try:
        Trainer(parse_args(argv))
    finally:
        timing.enabled = False
    spans = {name: timing.times(name) for name in timing.records}
    assert set(spans) == {"trainer.export", "trainer.init_avatar_state",
                          "avatar.lbs_smooth"}
    for name, recs in spans.items():
        assert len(recs) == 1 and recs[0][0] is None and recs[0][1] > 0
    assert spans["trainer.init_avatar_state"][0][1] \
        >= spans["avatar.lbs_smooth"][0][1]
    timing.records.clear()
    with timing.span("off"):
        pass
    assert timing.records == {}


def _geometry_args(tmp_path, geometry, name, save_interval):
    common = ["--optim.iters", "2", "--log.save_interval", str(save_interval),
              "--log.max_keep_ckpts", "0", "--data.eval_size", "2",
              "--data.train_w", "16", "--data.train_h", "16"]
    if geometry == "dmtet":
        extra = ["--stage", "nerf", "--nerf.dmtet", "true",
                 "--nerf.tet_grid_size", "12",
                 "--nerf.density_prior", "gaussian",
                 "--nerf.density_thresh", "2.0", "--nerf.bound", "1.0",
                 "--render.tile_size", "8", "--render.tile_capacity", "256",
                 "--render.chunk", "64", "--nerf.lr_policy", "cosine"]
    else:
        extra = ["--stage", "gs", "--render.gs_type", geometry,
                 "--render.n_gaussians", "96", "--prompt.scene",
                 "canonical-R", "--render.use_densifier", "true",
                 "--render.densify_from_iter", "1",
                 "--render.densification_interval", "1",
                 "--render.densify_grad_threshold", "0",
                 "--render.densify_min_opacity", "0.5",
                 "--render.densify_disable_reset", "false",
                 "--render.opacity_reset_interval", "2"]
    return common + extra + _tiny_common(tmp_path, name)


def _flat(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{name}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{name}[{i}]")
    else:
        yield name, tree


@pytest.mark.parametrize("geometry", ["dmtet", "vanilla", "hash"])
def test_geometry_cli_trains_resumes_and_evaluates(tmp_path, geometry):
    """Two steps in one run, against one step, a checkpoint, a fresh
    trainer restoring it (``--optim.resume``) and one more step: the model
    (the field and sdf / deform, or the avatar), the optimizers' states
    and every generator equal to the bit. Then ``evaluate`` writes finite
    frames and ``_snapshot`` its PNG."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import _opt_tree

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = main(_geometry_args(tmp_path, geometry, "whole", 0))
        first = main(_geometry_args(tmp_path, geometry, "split", 1))
        assert first.checkpointer.all_steps() == [1, 2]
        (tmp_path / "split" / "checkpoints" / "step_00000002").rename(
            tmp_path / "step_2_aside")
        resumed = main(_geometry_args(tmp_path, geometry, "split", 0)
                       + ["--optim.resume", "true"])
    finally:
        torch.set_num_threads(threads)
    assert resumed.train_step == whole.train_step == 2
    assert len(whole.losses) == 2 and np.isfinite(whole.losses).all()
    assert resumed.losses == whole.losses[1:]
    if geometry == "dmtet":
        from dreamwaltz_g_tpu_torch.training.trainer import Trainer

        assert 0 < whole.dmtet_model.tets.shape[0] < 6 * 11 ** 3
        seed = Trainer(parse_args(_geometry_args(tmp_path, geometry, "seed",
                                                 0))).state.dmtet
        assert not torch.equal(whole.state.dmtet.sdf, seed.sdf)
        assert whole.state.dmtet.deform.abs().max() > 0 == seed.deform.abs(
        ).max()
    for tr in (whole, resumed):
        if geometry == "dmtet":
            model = {"nerf": tr.nerf.state_dict(),
                     "dmtet": tr.state.dmtet._asdict()}
        else:
            model = tr._avatar_params_tree()
        tr.tree = {"model": model, "opt": _opt_tree(tr.state.opt_state),
                   "rng": tr._rng_tree()}
    got, want = dict(_flat(resumed.tree)), dict(_flat(whole.tree))
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    frames = whole.evaluate(save_dir=tmp_path / "ev")
    assert len(frames) == 2
    for f in frames:
        assert f.shape == (16, 16, 3) and np.isfinite(f).all()
    whole._snapshot(whole._train_batch(3))
    assert (whole.exp_dir / "snapshots" / "train" / "000002_rgb.png") \
        .is_file()

"""The port's inference and evaluation (``Trainer.evaluate``, ``full_eval``,
the snapshots and ``--log.eval_only``) against the JAX package, on the CPU.

The JAX side is the JAX trainer's own ``evaluate`` (and ``_build_avatar_
model``), run on an object that holds what it reads: the JAX package's
providers built as its ``Trainer`` builds them (the debug body, the pose
prompt, the eval and test cameras with their body-part offsets, the
avatar renders). The JAX ``Trainer`` itself is not built: its
construction alone takes ~50 s here (the tiny guidance's Flax init). One
JAX avatar state, made from a seed, is carried into the port's trainer
(``convert.avatar_state_from_numpy``); a JAX field into its stage-1
trainer (``convert.nerf_state_from_numpy``).

Tolerances: frames within 5e-3 (slice 1's render tolerance: float32 chains
through SMPL-X, GLBS, the field, two MLPs and the blend); the file names
written, the frame counts and the numpy generators' states equal; the
batches drawn after an evaluation as in ``tests/test_torch_trainer.py``
(cameras within 1e-5, timesteps, guidance scales and view indices equal).
"""
import json
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.configs import paths as jpaths
from dreamwaltz_g_tpu.training.trainer import Trainer as JTrainer
from dreamwaltz_g_tpu_torch.configs import parse_args
from dreamwaltz_g_tpu_torch.configs import paths as tpaths
from dreamwaltz_g_tpu_torch.convert import (
    avatar_state_from_numpy,
    nerf_state_from_numpy,
)
from dreamwaltz_g_tpu_torch.training.trainer import Trainer
import tests.torch_threads  # noqa: F401  (per-worker threads)

ATOL = 5e-3
RASTER = ["--render.tile_size", "8", "--render.tile_capacity", "64",
          "--render.chunk", "16"]


def _argv(tmp_path, name, *extra, stage="gs"):
    return ["--stage", stage, "--log.debug", "true",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--optim.seed", "3", "--guide.text", "a dancer",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--render.n_gaussians", "64",
            "--data.train_w", "16", "--data.train_h", "16",
            "--data.eval_h", "16", "--data.eval_w", "16",
            "--data.test_h", "20", "--data.test_w", "28",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0",
            *RASTER, *extra]


def _demo(root, F=12):
    """A demo bundle in ``Demo``'s layout: small smooth joint angles."""
    t = np.linspace(0, 2 * np.pi, F, dtype=np.float32)[:, None]
    phase = np.random.default_rng(1).random((1, 265)).astype(np.float32)
    np.save(Path(root) / "talkshow.npy", 0.3 * np.sin(t + 6 * phase))
    return "talkshow"


def reenact_files(root, seq="seq01", F=6, width=36, height=20, video=True):
    """A Motion-X-ReEnact archive (a motion json with a per-frame OpenCV
    camera at the body from +z, a ``width`` x ``height`` frame) and, with
    ``video``, its inpainted background mp4 extracted to
    ``root/bg/<seq>.mp4``. Returns that path."""
    import zipfile

    rng = np.random.default_rng(8)
    ann = [{"smplx_params": {
        "root_orient": (rng.normal(size=3) * 0.1).tolist(),
        "pose_body": (rng.normal(size=63) * 0.2).tolist(),
        "pose_hand": (rng.normal(size=90) * 0.2).tolist(),
        "pose_jaw": (rng.normal(size=3) * 0.1).tolist(),
        "trans": (rng.normal(size=3) * 0.02).tolist(),
        "betas": (rng.normal(size=10) * 0.3).tolist()},
        "cam_params": {
            "cam_R": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
            "cam_T": [0.05 * i, 0.3, 2.5],
            "intrins": [40.0, 40.0, width / 2, height / 2]}}
        for i in range(F)]
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    mp4 = root / "tmp_inpainting.mp4"
    w = cv2.VideoWriter(str(mp4), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        (width, height))
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(F + 2):
        w.write(np.stack([(xx * 7 + i * 9) % 256, (yy * 11) % 256,
                          np.full_like(xx, 128)], -1).astype(np.uint8))
    w.release()
    with zipfile.ZipFile(root / "Motion-X-ReEnact.zip", "w") as z:
        z.writestr(f"motion/{seq}.json", json.dumps({"annotations": ann}))
        z.write(mp4, f"inpainting/{seq}_inpainting.mp4")
    from dreamwaltz_g_tpu_torch.data.motion.loaders import MotionXReEnact

    return MotionXReEnact(str(root)).extract_video(
        seq, str(root / "bg" / f"{seq}.mp4")) if video else None


def _jax_side(jcfg, exp_dir):
    """What the JAX trainer's ``evaluate`` reads, built as its Trainer
    builds it (debug body, no hand components), with a seeded avatar."""
    from dreamwaltz_g_tpu.data.sampler import CyclicalCamera4Avatar
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model
    from dreamwaltz_g_tpu.system import avatar as JA
    from dreamwaltz_g_tpu.training import gs_trainer as JG

    smpl = make_synthetic_model()
    prompt = SMPLPrompt(jcfg.prompt, smpl,
                        cond_type=list(jcfg.guide.controlnet_condition),
                        height=512, width=512, seed=jcfg.optim.seed)
    ns = types.SimpleNamespace(cfg=jcfg, smpl=smpl, prompt=prompt)
    model = JTrainer._build_avatar_model(ns)
    cloud = np.random.default_rng(0).normal(size=(48, 3)) * 0.2
    state = JA.init_avatar_state(model, jnp.asarray(cloud, jnp.float32),
                                 jax.random.PRNGKey(0), capacity=64)
    d, r = jcfg.data, jcfg.render
    rk = dict(tile_size=r.tile_size, capacity=r.tile_capacity, chunk=r.chunk)
    cams = (CyclicalCamera4Avatar(d, d.eval_h, d.eval_w),
            CyclicalCamera4Avatar(d, d.test_h, d.test_w))
    kp = np.asarray(openpose_keypoints(smpl, prompt.canonical_outputs,
                                       prompt.condition.landmarks))
    if np.isfinite(kp[:, :18]).all():
        for c in cams:
            c.setup_camera_offset(kp)
    ns.__dict__.update(
        eval_camera=cams[0], test_camera=cams[1], avatar_model=model,
        eval_render=JG.make_avatar_render(model, d.eval_h, d.eval_w, **rk),
        test_render=JG.make_avatar_render(model, d.test_h, d.test_w, **rk),
        state=types.SimpleNamespace(avatar=state), extra_states=(),
        extra_models=(), bg_state=None, bg_net=None, dmtet_model=None,
        exp_dir=Path(exp_dir), train_step=0)
    return ns


def _pair(tmp_path, *extra):
    """(the port's trainer, the JAX side) on one avatar state."""
    argv = _argv(tmp_path, "port", *extra)
    tr = Trainer(parse_args(argv + ["--log.platform", "cpu"]))
    ns = _jax_side(jparse(argv), tmp_path / "jax")
    tree = jax.tree_util.tree_map(np.asarray, ns.state.avatar)
    tr.state = tr.state._replace(avatar=avatar_state_from_numpy(
        tree, tr.avatar_model, device="cpu"))
    return tr, ns


def _written(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _hold(tframes, jframes, drawn=0.05):
    """Equal counts and shapes, every frame within ATOL, and something
    drawn: a frame spans more than ``drawn`` (the avatar covers 11-20% of
    these frames)."""
    assert len(tframes) == len(jframes)
    assert max(float(np.ptp(t)) for t in tframes) > drawn
    for t, j in zip(tframes, jframes):
        assert t.shape == np.shape(j)
        np.testing.assert_allclose(t, np.asarray(j), atol=ATOL)


@pytest.fixture
def demo_motion(tmp_path, monkeypatch):
    root = tmp_path / "motions"
    root.mkdir()
    name = _demo(root)
    for mod in (jpaths, tpaths):
        monkeypatch.setattr(mod, "DEMO_MOTIONS", str(root))
    return f"demo,{name}"


@pytest.mark.parametrize("size,test_res", [(3, False), (9, True)])
def test_batched_eval_matches_jax(tmp_path, demo_motion, size, test_res):
    """The frame-batched path on a motion scene: 3 frames (one chunk, padded
    to 3 in the JAX package) at the eval size, 9 (a chunk of 8 and one of
    1) at the 20 x 28 test size, whose tiles are partial; the PNGs and the
    mp4 under the same names."""
    tr, ns = _pair(tmp_path, "--prompt.scene", demo_motion)
    tframes = tr.evaluate(size=size, use_test_res=test_res)
    jframes = JTrainer.evaluate(ns, size=size, use_test_res=test_res)
    _hold(tframes, jframes)
    assert _written(tr.exp_dir / "results") \
        == _written(ns.exp_dir / "results")
    assert len(_written(tr.exp_dir / "results")) == size + 1
    assert tr.prompt._rng.bit_generator.state \
        == ns.prompt._rng.bit_generator.state


def test_eval_fix_animation_and_bg_mode_match_jax(tmp_path, demo_motion):
    tr, ns = _pair(tmp_path, "--prompt.scene", demo_motion,
                   "--data.eval_fix_animation", "true",
                   "--data.eval_bg_mode", "white")
    _hold(tr.evaluate(size=2), JTrainer.evaluate(ns, size=2))


@pytest.mark.parametrize("video", [False, True])
def test_reenact_camera_matches_jax(tmp_path, monkeypatch, video):
    """The reenact scene's own camera track: a negative fy, a 36 x 20 frame
    (partial 8-pixel tiles), one render a frame; with the video
    background, the frame composited over it and the RGBA laid over the
    video in ``step_000000_overlay.mp4``."""
    root = tmp_path / "reenact"
    bg = reenact_files(root, video=video)
    for mod in (jpaths, tpaths):
        monkeypatch.setattr(mod, "MOTIONX_REENACT_ROOT", str(root))
    extra = ["--prompt.scene", "motionx_reenact,seq01"]
    if video:
        extra += ["--render.use_video_background", bg]
    tr, ns = _pair(tmp_path, *extra)
    assert float(tr.prompt.get_camera_params_from_sequences(0)[
        "intrinsics"][1, 1]) < 0
    tframes = tr.evaluate(size=4)
    _hold(tframes, JTrainer.evaluate(ns, size=4))
    assert tframes[0].shape == (20, 36, 3)
    names = _written(tr.exp_dir / "results")
    assert names == _written(ns.exp_dir / "results")
    assert ("step_000000_overlay.mp4" in names) == video
    if video:
        from dreamwaltz_g_tpu_torch.utils.media import read_video

        over = read_video(str(tr.exp_dir / "results"
                              / "step_000000_overlay.mp4"))
        assert over.shape == (4, 20, 36, 3)


def test_video_background_on_the_eval_track_matches_jax(tmp_path,
                                                         demo_motion):
    """A 36 x 20 video behind 16^2 eval frames: resized (antialiased, as
    ``jax.image.resize``), through the batched path's overlay branch."""
    bg = reenact_files(tmp_path / "video")
    tr, ns = _pair(tmp_path, "--prompt.scene", demo_motion,
                   "--render.use_video_background", bg)
    _hold(tr.evaluate(size=3), JTrainer.evaluate(ns, size=3))
    assert "step_000000_overlay.mp4" in _written(tr.exp_dir / "results")


def test_video_background_needs_an_mp4_path(tmp_path, demo_motion):
    """As in the JAX package, a value not ending in '.mp4' (the reenact
    script's bare sequence name) reads no video."""
    tr, ns = _pair(tmp_path, "--prompt.scene", demo_motion,
                   "--render.use_video_background", "seq01")
    _hold(tr.evaluate(size=2), JTrainer.evaluate(ns, size=2))
    assert not any("overlay" in n for n in _written(tr.exp_dir))


def test_stage1_eval_matches_jax(tmp_path):
    from dreamwaltz_g_tpu.data.sampler import CyclicalCamera4Avatar
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model
    from dreamwaltz_g_tpu.nerf.network import build_nerf
    from dreamwaltz_g_tpu.nerf.renderer import OccupancyGrid
    from dreamwaltz_g_tpu.training import nerf_trainer as JN

    argv = _argv(tmp_path, "port", "--data.eval_h", "12", "--data.eval_w",
                 "12", stage="nerf")
    tr = Trainer(parse_args(argv + ["--log.platform", "cpu"]))
    jcfg = jparse(argv)
    jnerf = build_nerf(jcfg.nerf, with_background=jcfg.nerf.bg_mode
                       == "nerf" or jcfg.nerf.bg_radius > 0)
    params = jnerf.init(jax.random.PRNGKey(1))
    nerf_state_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                          tr.nerf)
    smpl = make_synthetic_model()
    ns = types.SimpleNamespace(
        cfg=jcfg, prompt=SMPLPrompt(jcfg.prompt, smpl, seed=3),
        eval_camera=CyclicalCamera4Avatar(jcfg.data, 12, 12),
        test_camera=CyclicalCamera4Avatar(jcfg.data, 20, 28),
        eval_render=JN.make_eval_render(jnerf, 12, 12),
        state=types.SimpleNamespace(params=params), dmtet_model=None,
        grid=OccupancyGrid(*[jnp.asarray(x.numpy()) for x in tr.grid]),
        bg_state=None, extra_states=(), exp_dir=tmp_path / "jax",
        train_step=0)
    # a random field renders a near-uniform haze (its frames span ~0.05)
    _hold(tr.evaluate(size=2), JTrainer.evaluate(ns, size=2), drawn=0.01)
    assert _written(tr.exp_dir / "results") \
        == _written(ns.exp_dir / "results")


def test_post_step_snapshots_and_evaluates_at_the_intervals(tmp_path):
    """A 3-step run with a snapshot every step and an evaluation every 2:
    the snapshot PNGs of each step, 8 eval PNGs and the mp4 at step 2;
    the prefetch worker held back before those steps' post-step work."""
    tr = Trainer(parse_args(_argv(
        tmp_path, "run", "--optim.iters", "3", "--log.save_interval", "0",
        "--log.snapshot_interval", "1", "--log.evaluate_interval", "2",
        "--prompt.scene", "random") + ["--log.platform", "cpu"]))
    assert [tr._post_step_mutates(s) for s in (1, 2, 3)] == [True] * 3
    tr.train()
    snaps = _written(tr.exp_dir / "snapshots")
    assert snaps == [f"train/{s:06d}_{k}.png" for s in (1, 2, 3)
                     for k in ("cond", "rgb")]
    assert _written(tr.exp_dir / "results") == sorted([
        f"step_000002/{i:04d}.png" for i in range(8)] + ["step_000002.mp4"])
    tr.cfg.log.snapshot_interval = 0
    assert [tr._post_step_mutates(s) for s in (1, 2, 3, 4)] \
        == [False, True, False, True]


def _jax_batch(step, cfg, prompt, camera, view, sched):
    prompt.training_ratio = camera.training_ratio = step / cfg.optim.iters
    prompt(batch_idx=step)
    cam, part = camera(1)
    idx = int(view(np.asarray(cam.azimuth), np.asarray(cam.elevation),
                   part)[0])
    return dict(cam=cam, part=part, view_idx=idx,
                t=sched.get_timestep(1, step, cfg.optim.iters),
                gs=sched.get_guidance_scale(step, cfg.optim.iters))


def test_batches_after_an_evaluation_match_jax(tmp_path):
    """A run of a random scene with an evaluation at step 2: the batch of
    step 3 is drawn after the evaluation's 8 pose draws, as in the JAX
    trainer (its ``_train_batch`` composed from its providers)."""
    from dreamwaltz_g_tpu.data.sampler import RandomCamera4Avatar
    from dreamwaltz_g_tpu.guidance.text_aug import TextAugmentation
    from dreamwaltz_g_tpu.guidance.time_prior import (
        TimePrioritizedScheduler,
    )
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints

    extra = ["--optim.iters", "3", "--log.save_interval", "0",
             "--log.evaluate_interval", "2", "--prompt.scene", "random",
             "--guide.use_controlnet", "false"]
    tr, ns = _pair(tmp_path, *extra)
    seen = []
    batch = tr._train_batch

    def record(step=None):
        b = batch(step)
        seen.append(b)
        return b

    tr._train_batch = record
    tr.train()
    cfg = ns.cfg
    camera = RandomCamera4Avatar(cfg.data, 16, 16, seed=cfg.optim.seed)
    kp = np.asarray(openpose_keypoints(ns.smpl, ns.prompt.canonical_outputs,
                                       None))
    if np.isfinite(kp[:, :18]).all():
        camera.setup_camera_offset(kp)
    view = TextAugmentation(cfg.guide.text,
                            mode=cfg.prompt.text_augmentation_mode,
                            angle_front=cfg.prompt.angle_front,
                            angle_overhead=cfg.prompt.angle_overhead)
    sched = TimePrioritizedScheduler(cfg.guide, seed=cfg.optim.seed)
    want = [_jax_batch(s, cfg, ns.prompt, camera, view, sched)
            for s in (1, 2)]
    ns.train_step = 2
    JTrainer.evaluate(ns)
    want.append(_jax_batch(3, cfg, ns.prompt, camera, view, sched))
    assert len(seen) == 3
    for b, w in zip(seen, want):
        assert b["part"] == w["part"] and b["view_idx"] == w["view_idx"]
        np.testing.assert_allclose(b["cam"].extrinsic.numpy(),
                                   np.asarray(w["cam"].extrinsic), atol=1e-5)
        np.testing.assert_array_equal(b["t"].numpy(), np.asarray(w["t"]))
        assert b["guidance_scale"] == w["gs"]
    assert tr.prompt._rng.bit_generator.state \
        == ns.prompt._rng.bit_generator.state


def test_cli_eval_only_writes_the_frames(tmp_path, demo_motion):
    """``main`` with ``--log.eval_only true --optim.resume true`` on a tiny
    checkpoint (step 3 of ``scripts/train_w_expr.sh``): the buffers sized
    like the checkpoint, which arrives to the bit; ``full_eval_size``
    frames at the test size, their PNGs and mp4, and an R-Precision score
    (the tiny random towers under ``--log.debug``)."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree

    trained = main(_argv(tmp_path, "avatar", "--optim.iters", "1",
                         "--log.save_interval", "1",
                         "--render.n_gaussians", "96")
                   + ["--log.platform", "cpu"])
    scores = []
    full_eval = Trainer.full_eval

    def wrapped(self):
        frames = full_eval(self)
        scores.append(self.compute_r_precision(frames))
        return frames

    Trainer.full_eval = wrapped
    try:
        tr = main(_argv(tmp_path, "avatar", "--log.eval_only", "true",
                        "--optim.resume", "true", "--prompt.scene",
                        demo_motion, "--data.eval_camera_track", "fixed",
                        "--data.eval_elevation", "90",
                        "--data.full_eval_size", "5")
                  + ["--log.platform", "cpu"])
    finally:
        Trainer.full_eval = full_eval
    assert tr.train_step == trained.train_step == 1
    want = load_pytree(resolve_ckpt_path(tr.exp_dir))["params"]
    got = avatar_tree(tr.state.avatar, tr.avatar_model)
    for k in ("positions", "planes", "alive", "lbs_weights"):
        assert torch.equal(got[k], want[k])
    assert _written(tr.exp_dir / "results") == sorted([
        f"step_000001/{i:04d}.png" for i in range(5)] + ["step_000001.mp4"])
    from dreamwaltz_g_tpu_torch.utils.media import load_image, read_video

    assert load_image(str(tr.exp_dir / "results" / "step_000001"
                          / "0004.png")).shape == (20, 28, 3)
    assert read_video(str(tr.exp_dir / "results"
                          / "step_000001.mp4")).shape[0] == 5
    assert len(scores) == 1 and 0.0 <= scores[0] <= 1.0


def _tram(root, seq="seq01", F=4):
    """A TRAM estimate: identity rotations, a person 3 m in front of the
    camera, a 36 x 20 frame."""
    d = Path(root) / seq
    (d / "animation").mkdir(parents=True)
    (d / "camera").mkdir()
    np.save(d / "animation" / "hps_track_0.npy",
            {"pred_rotmat": np.tile(np.eye(3), (F, 24, 1, 1)),
             "pred_shape": np.zeros((F, 10)),
             "pred_trans": np.tile([0.0, 0.0, 3.0], (F, 1, 1))},
            allow_pickle=True)
    np.save(d / "camera" / "camera.npy",
            {"pred_cam_R": np.tile(np.eye(3), (F, 1, 1)), "img_focal": 40.0,
             "img_center": np.asarray([18.0, 10.0])}, allow_pickle=True)


def _script_command(script):
    """The (last) ``python main.py`` command line of a script, with its
    variables filled in."""
    import shlex

    text = Path(script).read_text().split("python main.py")[-1]
    lines = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            if lines:
                break
            continue
        lines.append(ln.rstrip("\\").strip())
        if not ln.endswith("\\"):
            break
    cmd = " ".join(lines)
    for k, v in {"${exp_name}": "avatar", "${seq}": "seq01",
                 "${predefined_body_parts}": "hands,face"}.items():
        cmd = cmd.replace(k, v)
    return shlex.split(cmd)


@pytest.fixture(scope="module")
def trained_avatar(tmp_path_factory):
    """A one-step avatar checkpoint under ``avatar`` and every motion file
    the inference scripts name, each in its loader's layout."""
    from dreamwaltz_g_tpu_torch.main import main

    root = tmp_path_factory.mktemp("inference")
    main(_argv(root, "avatar", "--optim.iters", "1",
               "--log.save_interval", "1") + ["--log.platform", "cpu"])
    (root / "motions").mkdir()
    t = np.linspace(0, 1, 8, dtype=np.float32)[:, None]
    for name in ("talkshow", "aist"):
        np.save(root / "motions" / f"{name}.npy",
                0.2 * np.sin(t + np.arange(265, dtype=np.float32)))
    reenact_files(root / "reenact", video=False)
    _tram(root / "tram")
    return root


@pytest.mark.parametrize("script", [
    "scripts/train_w_expr.sh", "scripts/inference_talkshow.sh",
    "scripts/inference_aist.sh", "scripts/inference_canonical.sh",
    "scripts/inference_reenact.sh", "scripts/inference_tram.sh"])
def test_inference_scripts_run(trained_avatar, monkeypatch, script):
    """Step 3 of ``scripts/train_w_expr.sh`` and the five
    ``scripts/inference_*.sh`` command lines through the port's ``main``
    (tiny sizes appended, the motion files of each loader's layout): the
    checkpoint restored, ``full_eval_size`` frames written."""
    from dreamwaltz_g_tpu_torch.main import main

    root = trained_avatar
    for var, sub in (("DEMO_MOTIONS", "motions"),
                     ("MOTIONX_REENACT_ROOT", "reenact"),
                     ("TRAM_ROOT", "tram")):
        monkeypatch.setattr(tpaths, var, str(root / sub))
    argv = _script_command(script)
    assert "--log.eval_only" in argv and "--optim.resume" in argv
    tiny = [a for a in _argv(root, "avatar") if a not in ("--stage", "gs")]
    tr = main(argv + tiny + ["--data.full_eval_size", "3",
                             "--log.eval_dirname", Path(script).stem,
                             "--log.platform", "cpu"])
    assert tr.train_step == 1
    out = tr.exp_dir / Path(script).stem / "step_000001"
    assert len(list(out.glob("*.png"))) == 3

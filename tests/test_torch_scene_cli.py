"""The scene options through the port's CLI (``main``) on the CPU, one
short chain each: ``--render.use_mlp_background`` (the split step and its
Adan), ``--render.use_gs_background`` with ``--render.avatar_scale`` /
``avatar_transl`` (on the hybrid and the vanilla avatar), and
``--optim.ckpt_extra`` (a second avatar from another run's checkpoint) with
per-avatar placement.

Each trains two steps in one run, against one step, a checkpoint, a fresh
trainer restoring it (``--optim.resume``) and one more step: the two final
checkpoints equal to the bit, every tensor of them (the avatar, the
optimizer, the generators and, with the MLP background, its weights and
Adan state under "background"). Then ``evaluate`` writes finite frames."""
import numpy as np
import pytest
import torch

from tests.test_torch_scene import write_background_ply
import tests.torch_threads  # noqa: F401  (per-worker threads)


def _args(tmp_path, case, name, save_interval):
    args = ["--stage", "gs", "--optim.iters", "2",
            "--log.save_interval", str(save_interval),
            "--log.max_keep_ckpts", "0", "--data.eval_size", "2",
            "--data.train_w", "16", "--data.train_h", "16",
            "--render.n_gaussians", "96", "--prompt.scene", "canonical-R",
            "--log.debug", "true", "--log.platform", "cpu",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--data.eval_h", "16", "--data.eval_w", "16",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0"]
    if case == "mlp_background":
        return args + ["--render.use_mlp_background", "true"]
    if case in ("gs_background", "vanilla_gs_background"):
        return args + ["--render.use_gs_background",
                       str(tmp_path / "bg.ply"),
                       "--render.avatar_scale", "0.9",
                       "--render.avatar_transl", "[0.05, 0.0, -0.02]"] + (
            ["--render.gs_type", "vanilla"] if case.startswith("vanilla")
            else [])
    return args + ["--optim.ckpt_extra", str(tmp_path / "other"),
                   "--render.avatar_transl", "[[0.3, 0, 0], [-0.3, 0, 0]]"]


def _flat(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{name}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{name}.{i}")
    else:
        yield name, tree


@pytest.mark.parametrize("case", ["mlp_background", "gs_background",
                                  "vanilla_gs_background", "ckpt_extra"])
def test_scene_cli_trains_resumes_and_evaluates(tmp_path, case):
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.checkpoint import load_pytree

    write_background_ply(tmp_path / "bg.ply")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if case == "ckpt_extra":
            main(_args(tmp_path, "mlp_background", "other", 0)[:-2]
                 + ["--log.exp_name", "other", "--optim.iters", "1"])
        whole = main(_args(tmp_path, case, "whole", 0))
        first = main(_args(tmp_path, case, "split", 1))
        assert first.checkpointer.all_steps() == [1, 2]
        (tmp_path / "split" / "checkpoints" / "step_00000002").rename(
            tmp_path / "step_2_aside")
        resumed = main(_args(tmp_path, case, "split", 0)
                       + ["--optim.resume", "true"])
    finally:
        torch.set_num_threads(threads)
    assert resumed.train_step == whole.train_step == 2
    assert len(whole.losses) == 2 and np.isfinite(whole.losses).all()
    assert resumed.losses == whole.losses[1:]
    got = dict(_flat(load_pytree(tmp_path / "split" / "checkpoints"
                                 / "step_00000002")))
    want = dict(_flat(load_pytree(tmp_path / "whole" / "checkpoints"
                                  / "step_00000002")))
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    if case == "mlp_background":
        assert any(k.startswith(".background.net.") for k in want)
        seed = main(_args(tmp_path, case, "seed", 0)
                    + ["--optim.iters", "0"])
        assert not torch.equal(seed.bg_net.dense_0.weight,
                               whole.bg_net.dense_0.weight)
        assert whole.sds_step_fn.__qualname__.startswith(
            "make_avatar_sds_step_split")
    if case.endswith("gs_background"):
        assert whole._static_bg_gaussians().positions.shape == (300, 3)
        assert whole._placement()[0] == np.float32(0.9)
    if case == "ckpt_extra":
        assert len(whole.extra_states) == 1
        assert whole.extra_states[0].capacity == \
            whole.extra_states[0].params.positions.shape[0]
    frames = whole.evaluate(save_dir=tmp_path / "ev")
    assert len(frames) == 2
    for f in frames:
        assert f.shape == (16, 16, 3) and np.isfinite(f).all()
    if case == "mlp_background":
        # the learned background at the eval camera, not a flat color
        assert float(np.std(frames[0][0])) > 0

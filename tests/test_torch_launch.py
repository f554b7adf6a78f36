"""The multi-card launch on the CPU: ``torchrun --nproc_per_node 2 -m
dreamwaltz_g_tpu_torch.main --log.platform cpu`` (``main.init_distributed``
starts a ``gloo`` group, every rank runs the trainer, rank 0 writes).

* A tiny stage-2 run at ``--optim.batch_size 2`` (dp = 2, a view a rank)
  with an evaluation of 4 frames at its last step (the frame-parallel
  eval: 2 frames a rank, gathered): one ``config.json``, one log, one
  checkpoint, the frames' PNGs and the mp4 once; the two ranks' final
  states equal to the bit (the trainer's check at the checkpoint, in the
  log); the losses and every frame against the same run in one process
  (the losses within 1e-4 relative, the frames within one 8-bit level).
* The same at ``--parallel.tp 2 --optim.batch_size 1`` (dp = 1: one view
  on two ranks, the tiny UNet's two heads a block split; the guidance in
  float32), against the one-process run of the multi-view step at one
  view; and stage 1 at ``--optim.batch_size 2`` with the occupancy grid
  refreshed every step (the grid in the checkpoint the ranks compare).
* The trainer's check of the ranks' states at a checkpoint raises on
  both ranks when one bit differs.
* The defaults (one view, tp = 1) on two ranks: replicas of one data
  index through the multi-view step, their gradients averaged, against
  that step in one process; and the DMTet finetune on two ranks, its
  single-view step averaging the ranks' gradients, against the same run
  in one process.

Each launch runs under a deadline (``subprocess.run``'s timeout) with one
intra-op thread a rank.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import tests.torch_threads  # noqa: F401  (per-worker threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_SECONDS = 180
FRAMES = 4
# the DMTet finetune from a random field (``tests/test_torch_trainer.py``'s)
DMTET = ["--stage", "nerf", "--nerf.dmtet", "true", "--nerf.tet_grid_size",
         "12", "--nerf.density_prior", "gaussian", "--nerf.density_thresh",
         "2.0", "--nerf.bound", "1.0", "--render.tile_size", "8",
         "--render.tile_capacity", "256", "--render.chunk", "64",
         "--nerf.lr_policy", "cosine"]


def _argv(root, name, *extra):
    return ["--stage", "gs", "--optim.iters", "2", "--render.n_gaussians",
            "128", "--log.debug", "true", "--log.exp_root", str(root),
            "--log.exp_name", name, "--log.platform", "cpu",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--data.train_w", "16", "--data.train_h", "16",
            "--data.eval_h", "16", "--data.eval_w", "16",
            "--data.test_h", "16", "--data.test_w", "16",
            "--data.eval_size", str(FRAMES), "--log.snapshot_interval", "0",
            "--log.evaluate_interval", "2", "--log.save_interval", "0",
            *extra]


def _torchrun(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "dreamwaltz_g_tpu_torch.main",
           *argv]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=LAUNCH_SECONDS)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def _files(exp):
    return sorted(str(p.relative_to(exp)) for p in exp.rglob("*")
                  if p.is_file())


def _losses(log):
    return [float(x) for x in re.findall(r"loss=([-0-9.e]+)", log)]


def _one_process(tmp_path, name, *extra):
    """The run in this process, through the multi-view step on a one-rank
    mesh (the step of every launch of several ranks; ``main.run`` would
    take the single-view step at one view and tp = 1, with other noise
    draws). The DMTet finetune has its one step either way."""
    import torch

    from dreamwaltz_g_tpu_torch.configs import parse_args
    from dreamwaltz_g_tpu_torch.parallel import make_mesh_2d
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(parse_args(_argv(tmp_path, name, *extra)))
        if tr.mesh is None:
            tr.mesh = make_mesh_2d(1, 1, device="cpu")
            tr._rebuild_train_step()
        tr.train()
        return tr
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("flags, one_flags", [
    (["--optim.batch_size", "2"], ["--optim.batch_size", "2"]),
    # float32 guidance: its bf16 partial sums round otherwise than the
    # whole products (chip_smoke.py bounds that on the card)
    (["--parallel.tp", "2", "--guide.dtype", "fp32"],
     ["--guide.dtype", "fp32"]),
    # stage 1, the occupancy grid refreshed every step (the checkpoint's
    # "grid" is among the tensors the ranks' check compares)
    (["--stage", "nerf", "--optim.batch_size", "2",
      "--nerf.update_extra_interval", "1"],
     ["--stage", "nerf", "--optim.batch_size", "2",
      "--nerf.update_extra_interval", "1"]),
    # the defaults: one view on two ranks, replicas of one data index
    ([], []),
    (DMTET, DMTET)], ids=["dp2", "tp2", "nerf_dp2", "replicas2", "dmtet2"])
def test_torchrun_writes_once_and_ranks_agree(tmp_path, flags, one_flags):
    _torchrun(_argv(tmp_path, "ranks", *flags))
    exp = tmp_path / "ranks"
    frames = [f"results/step_000002/{i:04d}.png" for i in range(FRAMES)]
    assert _files(exp) == sorted(
        ["checkpoints/step_00000002/state.pt", "config.json", "log.txt",
         "results/step_000002.mp4"] + frames)
    log = (exp / "log.txt").read_text()
    assert "step 2: the 2 ranks' states agree" in log
    assert "differ" not in log
    # the same run in one process (tp = 1)
    one = _one_process(tmp_path, "one", *one_flags)
    # (a process adds its log file handler once, in its first run)
    assert [f for f in _files(tmp_path / "one") if f != "log.txt"] \
        == [f for f in _files(exp) if f != "log.txt"]
    got = _losses(log)
    assert len(got) == 2
    np.testing.assert_allclose(got, one.losses, rtol=1e-4)
    for f in frames:
        a = np.asarray(Image.open(exp / f), np.int32)
        b = np.asarray(Image.open(tmp_path / "one" / f), np.int32)
        assert np.abs(a - b).max() <= 1, f


@pytest.mark.parametrize("differ", [False, True], ids=["equal", "one_bit"])
def test_ranks_check_raises_on_a_difference(differ):
    """The checkpoint's check of the ranks' states: a tree equal on both
    ranks passes, one bit flipped in one float on rank 1 raises on both."""
    from tests.torch_ranks import check_agree_rank, run_ranks

    got = run_ranks(check_agree_rank, 2, differ)
    if differ:
        assert got == ["step 3: the 2 ranks' states differ in 1 of 4 "
                       "tensors"] * 2
    else:
        assert got == [None, None]

"""The B-view avatar step across two ranks: two ``gloo`` processes on the
CPU, B = 2 views, one view each, against the one-process step on the same
two views.

Each rank builds the same tiny avatar, guidance and inputs from seeds (no
JAX: the port alone), runs ``make_avatar_sds_step_dp`` with the default
group of world 2 (its view sliced by ``mesh.shard_batch``, every gradient
and the ``dummy``'s all-reduced to the ranks' mean, the radii to their
maximum) and writes what it holds; the parent runs the same step in one
process. Within float32 rounding: the loss, every gradient, the
densification statistics, and the updated parameters where the gradient is
well above rounding (Adam's first step is +-lr sign(g)); both ranks hold
the same state. The ranks are spawned with a join deadline of 120 s: a
rank that misses it is killed and the test fails. And the data axis's
helpers (``parallel/mesh.py``) on their own.
"""
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import tests.torch_threads  # noqa: F401  (per-worker threads)

B = 2
H = W = 32
LATENT = 16
RASTER = dict(tile_size=16, capacity=128, chunk=128)
JOIN_SECONDS = 120


def _setup():
    """The tiny avatar, its train state, the guidance and the B views'
    inputs, all from seeds."""
    from dreamwaltz_g_tpu_torch import tests_support as tts
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
    from dreamwaltz_g_tpu_torch.training import optim as TO

    torch.manual_seed(0)
    tset = tts.tiny_avatar_setup(device="cpu")
    sd, gp = tts.tiny_guidance(1, latent_size=LATENT, device="cpu")
    tx = TO.build_avatar_optimizer(RenderConfig(), 100)
    ts = TG.init_avatar_train_state(tset.state, tx, tset.model)
    cam = make_camera_batch([2.0, 2.3], [20.0, 60.0], [90.0, 150.0],
                            [50.0, 45.0], H, W, at_vector=((0, 0.7, 0),),
                            device="cpu")
    rng = np.random.default_rng(3)
    T = torch.as_tensor
    f32 = np.float32
    x = dict(bg=T(rng.uniform(size=(B, H, W, 3)).astype(f32)),
             txt=T(rng.normal(size=(B, 4, 32)).astype(f32)),
             unc=T(np.zeros((B, 4, 32), f32)),
             t=T(np.array([500, 300], np.int32)),
             noise=T(rng.normal(size=(B, LATENT, LATENT, 4)).astype(f32)))
    return tset, ts, sd, gp, cam, x


def _run(group_world, replicas=False):
    """One step; returns what a rank holds after it, as numpy. With
    ``replicas`` the mesh has one data index, so every rank runs both
    views."""
    from dreamwaltz_g_tpu_torch.parallel.dp import make_avatar_sds_step_dp
    from dreamwaltz_g_tpu_torch.parallel.mesh import make_mesh_2d
    from dreamwaltz_g_tpu_torch.training import gs_trainer as TG

    tset, ts, sd, gp, cam, x = _setup()
    mesh = make_mesh_2d(1, 1, device="cpu") if replicas else None
    step = make_avatar_sds_step_dp(tset.model, sd, H, W, device="cpu",
                                   mesh=mesh, **RASTER)
    new, metrics = step(ts, gp, tset.observed, cam.extrinsic,
                        cam.intrinsics, cam.tanfov, x["bg"], x["txt"],
                        x["unc"], x["t"], noise=x["noise"])
    leaves = TG._leaves(new.avatar, tset.model)
    return dict(
        loss=float(metrics["loss"]),
        grads=[None if p.grad is None else p.grad.numpy().copy()
               for p in leaves],
        params=[p.detach().numpy().copy() for p in leaves],
        grad_accum=new.avatar.grad_accum.numpy().copy(),
        grad_denom=new.avatar.grad_denom.numpy().copy(),
        max_radii=new.avatar.max_radii.numpy().copy())


def _rank(rank, port, out_dir, replicas=False):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                np.array(_run(2, replicas), dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _close(got, want, name, floor=1e-30):
    """Float32 rounding: a view's batched convolutions and matmuls block
    their sums otherwise than an unbatched one's (1e-4 relative, 1e-5 of
    the tensor's largest entry, or of ``floor`` for a gradient that is
    float32 noise: the quaternions', every Gaussian starting isotropic)."""
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=name)


def test_two_ranks_equal_one_process(tmp_path):
    _check_ranks(tmp_path, replicas=False)


def test_replica_ranks_equal_one_process(tmp_path):
    """On a mesh of one data index (``--parallel.dp 1`` on two ranks) both
    ranks run both views, their gradients averaged too: the replicas stay
    equal to the bit."""
    _check_ranks(tmp_path, replicas=True)


def _check_ranks(tmp_path, replicas):
    ctx = mp.start_processes(_rank, args=(_free_port(), str(tmp_path),
                                          replicas),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                pytest.fail(f"the ranks missed the {JOIN_SECONDS} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).item()
             for r in range(2)]
    torch.set_num_threads(1)
    want = _run(1)
    for got in ranks:
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        np.testing.assert_array_equal(got["grad_denom"], want["grad_denom"])
        np.testing.assert_array_equal(got["max_radii"], want["max_radii"])
        assert want["grad_denom"].sum() > 0
        _close(got["grad_accum"], want["grad_accum"], "grad_accum")
        assert sum(g is not None for g in want["grads"]) > 5
        floor = 1e-3 * max(float(np.abs(w).max()) for w in want["grads"]
                           if w is not None)
        for i, (g, w, p, q) in enumerate(zip(got["grads"], want["grads"],
                                             got["params"], want["params"])):
            assert (g is None) == (w is None), i
            if w is None:
                continue
            _close(g, w, f"grad {i}", floor)
            sure = np.abs(w) > 1e-3 * max(np.abs(w).max(), 1e-30)
            np.testing.assert_allclose(p[sure], q[sure], rtol=1e-6,
                                       atol=1e-6, err_msg=f"param {i}")
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_data_axis_helpers():
    """``--parallel.dp``'s resolution (the JAX trainer's: -1 is every
    rank, clamped to the world and the batch, dividing the batch), a
    rank's slice of the views, and the one-process mesh."""
    from dreamwaltz_g_tpu_torch.parallel import mesh as M

    assert M.resolve_dp(-1, 1, 4) == 1
    assert M.resolve_dp(-1, 4, 8) == 4
    assert M.resolve_dp(8, 4, 2) == 2
    assert M.resolve_dp(2, 4, 6) == 2
    with pytest.raises(ValueError, match="must divide"):
        M.resolve_dp(-1, 4, 6)
    one = M.make_mesh(device="cpu")
    assert (one.world, one.rank, one.shape) == (
        1, 0, {M.DATA_AXIS: 1, M.MODEL_AXIS: 1})
    x = torch.arange(8.0).reshape(4, 2)
    assert M.shard_batch(x, one) is x and M.replicate(x, one) is x
    two = M.DataMesh(world=2, rank=1, device=torch.device("cpu"))
    assert M.local_batch_size(4, two) == 2
    got = M.shard_batch((x, [10, 11, 12, 13], None, 3.0), two)
    assert torch.equal(got[0], x[2:]) and got[1] == [12, 13]
    assert got[2] is None and got[3] == 3.0
    with pytest.raises(ValueError, match="not divisible"):
        M.shard_batch(x[:3], two)

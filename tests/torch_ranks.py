"""Spawned ``gloo`` ranks for the port's multi-card tests on the CPU.

``run_ranks(fn, n, *args)`` starts ``n`` processes (``spawn``), each with
one intra-op thread and the default group of world ``n`` on
``tcp://localhost``, runs ``fn(rank, n, *args)`` in each and returns their
results in rank order (``torch.save`` through a temporary directory). A
rank that misses the join deadline is killed and the test fails. ``fn``
and this module import no JAX: the ranks run the port alone; what they
need of the JAX side is handed in (``save`` / ``load``: pickled objects,
modules included). With ``cuda=True`` every rank takes card 0 (a ``gloo``
group on one card: NCCL refuses two ranks on one device), and the rank
functions run on the device their inputs name (``device``, else the
CPU).

The rank functions of ``test_torch_tp.py``, ``test_torch_shard_render.py``
and ``test_torch_multicard_gpu.py`` live here, so that a spawned rank
imports none of those files.
"""
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOIN_SECONDS = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def save(path, obj) -> str:
    torch.save(obj, path)
    return str(path)


def load(path):
    return torch.load(path, weights_only=False)


def _entry(rank, fn, world, port, out_dir, backend, cuda, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn, world, *args, backend="gloo", cuda=False,
              seconds=JOIN_SECONDS):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks (module
    docstring); returns their results."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _entry, args=(fn, world, _free_port(), out_dir, backend, cuda,
                          args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + seconds
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() >= deadline:
                    pytest.fail(f"the ranks missed the {seconds} s deadline")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [load(os.path.join(out_dir, f"rank{r}.pt"))
                for r in range(world)]


# -- tensor-parallel guidance (test_torch_tp.py) ----------------------------

def tp_eps(rank, world, path):
    """This rank's eps prediction of the guidance handed in at ``path``
    (``sd``, ``gp``, ``lat``, ``t``, ``ctx``, ``cond``), its UNet and
    ControlNet sharded over a model axis of ``world`` ranks (dp = 1)."""
    from dreamwaltz_g_tpu_torch.guidance import flash
    from dreamwaltz_g_tpu_torch.parallel import make_mesh_2d
    from dreamwaltz_g_tpu_torch.parallel.tp import shard_guidance_params

    x = load(path)
    mesh = make_mesh_2d(dp=1, tp=world, device=x.get("device", "cpu"))
    gp = shard_guidance_params(x["gp"], mesh)
    heads = sorted({m.heads for m in gp.unet.modules() if hasattr(m, "heads")
                    and hasattr(m, "to_q")})
    flash.flash_attn_fwd.launches = 0
    with torch.no_grad():
        eps = x["sd"]._eps(gp, x["lat"], x["t"], x["ctx"], x["cond"])
    return {"eps": eps.cpu().numpy(), "heads": heads,
            "flash": flash.flash_attn_fwd.launches}


def tp_block_grad(rank, world, path):
    """The input gradient of ``sum(block(x) * w)`` through the transformer
    block handed in at ``path``, its attention and feed-forward sharded
    over ``world`` ranks: the column-parallel input's backward all-reduce
    makes it whole on every rank."""
    from dreamwaltz_g_tpu_torch.guidance.layers import (Attention,
                                                        FeedForwardGEGLU)
    from dreamwaltz_g_tpu_torch.parallel import make_mesh_2d
    from dreamwaltz_g_tpu_torch.parallel import tp as TP

    x = load(path)
    mesh = make_mesh_2d(dp=1, tp=world, device="cpu")
    block = x["block"]
    for m in block.modules():
        if isinstance(m, Attention):
            TP._shard_attention(m, world, mesh.model_rank, mesh.model_group)
        elif isinstance(m, FeedForwardGEGLU):
            TP._shard_geglu(m, world, mesh.model_rank, mesh.model_group)
    inp = x["x"].clone().requires_grad_(True)
    out = block(inp, x["ctx"])
    (out * x["w"]).sum().backward()
    return {"out": out.detach().numpy(), "grad": inp.grad.numpy()}


def dp_tp_avatar_step(rank, world, path, dp, tp):
    """The port's B-view avatar step on a (dp, tp) mesh of ``world``
    ranks, on the inputs handed in at ``path`` (``test_torch_dp_avatar``'s
    ``port`` dict): returns the loss, each leaf's gradient and the
    densification statistics."""
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
    from dreamwaltz_g_tpu_torch.parallel import dp as TDP
    from dreamwaltz_g_tpu_torch.parallel import make_mesh_2d
    from dreamwaltz_g_tpu_torch.parallel.tp import shard_guidance_params
    from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
    from dreamwaltz_g_tpu_torch.training import optim as TO

    p = load(path)
    mesh = make_mesh_2d(dp=dp, tp=tp, device="cpu")
    model, x, tc = p["model"], p["x"], p["cam"]
    gp = shard_guidance_params(p["gp"], mesh)
    tx = TO.build_avatar_optimizer(RenderConfig(), p["max_steps"])
    ts = TG.init_avatar_train_state(
        avatar_state_from_numpy(p["tree"], model, device="cpu"), tx, model)
    step = TDP.make_avatar_sds_step_dp(
        model, p["sd"], p["H"], p["W"], mesh=mesh, device="cpu",
        **p["raster"])
    T = torch.as_tensor
    new, metrics = step(ts, gp, p["obs"], tc.extrinsic, tc.intrinsics,
                        tc.tanfov, T(x["bg"]), T(x["txt"]), T(x["unc"]),
                        T(x["t"]), noise=T(p["noise"]))
    leaves = TG._leaves(new.avatar, model)
    return {"loss": float(metrics["loss"]),
            "grads": [None if t.grad is None else t.grad.numpy()
                      for t in leaves],
            "params": [t.detach().numpy() for t in leaves],
            "grad_denom": new.avatar.grad_denom.numpy(),
            "max_radii": new.avatar.max_radii.numpy(),
            "grad_accum": new.avatar.grad_accum.numpy()}


# -- the sharded render and the frame-parallel eval --------------------------

def sharded_render(rank, world, path):
    """``make_sharded_render`` over the data axis of ``world`` ranks on the
    scene handed in at ``path``."""
    from dreamwaltz_g_tpu_torch.parallel import make_mesh
    from dreamwaltz_g_tpu_torch.parallel.shard_render import \
        make_sharded_render

    from dreamwaltz_g_tpu_torch.ops import blend

    s = load(path)
    render = make_sharded_render(make_mesh(device=s.get("device", "cpu")),
                                 s["H"], s["W"], **s["raster"])
    blend.blend_sorted.launches = 0
    out = render(*s["args"])
    return [t.cpu().numpy() for t in out] + [blend.blend_sorted.launches]


def render_frames(rank, world, path):
    """``make_avatar_render_frames(mesh=)`` over the data axis of
    ``world`` ranks: the frames handed in at ``path``; returns them and
    how many frames this rank rendered."""
    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.parallel import make_mesh
    from dreamwaltz_g_tpu_torch.training import gs_trainer as TG

    f = load(path)
    calls = []
    inner = R.blend_sorted

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    R.blend_sorted = counted
    dev = f.get("device", "cpu")
    rf = TG.make_avatar_render_frames(f["model"], f["H"], f["W"],
                                      mesh=make_mesh(device=dev),
                                      device=dev, **f["raster"])
    out = rf(f["state"], *f["args"])
    return {"frames": [t.cpu().numpy() for t in out], "blends": len(calls)}


def check_agree_rank(rank, world, differ):
    """``Trainer._check_ranks_agree`` on a checkpoint tree that differs on
    rank 1 in one bit of one float when ``differ``: None, or the error."""
    from types import SimpleNamespace

    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    w = torch.linspace(0.0, 1.0, 5)
    if differ and rank == 1:
        w.view(torch.int32)[2] ^= 1
    tree = {"params": {"w": w, "b": torch.zeros(2, dtype=torch.bfloat16)},
            "opt_state": [torch.arange(3)], "grid": {"bits": torch.ones(
                4, dtype=torch.uint8)}}
    me = SimpleNamespace(train_step=3, world=world,
                         device=torch.device("cpu"))
    try:
        Trainer._check_ranks_agree(me, tree)
    except RuntimeError as e:
        return str(e)
    return None


def state_equal(a, b) -> bool:
    """Two ranks' numpy trees equal to the bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(state_equal, a, b))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b))

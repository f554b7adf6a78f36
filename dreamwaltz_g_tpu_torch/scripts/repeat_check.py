"""Does stage 1 repeat to the bit on the card?

Default mode: one stage-1 SDS step of a tiny NeRF (a 16^2 x 8 triplane, a
16^3 grid, 64^2 rays in checkpointed chunks of 1,000, sigma guidance,
volume sparsity, the background MLP) with the tiny float32 guidance and
its ControlNet twice from copies of the same field, grid and draws, under
each cuDNN setting: ``default`` (cuDNN free to pick any convolution
algorithm: ``_device.CUDNN_DETERMINISTIC`` off), ``deterministic``
(``torch.backends.cudnn.deterministic``, what ``resolve_device`` sets by
default) and ``deterministic_algorithms``
(``torch.use_deterministic_algorithms(True, warn_only=True)``; the
warnings it raised name the other nondeterministic ops). Then
``nerf/export.py:export_point_cloud`` of one field at 400^3, twice. Prints
one JSON line a setting and one for the export: the elements of the
gradients and updated weights that differ and their largest difference.

    python -m dreamwaltz_g_tpu_torch.scripts.repeat_check [--flash on|off]

``--full``: the first step of step 1.2 at full width (``NeRFConfig()``:
a 256^2 x 32 triplane, a 128^3 grid, 96 samples a ray compacted to 32,
rays in checkpointed chunks of 4,096; a 512^2 render; the SD1.5-size bf16
UNet + ControlNet + VAE with random weights under ``FLASH_ATTENTION =
"auto"``; sigma guidance on 5,000 points of an SMPL-X-sized body, drawn
in each step as the trainer draws them), replayed
``--replays`` times in one process from copies of one field, grid and
generator state, each replay held to the first to the bit. Prints one JSON
line a mode (``--modes``, in order):

* ``plain``: as the trainer runs;
* ``poison``: before each replay the caching allocator's free memory is
  filled with another value (0.0, NaN, 1e30, ...), so a read of memory
  that nothing wrote shows as a parting;
* ``trace``: ``poison`` with a bitwise checksum of every aten op's inputs
  and outputs and of every hand-written kernel's operands after its
  launch (``OpTrace``); a replay that parts names the ops whose outputs
  first differ from the first replay's.

"Repeats" means ``parted`` is 0: no replay's metrics, gradients or
updated weights differ from the first's in any bit (``worst``: the most
elements that differed in one replay and their largest difference).
``--deterministic`` runs the modes under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set here before CUDA starts); if an
op refuses it, the line says which and the modes run again with
``warn_only=True``, the warnings listed.

    python -m dreamwaltz_g_tpu_torch.scripts.repeat_check --full \
        --replays 30 [--modes plain,poison,trace] [--deterministic]

``--faces``: the sigma guidance's face draw (5,000 faces of an
SMPL-X-sized body in proportion to area), 300 times from one generator
state, by ``torch.multinomial`` with replacement and by
``ops/mesh.py:sample_faces``: the calls that drew another face than the
first; then ``--full``'s plain mode with each draw in the step. ``--panel-sum``: B1's panel sum on the full-width stage-2 step
(``chip_smoke.py``'s train phase: the 200k-slot avatar at 512^2, the
SD1.5-size bf16 guidance), ``ops/blend_train.py:panel_grads`` against
``panel_sum_atomic`` (``index_add_``, the sum before it): the sum alone
and B1's backward (kernel + sum) at the step's operands by CUDA events, in
the order atomic, fixed, fixed, atomic; 20 calls of each sum against the
first; and the step replayed 4 times from a copy of its state with each.

    python -m dreamwaltz_g_tpu_torch.scripts.repeat_check --faces
    python -m dreamwaltz_g_tpu_torch.scripts.repeat_check --panel-sum
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import time
import warnings

S, CHUNK, STEPS = 64, 1000, 16

FULL = 512              # the full-width render's side (step 1.2)
SIGMA_POINTS = 5000     # sigma-guidance points a step
MAX_STEPS = 5000        # the optimizer's schedule length
# the values the free memory is filled with before each poisoned replay
POISON = (0.0, float("nan"), 1e30, -1.5, 1e-40, float("-inf"), 7.0)


def _to(x, dev):
    import torch

    if torch.is_tensor(x) or isinstance(x, torch.nn.Module):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def stage1_inputs(dev):
    """The tiny field's configuration, the field (on the CPU), its grid,
    the tiny guidance and the step's inputs and draws (on ``dev``), all
    from seed 0."""
    import torch

    from .. import tests_support
    from ..configs import NeRFConfig
    from ..human.smplx_model import make_synthetic_model
    from ..nerf.network import build_nerf
    from ..nerf.renderer import init_occupancy, update_occupancy
    from ..training import nerf_trainer as NT
    from ..training.losses import (
        make_sigma_guidance_points,
        volume_sparsity_draws,
    )

    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, grid_size=16,
                     num_steps=STEPS, compact_steps=8, lambda_opacity=1e-2)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    field = build_nerf(cfg, generator=gen, device=cpu)
    grid = update_occupancy(init_occupancy(cfg.grid_size, device=cpu), field,
                            generator=gen)
    body = make_synthetic_model(num_vertices=120, num_joints=6, device=cpu)
    inputs = dict(
        sigma_pts=make_sigma_guidance_points(body.v_template, body.faces, 256,
                                             generator=gen),
        txt=torch.randn((1, 4, 32), generator=gen),
        cond=torch.rand((1, S, S, 3), generator=gen),
        jitter=torch.rand(NT.jitter_shape(S, S, CHUNK, STEPS), generator=gen),
        noise=torch.randn((1, S // 2, S // 2, 4), generator=gen),
        vs_draws=volume_sparsity_draws(gen, cfg.bound, n_surface=S * S))
    sd, gp = tests_support.tiny_guidance(0, with_controlnet=True,
                                         latent_size=S // 2, device=cpu)
    sd = dataclasses.replace(sd, schedule=sd.schedule.to(dev))
    return cfg, field, _to(grid, dev), sd, _to(gp, dev), _to(inputs, dev)


def stage1_step(dev, cfg, field, grid, sd, gp, x):
    """One step from a copy of ``field``: (metrics, gradients, updated
    weights), on the CPU."""
    import torch

    from ..data.camera import make_camera_batch
    from ..training import nerf_trainer as NT
    from ..training.optim import build_nerf_optimizer, nerf_param_groups

    model = copy.deepcopy(field).to(dev)
    ts = NT.init_train_state(model, build_nerf_optimizer(cfg, 5000))
    step = NT.make_nerf_sds_step(model, sd, S, S, cfg, num_steps=STEPS,
                                 max_iteration=5000, bg_mode="nerf",
                                 ray_chunk=CHUNK, device=dev)
    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, S, S, device=dev)
    _, metrics = step(
        ts, grid, gp, cam.c2w[0], cam.intrinsics[0],
        torch.full((3,), 0.5, device=dev), x["txt"],
        torch.zeros_like(x["txt"]), torch.tensor([500], device=dev),
        cond_image=x["cond"], sigma_pts=x["sigma_pts"], use_sigma=True,
        jitter=x["jitter"], noise=x["noise"], vs_draws=x["vs_draws"])
    params = [p for ps in nerf_param_groups(model).values() for p in ps]
    return ({k: float(v) for k, v in metrics.items()},
            [torch.zeros(0) if p.grad is None else p.grad.detach().cpu()
             for p in params],
            [p.detach().cpu() for p in params])


def differ(a, b) -> dict:
    """How two runs' tensors part, to the bit, over lists of tensors paired
    in order: the elements that differ (NaN against NaN counts as equal;
    -1 when two shapes differ) and their largest difference."""
    n, worst = 0, 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return {"differing": -1, "max_abs_diff": math.inf}
        neq = x != y
        if x.is_floating_point():
            neq &= ~(x.isnan() & y.isnan())
        n += int(neq.sum())
        if neq.any():
            worst = max(worst, float((x.double() - y.double()).abs()[neq]
                                     .max()))
    return {"differing": n, "max_abs_diff": worst}


def export_twice(dev, resolution: int = 400):
    """Two exports of one tiny field with a Gaussian density prior: (the
    kept counts and points of each)."""
    from ..configs import NeRFConfig
    from ..nerf.export import export_point_cloud
    from ..nerf.network import build_nerf

    cfg = NeRFConfig(triplane_resolution=32, triplane_dim=8,
                     density_prior="gaussian", bound=1.0)
    field = build_nerf(cfg, device=dev)
    runs = []
    for _ in range(2):
        stats = {}
        pc = export_point_cloud(field, resolution=resolution,
                                density_thresh=2.0, max_points=100_000,
                                min_neighbors=2, stats=stats)
        runs.append((stats, pc))
    return runs


def full_inputs(dev, size: int = FULL, guidance=None):
    """The full-width stage-1 step's state and inputs, from seeds 0 and 1:
    ``NeRFConfig()``'s field with its background MLP, the occupancy grid
    after one refresh, the SD1.5-size bf16 guidance with its ControlNet
    (``guidance``: another (ScoreDistillation, GuidanceParams)), an
    SMPL-X-sized synthetic body for the sigma guidance, 77-token
    text and null embeddings, a random pose canvas, the scheduler's first
    timestep and guidance scale, and the camera; all on ``dev``. Returns
    (config, field, grid, (guidance, params), inputs, generator)."""
    import torch

    from .. import tests_support
    from ..configs import GuideConfig, NeRFConfig
    from ..data.camera import make_camera_batch
    from ..guidance.time_prior import TimePrioritizedScheduler
    from ..human.smplx_model import make_synthetic_model
    from ..nerf.network import build_nerf
    from ..nerf.renderer import init_occupancy, update_occupancy

    cfg = NeRFConfig()
    gen = torch.Generator(device=dev).manual_seed(1)
    field = build_nerf(cfg, with_background=True, generator=gen, device=dev)
    grid = update_occupancy(init_occupancy(cfg.grid_size, device=dev), field,
                            generator=gen, density_thresh=cfg.density_thresh)
    sd, gp = guidance or tests_support.sd15_guidance(0, device=dev)
    dt = gp.unet.conv_in.weight.dtype
    body = make_synthetic_model(num_vertices=10_475, num_joints=55,
                                num_betas=10, num_expr=10, device=dev)
    host = torch.Generator().manual_seed(0)
    width = gp.unet.cfg.cross_attention_dim
    sched = TimePrioritizedScheduler(GuideConfig(), seed=0, device=dev)
    cam = make_camera_batch(3.0, 30.0, 80.0, 45.0, size, size,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    x = dict(
        size=size, c2w=cam.c2w[0], intrinsics=cam.intrinsics[0],
        body=(body.v_template, body.faces),
        txt=torch.randn((1, 77, width), generator=host).to(dev, dt),
        unc=torch.randn((1, 77, width), generator=host).to(dev, dt),
        cond=torch.rand((1, size, size, 3), generator=host).to(dev, dt),
        timestep=sched.get_timestep(1, 1, MAX_STEPS),
        scale=sched.get_guidance_scale(1, MAX_STEPS))
    return cfg, field, grid, (sd, gp), x, gen


def full_step(dev, cfg, field, grid, guidance, x, gen, gen_state):
    """One step from a copy of ``field`` and the generator at
    ``gen_state``, as ``Trainer`` takes it (the step's sigma-guidance
    points drawn first): (metrics, gradients, updated weights), on
    ``dev``."""
    import torch

    from ..training import nerf_trainer as NT
    from ..training.losses import make_sigma_guidance_points
    from ..training.optim import build_nerf_optimizer

    sd, gp = guidance
    model = copy.deepcopy(field)
    ts = NT.init_train_state(model, build_nerf_optimizer(cfg, MAX_STEPS))
    step = NT.make_nerf_sds_step(
        model, sd, x["size"], x["size"], cfg, num_steps=cfg.num_steps,
        max_iteration=MAX_STEPS, bg_mode="color", ray_chunk=cfg.max_ray_batch,
        device=dev)
    gen.set_state(gen_state)
    pts = make_sigma_guidance_points(*x["body"], SIGMA_POINTS, generator=gen)
    _, metrics = step(
        ts, grid, gp, x["c2w"], x["intrinsics"],
        torch.full((3,), 0.5, device=dev), x["txt"], x["unc"],
        torch.as_tensor(x["timestep"], device=dev), generator=gen,
        cond_image=x["cond"], guidance_scale=x["scale"], sigma_pts=pts,
        use_sigma=True)
    params = list(model.parameters())
    return ({k: float(v) for k, v in metrics.items()},
            [torch.zeros(0) if p.grad is None else p.grad.detach().clone()
             for p in params],
            [p.detach().clone() for p in params])


def fill_free_memory(dev, value: float, fraction: float = 0.5):
    """Fill the caching allocator's free memory with ``value``: the cache
    is emptied, then one block of ``fraction`` of the card's free memory
    and 1,024 blocks of 1 MiB (the allocator's small pool) are filled and
    freed, so later allocations reuse them."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    big = torch.empty(int(free * fraction) // 4, dtype=torch.float32,
                      device=dev).fill_(value)
    small = [torch.empty(1 << 18, dtype=torch.float32, device=dev)
             .fill_(value) for _ in range(1024)]
    torch.cuda.synchronize(dev)
    del big, small


#: ops whose outputs are uninitialised memory, left out of the comparison
_UNWRITTEN = ("aten.empty", "aten.empty_like", "aten.empty_strided",
              "aten.new_empty", "aten.new_empty_strided")


class OpTrace:
    """Bitwise checksums, in order, of every aten op's inputs and outputs
    (forward, backward and optimizer; position-weighted sums of the bits)
    and of every hand-written kernel's operands after its launch
    (``guidance.flash._launch``, ``ops.blend_train._launch``: the trainer
    steps' kernels, B4 and B1). ``with OpTrace(modules) as trace:`` around a
    step; ``trace.entries`` then holds (name, autograd node or module,
    input sums, output sums) with the sums as integers. The trace's own
    ops and allocations change the allocator's pattern and the step's
    timing, so a parting that depends on them may hide under it."""

    def __init__(self, modules=()):
        self.names = {id(m): n for root in modules
                      for n, m in root.named_modules()}
        self.entries, self._sums, self._weights = [], [], {}
        self._modules = []

    def checksum(self, t):
        import torch

        t = t.detach()
        if t.is_complex() or t.layout != torch.strided:
            return torch.zeros((), dtype=torch.int64)
        size = t.element_size()
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[size]
        x = t.contiguous()
        x = (x.to(torch.uint8) if x.dtype == torch.bool else x.view(view))
        x = x.reshape(-1).to(torch.int64)
        w = self._weights.get(x.device)
        if w is None or w.numel() < x.numel():
            w = torch.arange(max(x.numel(), 1 << 20), device=x.device,
                             dtype=torch.int64) * 2654435761 % 4294967291 + 1
            self._weights[x.device] = w
        return (x * w[:x.numel()]).sum()

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        from ..guidance import flash as FL
        from ..ops import blend_train as BT

        trace = self

        def where():
            node = torch._C._current_autograd_node()
            if node is not None:
                return node.name()
            return trace._modules[-1] if trace._modules else ""

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                # the inputs' sums before the op, which may write them
                ins = [trace._push(trace.checksum(a))
                       for a in tree_flatten((args, kwargs))[0]
                       if torch.is_tensor(a)]
                out = func(*args, **kwargs)
                name = str(func)
                outs = [] if name.rsplit(".", 1)[0] in _UNWRITTEN else [
                    trace._push(trace.checksum(a))
                    for a in tree_flatten(out)[0] if torch.is_tensor(a)]
                trace.entries.append([name, where(), ins, outs])
                return out

        def wrap(module, attr):
            original = getattr(module, attr)

            def launch(fn_name, *args):
                original(fn_name, *args)
                with torch.utils._python_dispatch._disable_current_modes():
                    trace.entries.append([
                        "kernel." + fn_name, where(), [],
                        [trace._push(trace.checksum(a)) for a in args
                         if torch.is_tensor(a)]])
            setattr(module, attr, launch)
            return module, attr, original

        def pre(module, _):
            trace._modules.append(self.names.get(id(module),
                                                 type(module).__name__))

        def post(module, _, __):
            if trace._modules:
                trace._modules.pop()

        self._wrapped = [wrap(FL, "_launch"), wrap(BT, "_launch")]
        self._hooks = [
            torch.nn.modules.module.register_module_forward_pre_hook(pre),
            torch.nn.modules.module.register_module_forward_hook(post)]
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def _push(self, v):
        self._sums.append(v.to("cpu", non_blocking=True))
        return len(self._sums) - 1

    def __exit__(self, *exc):
        import torch

        self._mode.__exit__(*exc)
        for h in self._hooks:
            h.remove()
        for module, attr, original in self._wrapped:
            setattr(module, attr, original)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        values = [int(v) for v in self._sums]
        for e in self.entries:
            e[2] = [values[i] for i in e[2]]
            e[3] = [values[i] for i in e[3]]
        self._sums, self._weights = [], {}
        return False


def first_differences(a, b, limit: int = 12) -> dict:
    """Where two ``OpTrace.entries`` lists part: the entries (index, name,
    autograd node or module, inputs equal, outputs equal) whose outputs
    first differ, at most ``limit``; ``suspect`` is the first whose inputs
    are all equal and whose outputs are not (an op that parts by itself);
    ``diverged_at`` the first index where the op sequences differ."""
    out, suspect, diverged = [], None, None
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0] or len(x[2]) != len(y[2]) or len(x[3]) != len(y[3]):
            diverged = {"index": i, "first": x[:2], "again": y[:2]}
            break
        outs_eq = [p == q for p, q in zip(x[3], y[3])]
        if all(outs_eq):
            continue
        ins_eq = [p == q for p, q in zip(x[2], y[2])]
        line = {"index": i, "op": x[0], "at": x[1], "inputs_equal": ins_eq,
                "outputs_equal": outs_eq}
        if suspect is None and all(ins_eq):
            suspect = line
        if len(out) < limit:
            out.append(line)
        if suspect is not None and len(out) >= limit:
            break
    return {"ops": len(a), "ops_again": len(b), "differences": out,
            "suspect": suspect, "diverged_at": diverged}


def replay_full(dev, inputs, n: int, mode: str) -> dict:
    """``n`` replays of the full-width first step in ``mode`` (plain,
    poison or trace), each held to the first: the JSON line's fields."""
    import torch

    cfg, field, grid, guidance, x, gen = inputs
    gen_state = gen.get_state()
    names = [n_ for n_, _ in field.named_parameters()]
    first, first_trace, partings, worst, ms = None, None, [], None, []
    t_mode = time.perf_counter()
    for r in range(n):
        if mode in ("poison", "trace"):
            fill_free_memory(dev, POISON[r % len(POISON)])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mode == "trace":
            with OpTrace([field, *[m for m in guidance[1] if m is not None]]
                         ) as trace:
                out = full_step(dev, cfg, field, grid, guidance, x, gen,
                                gen_state)
        else:
            out = full_step(dev, cfg, field, grid, guidance, x, gen,
                            gen_state)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = out
            first_trace = trace.entries if mode == "trace" else None
            continue
        grads, params = differ(out[1], first[1]), differ(out[2], first[2])
        if out[0] == first[0] and not grads["differing"] \
                and not params["differing"]:
            continue
        line = dict(replay=r, metrics_equal=out[0] == first[0],
                    metrics=out[0], grads=grads, params=params,
                    differing_params=[
                        nm for nm, a, b in zip(names, out[1], first[1])
                        if differ([a], [b])["differing"]])
        if mode == "trace":
            line["trace"] = first_differences(first_trace, trace.entries)
        partings.append(line)
        if worst is None or grads["differing"] > worst["differing"]:
            worst = grads
    gen.set_state(gen_state)
    return dict(mode=mode, replays=n, parted=len(partings),
                worst=worst or {"differing": 0, "max_abs_diff": 0.0},
                partings=partings[:4], metrics=first[0],
                step_ms_median=sorted(ms)[len(ms) // 2],
                seconds=time.perf_counter() - t_mode)


def main_full(args) -> list:
    """``--full``: the modes in order, one JSON line each."""
    import torch

    from .. import _device
    from ..guidance import layers as TL

    dev = _device.resolve_device("cuda")
    if TL.FLASH_ATTENTION != "auto":
        raise RuntimeError(f"FLASH_ATTENTION is {TL.FLASH_ATTENTION!r}")
    inputs = full_inputs(dev)
    lines = []
    common = dict(size=FULL, config="NeRFConfig()", guidance="sd15 bf16",
                  flash=TL.FLASH_ATTENTION,
                  cudnn_deterministic=torch.backends.cudnn.deterministic,
                  deterministic_algorithms=args.deterministic)
    warn_only = False
    for mode in args.modes.split(","):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if args.deterministic:
                torch.use_deterministic_algorithms(True, warn_only=warn_only)
            try:
                line = replay_full(dev, inputs, args.replays, mode)
            except RuntimeError as e:
                if not args.deterministic or warn_only \
                        or "deterministic" not in str(e):
                    raise
                print(json.dumps(dict(common, mode=mode,
                                      refused=str(e)[:400])), flush=True)
                warn_only = True
                torch.use_deterministic_algorithms(True, warn_only=True)
                line = replay_full(dev, inputs, args.replays, mode)
        line.update(common, warn_only=warn_only if args.deterministic
                    else None, nondeterministic_warnings=sorted(
                        {str(w.message)[:120] for w in seen
                         if "deterministic" in str(w.message)}))
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def body_areas(dev):
    """The SMPL-X-sized synthetic body's face areas, clamped at 1e-20 as
    ``sample_mesh_surface`` clamps them."""
    import torch

    from ..human.smplx_model import make_synthetic_model

    body = make_synthetic_model(num_vertices=10_475, num_joints=55,
                                num_betas=10, num_expr=10, device=dev)
    tri = body.v_template[torch.as_tensor(body.faces, device=dev).long()]
    e = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    return torch.clamp(0.5 * torch.linalg.norm(e, dim=-1), min=1e-20)


def main_faces(dev, calls: int = 300, n: int = SIGMA_POINTS) -> dict:
    """``--faces``: each draw ``calls`` times from one generator state."""
    import torch

    from ..ops.mesh import sample_faces

    area = body_areas(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = gen.get_state()
    line = dict(faces=int(area.numel()), draws=n, calls=calls)
    for name, draw in (
            ("torch.multinomial", lambda: torch.multinomial(
                area, n, replacement=True, generator=gen)),
            ("sample_faces", lambda: sample_faces(area, n, gen))):
        runs = []
        for _ in range(calls):
            gen.set_state(state)
            runs.append(draw())
        parted = [int((r != runs[0]).sum()) for r in runs[1:]]
        line[name] = dict(calls_parted=sum(1 for x in parted if x),
                          most_faces_parted=max(parted))
    print(json.dumps(line), flush=True)
    return line


def faces_replays(dev, n: int) -> list:
    """``--full``'s plain mode with the step's face draw by
    ``torch.multinomial`` (the draw before ``sample_faces``), then by
    ``sample_faces``: a JSON line each."""
    import torch

    from ..ops import mesh

    inputs = full_inputs(dev)
    fixed = mesh.sample_faces
    lines = []
    for name, draw in (
            ("torch.multinomial", lambda area, k, generator:
             torch.multinomial(area, k, replacement=True,
                               generator=generator)),
            ("sample_faces", fixed)):
        mesh.sample_faces = draw
        try:
            lines.append(dict(replay_full(dev, inputs, n, "plain"),
                              face_draw=name))
        finally:
            mesh.sample_faces = fixed
        print(json.dumps(lines[-1]), flush=True)
    return lines


def panel_sum_atomic(d_panels, tile_lists, n_rows: int, CV: int):
    """B1's panel sum by ``index_add_``, as the port took it before
    ``panel_grads``: on the card it adds with atomics, in no fixed order.
    The yardstick of ``--panel-sum``; no trainer path calls it."""
    import torch

    B = tile_lists.shape[0]
    dev = d_panels.device
    rows = (tile_lists.long()
            + n_rows * torch.arange(B, device=dev)[:, None, None])
    d_rows = torch.zeros((B * n_rows, 16), dtype=torch.float32, device=dev)
    d_rows.index_add_(0, rows.reshape(-1), d_panels.reshape(-1, 16))
    d_rows = d_rows.reshape(B, n_rows, 16)[:, :-1]
    return (d_rows[..., 0:2], d_rows[..., 2:5], d_rows[..., 5],
            d_rows[..., 8:8 + CV])


def stage2_full(dev):
    """The train phase's full-width stage-2 step of ``chip_smoke.py``: its
    avatar (200k slots, 180k points, the SMPL-X-sized body with its hands
    part, a 256^2 x 32 triplane), the SD1.5-size bf16 guidance, a 512^2
    camera, random 77-token embeddings and pose canvas, all from seed 0.
    Returns (model, train state, run) where ``run(model, tstate, gen)``
    takes one step at timestep 500."""
    import torch

    from .. import tests_support
    from ..configs import RenderConfig
    from ..data.camera import make_camera_batch
    from ..nerf.encoder import TriplaneConfig
    from ..training.gs_trainer import (
        init_avatar_train_state,
        make_avatar_sds_step,
    )
    from ..training.optim import build_avatar_optimizer

    setup = tests_support.tiny_avatar_setup(
        capacity=200_000, n_points=180_000, num_vertices=10_475,
        num_joints=55, num_betas=10, num_expr=10, seed=0,
        mesh_part="hands", part_triangles=1000, n_per_triangle=6,
        enc_cfg=TriplaneConfig(resolution=256, feature_dim=32),
        mlp_hidden=64, mlp_layers=3, deform_depth=4, deform_width=64,
        prune_dists_close_to_mesh=0.01, device=dev)
    sd, gp = tests_support.sd15_guidance(0, device=dev)
    dt = gp.unet.conv_in.weight.dtype
    cam = make_camera_batch([2.5], [30.0], [85.0], [50.0], FULL, FULL,
                            at_vector=((0.0, 0.7, 0.0),), device=dev)
    host = torch.Generator().manual_seed(0)
    txt = torch.randn((1, 77, 768), generator=host).to(dev, dt)
    unc = torch.randn((1, 77, 768), generator=host).to(dev, dt)
    cond = torch.rand((1, FULL, FULL, 3), generator=host).to(dev, dt)
    tstate = init_avatar_train_state(
        setup.state, build_avatar_optimizer(RenderConfig(), MAX_STEPS),
        setup.model)

    def run(model, tstate, gen):
        step = make_avatar_sds_step(model, sd, FULL, FULL, device=dev,
                                    tile_size=32, capacity=1024, chunk=128,
                                    max_tiles_per_gaussian=16)
        return step(tstate, gp, setup.observed, cam.extrinsic[0],
                    cam.intrinsics[0], cam.tanfov[0],
                    torch.zeros((FULL, FULL, 3), device=dev), txt, unc,
                    torch.tensor([500], device=dev), cond_image=cond,
                    generator=gen)

    return setup.model, tstate, run


def main_panel_sum(dev) -> dict:
    """``--panel-sum``: the JSON line's fields."""
    import torch

    from ..ops import blend_train as BT
    from ..training.gs_trainer import _leaves

    model, tstate, run = stage2_full(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {"atomic": panel_sum_atomic, "fixed": BT.panel_grads}
    seen = {}
    bwd = BT.blend_train_bwd

    def keep_bwd(*a, **k):
        seen["bwd"] = (a, k)
        return bwd(*a, **k)

    # the wrapper counts its own launches under the module's name
    keep_bwd.launches = 0

    def keep_sum(*a):
        seen["sum"] = a
        return sums["fixed"](*a)

    base = copy.deepcopy((model, tstate))
    BT.blend_train_bwd, BT.panel_grads = keep_bwd, keep_sum
    try:
        tstate, _ = run(model, tstate, gen)
    finally:
        BT.blend_train_bwd, BT.panel_grads = bwd, sums["fixed"]
    a, k = seen["bwd"]
    d_panels, tile_lists, n_rows, CV = seen["sum"]

    def ms(fn, reps=50):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        fn()
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    timed = []
    for name in ("atomic", "fixed", "fixed", "atomic"):
        fn = sums[name]
        timed.append(dict(
            sum=name, sum_ms=ms(lambda: fn(d_panels, tile_lists, n_rows,
                                           CV)),
            b1_backward_ms=ms(lambda: fn(bwd(*a, **k), tile_lists, n_rows,
                                         CV))))
    line = dict(entries=int(tile_lists.numel()),
                live_entries=int((tile_lists != n_rows - 1).sum()),
                rows=n_rows, timed=timed)
    firsts = {}
    for name, fn in sums.items():
        outs = [torch.cat([g.reshape(g.shape[0], g.shape[1], -1)
                           for g in fn(d_panels, tile_lists, n_rows, CV)],
                          -1) for _ in range(20)]
        firsts[name] = outs[0]
        line[f"{name}_calls_parted"] = sum(
            1 for o in outs[1:] if not torch.equal(o, outs[0]))
    line["max_abs_diff"] = float((firsts["atomic"] - firsts["fixed"])
                                 .abs().max())
    line["max_abs"] = float(firsts["fixed"].abs().max())
    g0 = gen.get_state()
    for name, fn in sums.items():
        BT.panel_grads = fn
        try:
            snaps = []
            for _ in range(5):
                m, ts = copy.deepcopy(base)
                gen.set_state(g0)
                ts, metrics = run(m, ts, gen)
                leaves = _leaves(ts.avatar, m)
                snaps.append(([float(v) for v in metrics.values()],
                              [t.detach().clone() for t in leaves],
                              [torch.zeros(0) if t.grad is None
                               else t.grad.detach().clone() for t in leaves]))
        finally:
            BT.panel_grads = sums["fixed"]
        parts = [dict(metrics_equal=s_[0] == snaps[0][0],
                      values=differ(s_[1], snaps[0][1]),
                      grads=differ(s_[2], snaps[0][2])) for s_ in snaps[1:]]
        line[f"{name}_step_replays"] = dict(
            replays=len(parts), parted=sum(
                1 for x in parts if not x["metrics_equal"]
                or x["values"]["differing"] or x["grads"]["differing"]),
            worst=max((x["grads"] for x in parts),
                      key=lambda g: g["differing"]))
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", choices=["on", "off"], default="on")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--replays", type=int, default=30)
    ap.add_argument("--modes", default="plain,poison,trace")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--faces", action="store_true")
    ap.add_argument("--panel-sum", action="store_true")
    args = ap.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads it when CUDA starts
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    if args.full:
        return main_full(args)
    if args.faces or args.panel_sum:
        from .. import _device

        dev = _device.resolve_device("cuda")
        if args.panel_sum:
            return main_panel_sum(dev)
        return [main_faces(dev), *faces_replays(dev, args.replays)]

    import numpy as np
    import torch

    from .. import _device
    from ..guidance import layers as TL

    dev = _device.resolve_device("cuda")
    inputs = stage1_inputs(dev)
    lines = []
    setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = args.flash
    try:
        for mode in ("default", "deterministic", "deterministic_algorithms"):
            # every entry point sets cuDNN's flag through resolve_device
            _device.CUDNN_DETERMINISTIC = mode == "deterministic"
            torch.use_deterministic_algorithms(
                mode == "deterministic_algorithms", warn_only=True)
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                (m1, g1, p1), (m2, g2, p2) = (
                    stage1_step(dev, *inputs) for _ in range(2))
            lines.append(dict(
                cudnn=mode, flash=args.flash, metrics_equal=m1 == m2,
                grads=differ(g1, g2), params=differ(p1, p2),
                nondeterministic_warnings=sorted(
                    {str(w.message)[:120] for w in seen
                     if "deterministic" in str(w.message)})))
            print(json.dumps(lines[-1]), flush=True)
    finally:
        TL.FLASH_ATTENTION = setting
        torch.use_deterministic_algorithms(False)
        _device.CUDNN_DETERMINISTIC = True
        _device.resolve_device(dev)
    (s1, c1), (s2, c2) = export_twice(dev)
    lines.append(dict(export=400, stats=s1, stats_equal=s1 == s2,
                      points_equal=bool(np.array_equal(c1.points, c2.points)),
                      colors_equal=bool(np.array_equal(c1.colors,
                                                       c2.colors))))
    print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()

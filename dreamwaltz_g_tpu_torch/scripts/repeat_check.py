"""Does stage 1 repeat to the bit on the card?

Runs one stage-1 SDS step of a tiny NeRF (a 16^2 x 8 triplane, a 16^3
grid, 64^2 rays in checkpointed chunks of 1,000, sigma guidance, volume
sparsity, the background MLP) with the tiny float32 guidance and its
ControlNet twice from copies of the same field, grid and draws, under each
cuDNN setting: ``default`` (cuDNN free to pick any convolution algorithm:
``_device.CUDNN_DETERMINISTIC`` off), ``deterministic``
(``torch.backends.cudnn.deterministic``, what ``resolve_device`` sets by
default) and ``deterministic_algorithms``
(``torch.use_deterministic_algorithms(True, warn_only=True)``; the
warnings it raised name the other nondeterministic ops). Then
``nerf/export.py:export_point_cloud`` of one field at 400^3, twice. Prints
one JSON line a setting and one for the export: the elements of the
gradients and updated weights that differ and their largest difference.

    python -m dreamwaltz_g_tpu_torch.scripts.repeat_check [--flash on|off]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import warnings

S, CHUNK, STEPS = 64, 1000, 16


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


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", choices=["on", "off"], default="on")
    args = ap.parse_args(argv)

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

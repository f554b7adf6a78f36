"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  -- CUDA present (else exit 2), card name and power limit;
2. build   -- compile every CUDA kernel of the port from ``csrc/``;
3. avatar  -- build the full-width avatar on the card (``init_avatar_state``);
4. kernel  -- ``blend_sorted`` against ``blend_sorted_reference`` on the same
              card inputs: one projected 1024^2 frame of the avatar, and a
              200k-Gaussian random scene; fails past the stated tolerance;
5. small   -- the tiny avatar rendered on the CPU (plain blend) and on the
              card (kernel) agree;
6. main    -- launch counts set to 0, 8 animated 1024^2 frames rendered
              through ``make_avatar_render_frames``, counts read: every
              kernel of the path must have launched; outputs checked;
7. times   -- steady-state ms/frame, a per-stage breakdown of one frame, and
              each kernel's time beside its plain version and its bound.

Then the kernels line, the ``nvidia-smi`` name/power-limit line, and the
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. The avatar is the synthetic
SMPL-X-sized body (10,475 vertices, 55 joints) with random weights from a
seed: 180k points in a 200k-slot buffer, a 256^2 x 32 triplane, the
trainer's decode heads, 6,000 hand-bound mesh Gaussians.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

H = W = 1024
RASTER = dict(tile_size=32, capacity=1024, chunk=128, max_tiles_per_gaussian=16)
N_FRAMES = 8
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations per (pixel, entry) pair of the blend: every pair
# evaluates q and w (2 sub, 6 mul + 2 add for q, 2 mul + 1 exp for w) = 13;
# a pair that passes min_alpha adds the clip, T*w, 8 multiply-adds and the
# transmittance update = 20 more
OPS_PER_PAIR = 13
OPS_PER_BLENDED_PAIR = 20
# kernel vs plain version on the same card inputs: a pixel the kernel stops
# early loses at most exp(-9.2) |value| (1e-4 |value|); q and w round alike
# in both, so a min_alpha decision flips only where exp differs (<= 1/255
# of one entry). rgb/alpha absolute, depth relative to the largest depth.
TOL_RGB_ALPHA = 5e-3
TOL_DEPTH_REL = 5e-3
TOL_SMALL = 5e-3   # tiny avatar, CPU plain path vs card kernel path


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def to_device(x, dev):
    """Move tensors and modules inside tuples, dicts and dataclasses."""
    import torch

    if torch.is_tensor(x) or isinstance(x, torch.nn.Module):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_device(v, dev) for v in x])
    if isinstance(x, tuple):
        return tuple(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def motion(smpl, n_frames, dev):
    """A short motion: every body joint swings on its own phase."""
    import torch

    from dreamwaltz_g_tpu_torch.human.smplx_model import (
        SMPLXParams,
        default_params,
    )

    base = default_params(smpl, 1)
    t = torch.arange(n_frames, device=dev, dtype=torch.float32)[:, None]
    j = torch.arange(63, device=dev, dtype=torch.float32)[None, :]
    body = 0.05 * torch.sin(0.7 * t + 0.37 * j)                 # (F, 63)
    frames = [x.expand((n_frames,) + x.shape) for x in base]
    frames = SMPLXParams(*frames)._replace(body_pose=body[:, None, :])
    return frames


def blend_inputs(g, tile_size, capacity, max_tiles):
    """The wrapper's arguments for one projected frame, as the render path
    builds them."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import rasterize as R

    s_idx, seg_start, counts, overflow = R.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, H, W, tile_size, capacity,
        max_tiles)
    N = g.colors.shape[0]
    values = torch.cat([g.colors, g.depth[:, None],
                        torch.ones((N, 1), device=g.colors.device)], -1)
    return (s_idx, seg_start, counts, g.means2d, g.conic,
            g.opacity * g.mask.to(g.opacity.dtype), values), overflow


def compare_blend(label, args):
    """Kernel vs plain version on the same inputs; returns the errors and
    the pair counts of the plain version's run."""
    import torch

    from dreamwaltz_g_tpu_torch.ops.blend import (
        blend_sorted,
        blend_sorted_reference,
    )

    kw = dict(tile_size=RASTER["tile_size"], chunk=RASTER["chunk"],
              capacity=RASTER["capacity"])
    out = blend_sorted(*args, H, W, **kw)
    stats = {}
    ref = blend_sorted_reference(*args, H, W, stats=stats, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: kernel output not finite")
    err = (out - ref).abs()
    e_rgb = float(err[..., :3].max())
    e_alpha = float(err[..., 4].max())
    e_depth = float(err[..., 3].max())
    dmax = float(args[6][:, 3].abs().max())
    emit(phase="kernel", input=label, kernel="blend_sorted",
         max_abs_err_rgb=e_rgb, max_abs_err_alpha=e_alpha,
         max_abs_err_depth=e_depth, max_depth=dmax,
         tol_rgb_alpha=TOL_RGB_ALPHA, tol_depth=TOL_DEPTH_REL * dmax,
         pixels_over_1e4=int((err[..., [0, 1, 2, 4]].amax(-1) > 1e-4).sum()),
         pairs=stats["pairs"], blended_pairs=stats["blended"],
         entries=int(args[2].sum()), coverage=float((ref[..., 4] > 0.01)
                                                    .float().mean()))
    if max(e_rgb, e_alpha) > TOL_RGB_ALPHA or e_depth > TOL_DEPTH_REL * dmax:
        fail(f"{label}: blend_sorted disagrees with its plain version")
    return max(e_rgb, e_alpha), stats


def random_scene(dev):
    """The 200k-Gaussian scene of bench_render.py, projected at 1024^2."""
    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.utils.transforms import quat_normalize

    N = 200_000
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    means3d = t(rng.normal(size=(N, 3)) * 0.4)
    quats = quat_normalize(t(rng.normal(size=(N, 4))))
    scales = t(np.exp(rng.normal(size=(N, 3)) * 0.3) * 0.004)
    opac = t(rng.uniform(0.3, 0.95, size=(N,)))
    colors = t(rng.uniform(0, 1, size=(N, 3)))
    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, H, W, device=dev)
    return R.project_gaussians(
        means3d, R.covariance3d(quats, scales), opac, colors,
        cam.extrinsic[0], cam.intrinsics[0], H, W, tanfov=cam.tanfov[0])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # imported after the CUDA check; a checkout without the package fails here
    from dreamwaltz_g_tpu_torch import kernels, tests_support
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.nerf.encoder import TriplaneConfig
    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.ops.blend import blend_sorted, blend_sorted_reference
    from dreamwaltz_g_tpu_torch.system.avatar import animate
    from dreamwaltz_g_tpu_torch.training.gs_trainer import (
        make_avatar_render,
        make_avatar_render_frames,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = {"card": kind, "nvidia_smi": smi}
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(), **card)

    # -- build: one nvcc per kernel source, started together -------------
    t0 = time.perf_counter()
    logs = kernels.build(force=True)
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels=sorted(logs),
         ptxas=[ln.strip() for log in logs.values()
                for ln in log.splitlines() if "registers" in ln or "smem" in ln])

    # -- the full-width avatar -------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup = tests_support.tiny_avatar_setup(
        capacity=200_000, n_points=180_000, num_vertices=10_475,
        num_joints=55, num_betas=10, num_expr=10, seed=SEED,
        mesh_part="hands", part_triangles=1000, n_per_triangle=6,
        enc_cfg=TriplaneConfig(resolution=256, feature_dim=32),
        mlp_hidden=64, mlp_layers=3, deform_depth=4, deform_width=64,
        prune_dists_close_to_mesh=0.01, device=dev)
    torch.cuda.synchronize()
    model, state = setup.model, setup.state
    emit(phase="avatar", seconds=time.perf_counter() - t0,
         capacity=state.capacity, alive=int(state.alive.sum()),
         mesh_gaussians=sum(len(p.points_to_triangles)
                            for p in model.mesh_parts.values()),
         faces=int(model.smpl.faces.shape[0]),
         vertices=model.smpl.num_vertices, joints=model.smpl.num_joints)

    frames = motion(model.smpl, N_FRAMES, dev)
    cams = make_camera_batch(
        [2.5] * N_FRAMES, [360.0 * f / N_FRAMES for f in range(N_FRAMES)],
        [85.0] * N_FRAMES, [50.0] * N_FRAMES, H, W,
        at_vector=((0.0, 0.7, 0.0),), device=dev)
    bg = torch.ones((H, W, 3), device=dev)

    def project_frame(f):
        obs = type(frames)(*[x[f] for x in frames])
        gs = animate(model, state, obs)
        return R.project_gaussians(
            gs.positions, R.covariance3d(gs.quats, gs.scales), gs.opacities,
            gs.colors, cams.extrinsic[f], cams.intrinsics[f], H, W,
            tanfov=cams.tanfov[f], alive=gs.alive)

    # -- kernel against its plain version at full size --------------------
    with torch.no_grad():
        avatar_args, _ = blend_inputs(project_frame(0), RASTER["tile_size"],
                                      RASTER["capacity"],
                                      RASTER["max_tiles_per_gaussian"])
        err_avatar, avatar_stats = compare_blend("avatar_frame0", avatar_args)
        scene_args, _ = blend_inputs(random_scene(dev), RASTER["tile_size"],
                                     RASTER["capacity"],
                                     RASTER["max_tiles_per_gaussian"])
        err_scene, _ = compare_blend("random_200k_D16", scene_args)

    # -- the tiny avatar: CPU plain path vs card kernel path --------------
    tiny = tests_support.tiny_avatar_setup(device="cpu")
    tcam = make_camera_batch(2.0, 20.0, 90.0, 50.0, 64, 64,
                             at_vector=((0.0, 0.7, 0.0),), device="cpu")
    rk = dict(tile_size=16, capacity=128, chunk=32)
    args = (tiny.observed, tcam.extrinsic[0], tcam.intrinsics[0],
            tcam.tanfov[0], torch.full((64, 64, 3), 0.3))
    cpu_out = make_avatar_render(tiny.model, 64, 64, device="cpu", **rk)(
        tiny.state, *args)
    tiny_model = to_device(tiny.model, dev)
    gpu_out = make_avatar_render(tiny_model, 64, 64, device=dev, **rk)(
        to_device(tiny.state, dev), *to_device(args, dev))
    small_err = max(float((c - g.cpu()).abs().max())
                    for c, g in zip(cpu_out, gpu_out))
    emit(phase="small", max_abs_err=small_err, tol=TOL_SMALL,
         coverage=float((cpu_out[1] > 0.01).float().mean()))
    if small_err > TOL_SMALL or float(cpu_out[1].max()) <= 0.0:
        fail("tiny avatar: card render disagrees with the CPU render")

    # -- the main path: counts to 0, 8 frames, counts read ----------------
    render_frames = make_avatar_render_frames(model, H, W, device=dev,
                                              **RASTER)
    kernel_fns = {"blend_sorted": blend_sorted}
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs, alphas, depths = render_frames(state, frames, cams.extrinsic,
                                         cams.intrinsics, cams.tanfov, bg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    for name, n in launches.items():
        if n != N_FRAMES:
            fail(f"{name} launched {n} times for {N_FRAMES} frames")
    if imgs.shape != (N_FRAMES, H, W, 3) or alphas.shape != (N_FRAMES, H, W):
        fail(f"unexpected shapes {tuple(imgs.shape)} {tuple(alphas.shape)}")
    if not all(bool(torch.isfinite(x).all()) for x in (imgs, alphas, depths)):
        fail("non-finite render output")
    a_min, a_max = float(alphas.min()), float(alphas.max())
    if a_min < 0.0 or a_max > 1.0 + 1e-6:
        fail(f"alpha outside [0, 1]: [{a_min}, {a_max}]")
    coverage = [float((a > 0.01).float().mean()) for a in alphas]
    if min(coverage) <= 0.0:
        fail("a frame has no coverage")

    # tile overflow per frame (binning only: no blend launch)
    with torch.no_grad():
        overflow = []
        for f in range(N_FRAMES):
            g = project_frame(f)
            overflow.append(float(R.bin_gaussians_sorted(
                g.means2d, g.radius, g.depth, g.mask, H, W,
                RASTER["tile_size"], RASTER["capacity"],
                RASTER["max_tiles_per_gaussian"])[3]))
    emit(phase="main", frames=N_FRAMES, resolution=[H, W],
         first_run_s=first_s, launches=launches, alpha_range=[a_min, a_max],
         coverage=coverage, tile_overflow=overflow,
         mean_rgb=float(imgs.mean()))

    # -- times ------------------------------------------------------------
    def run_frames():
        render_frames(state, frames, cams.extrinsic, cams.intrinsics,
                      cams.tanfov, bg)

    frame_ms = [cuda_ms(run_frames, 1) / N_FRAMES for _ in range(3)]
    with torch.no_grad():
        obs0 = type(frames)(*[x[0] for x in frames])
        gs0 = animate(model, state, obs0)
        g0 = project_frame(0)
        stage_ms = {
            "animate": cuda_ms(lambda: animate(model, state, obs0), 5),
            "project": cuda_ms(lambda: R.project_gaussians(
                gs0.positions, R.covariance3d(gs0.quats, gs0.scales),
                gs0.opacities, gs0.colors, cams.extrinsic[0],
                cams.intrinsics[0], H, W, tanfov=cams.tanfov[0],
                alive=gs0.alive), 5),
            "bin": cuda_ms(lambda: R.bin_gaussians_sorted(
                g0.means2d, g0.radius, g0.depth, g0.mask, H, W,
                RASTER["tile_size"], RASTER["capacity"],
                RASTER["max_tiles_per_gaussian"]), 5),
        }
        bkw = dict(tile_size=RASTER["tile_size"], chunk=RASTER["chunk"],
                   capacity=RASTER["capacity"])
        kernel_ms = cuda_ms(lambda: blend_sorted(*avatar_args, H, W, **bkw), 20)
        plain_ms = cuda_ms(
            lambda: blend_sorted_reference(*avatar_args, H, W, **bkw), 3)
        scene_kernel_ms = cuda_ms(
            lambda: blend_sorted(*scene_args, H, W, **bkw), 20)
    stage_ms["blend"] = kernel_ms

    # bound of blend_sorted on the avatar frame: each input read once, the
    # output written once; the operations this frame's pairs need
    s_idx, seg_start, counts, means2d, conic, op, values = avatar_args
    n = means2d.shape[0]
    bytes_moved = (4 * int(counts.sum()) + 4 * 2 * seg_start.numel()
                   + 4 * n * (2 + 3 + 1 + values.shape[1])
                   + 4 * H * W * values.shape[1])
    ops = (OPS_PER_PAIR * avatar_stats["pairs"]
           + OPS_PER_BLENDED_PAIR * avatar_stats["blended"])
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit(phase="times", ms_per_frame=frame_ms,
         fps=1e3 / sorted(frame_ms)[1], stage_ms=stage_ms,
         blend_kernel_ms=kernel_ms, blend_plain_ms=plain_ms,
         blend_kernel_ms_random_200k=scene_kernel_ms,
         blend_bytes=bytes_moved, blend_ops=ops, blend_bytes_ms=bytes_ms,
         blend_ops_ms=ops_ms, blend_bound_ms=bound_ms, **card)

    # -- device busy share and kernel time by name over one 8-frame render --
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.device_time_total)[:10]
    # single stream, so kernel times do not overlap; the profiler's own host
    # overhead lengthens wall_ms, so the busy share is a lower bound
    emit(phase="profile", frames=N_FRAMES, wall_ms=wall_ms,
         device_busy_ms=busy_ms if on_card else None,
         device_busy_share=busy_ms / wall_ms if on_card else None,
         kernel_launches=sum(e.count for e in on_card),
         top_kernels=[[e.key[:80], e.device_time_total / 1e3, e.count]
                      for e in top], **card)

    print(json.dumps({"kernels": [{
        "name": "blend_sorted",
        "route": "cuda",
        "source": "dreamwaltz_g_tpu_torch/csrc/blend_sorted.cu",
        "replaces": "dreamwaltz_g_tpu/ops/pallas_blend.py:326",
        "launches": launches["blend_sorted"],
        "max_abs_err": max(err_avatar, err_scene),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device       -- CUDA present (else exit 2), card name and power limit;
2. build        -- compile every CUDA kernel of the port from ``csrc/``, one
                   ``nvcc`` per source, all started together;
3. avatar       -- build the full-width avatar on the card;
4. kernel       -- ``blend_sorted`` (B2) against its plain version on the
                   same card inputs: one projected 1024^2 frame of the avatar
                   and a 200k-Gaussian random scene;
5. small        -- the tiny avatar rendered on the CPU (plain blend) and on
                   the card (kernel) agree;
6. main         -- the render path: launch counts set to 0, 8 animated
                   1024^2 frames through ``make_avatar_render_frames``,
                   counts read (``blend_sorted`` once a frame, no other
                   kernel);
7. times        -- render ms/frame, a per-stage breakdown, B2's time beside
                   its plain version and its bound;
8. profile      -- device busy share and top kernels over one 8-frame render;
9. kernel_train -- the table blends at 512^2 on one projected avatar frame
                   and on the random scene: B1 forward and backward and B3
                   (through ``_blend_dispatch(mode="eval")``) against their
                   plain versions;
10. small_train -- one SDS step of the tiny avatar, with its mesh part,
                   and the tiny guidance with its ControlNet: on the CPU
                   (plain versions, under each stop rule) and on the card
                   (kernels), from the same state and noise;
11. train       -- the training path: the full avatar, the SD1.5-size bf16
                   UNet + ControlNet + VAE, counts set to 0, 3 warm-up and
                   10 steps through ``make_avatar_sds_step``, counts read
                   (``blend_train_fwd`` and ``blend_train_bwd`` once a step,
                   no other blend), outputs and parameter updates checked;
12. train_times -- SDS it/s, each table kernel's time beside its plain
                   version and its bound;
13. train_profile -- device busy share, the step's device and host ms by
                   stage (its own ``record_function`` ranges) and top
                   kernels over one profiled SDS step.

Then the kernels line, the ``nvidia-smi`` name/power-limit line, and the
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. The avatar is the synthetic
SMPL-X-sized body (10,475 vertices, 55 joints) with random weights from a
seed: 180k points in a 200k-slot buffer, a 256^2 x 32 triplane, the
trainer's decode heads, 6,000 hand-bound mesh Gaussians. The guidance
weights are random from the seed too; attention runs the einsum path
(``FLASH_ATTENTION = "off"``).
"""
from __future__ import annotations

import dataclasses
import json
import math
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

# -- the training path: the trainer's stage-2 step at 512^2 (train_h)
TRAIN_H = TRAIN_W = 512
TRAIN_RASTER = dict(tile_size=32, capacity=1024, chunk=128,
                    max_tiles_per_gaussian=16)
TRAIN_STEPS, TRAIN_WARMUP = 10, 3
MAX_STEPS = 5000       # build_avatar_optimizer's schedule length
TIMESTEP = 500
# float32 operations per (pixel, entry) pair of the table backward, counted
# from csrc/blend_train.cu: a reached pair recomputes q and w (13); a
# blended pair adds the clip, 1 - w, the T recovery, contrib, G (8 mul-add),
# dw (4), dq (2), dq/dx and dq/dy (8), the five attribute terms (11), d op
# (3), the 8 value terms and the suffix update (2) = 58, plus its share of
# the 14 per-entry sums over the tile's pixels = 72
OPS_BWD_PER_BLENDED_PAIR = 72
# table kernels vs plain versions on the same card inputs. Outputs: as for
# B2, against the plain version with the TPU's tile stop and with the
# kernels' per-pixel stop. Gradients after the scatter, against the plain
# backward with the kernels' per-pixel stop (stop="pixel"): |err| <= 2e-3
# |ref| + 2e-4 max|ref|, the JAX package's envelope for its own train
# kernel (float32 T products and their back-to-front recovery against the
# log-space prefix). Against the plain backward with the TPU's tile stop:
# that envelope on top of the stop rule's own, per Gaussian
# (blend_train.blend_tiles_train_stop_envelope: what the pairs past each
# pixel's stop add, <= 1e-4 |G| / (1 - w) on an earlier pair's dw)
GRAD_RTOL = 2e-3
GRAD_ATOL_OF_MAX = 2e-4
# tiny SDS step of the tiny avatar with its mesh part, whose opaque
# Gaussians take pixels below T = 1e-4 (checked), so the stop acts. Card
# (kernels, cuDNN convolutions without TF32) vs the CPU step with the
# kernels' per-pixel stop: the loss within 1e-3 relative; gradients and the
# accumulated screen-space gradient as above; visibility counts and radii
# may flip on at most 0.5% of the slots (a radius's ceil at a rounding
# edge). The step's blend gradient, on the card's own inputs, is held to
# both plain backwards as above. Card vs the CPU step with the TPU's tile
# stop: the loss within 1e-3 relative (the forward parts by <= 1e-4 |value|
# on the stopped pixels)
TOL_STEP_LOSS = 1e-3
TOL_STATS_FLIPS = 5e-3


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


def random_scene(dev, height=H, width=W):
    """The 200k-Gaussian scene of bench_render.py, projected at
    height x width (1024^2 by default)."""
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
    cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, height, width, device=dev)
    return R.project_gaussians(
        means3d, R.covariance3d(quats, scales), opac, colors,
        cam.extrinsic[0], cam.intrinsics[0], height, width,
        tanfov=cam.tanfov[0])


def panel_args(g, H, W, raster):
    """The table kernels' operands for one projected frame, as the training
    path builds them: (tile_lists, tile_counts, packed) with a leading view
    dimension, the values, and the overflow."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.ops.blend import pack_rows

    tl, tc, overflow = R.bin_gaussians(
        g.means2d, g.radius, g.depth, g.mask, H, W, raster["tile_size"],
        raster["capacity"], raster["max_tiles_per_gaussian"])
    N = g.colors.shape[0]
    values = torch.cat([g.colors, g.depth[:, None],
                        torch.ones((N, 1), device=g.colors.device)], -1)
    packed = pack_rows(g.means2d, g.conic, g.opacity * g.mask, values)
    return (tl[None].contiguous(), tc[None].contiguous(),
            packed[None].contiguous()), values, float(overflow)


def grad_error(got, ref, env=None, peak=None):
    """Max abs error, max error relative to each gradient's largest entry,
    and the worst excess over the stated envelope (<= 0 passes):
    |err| <= env + GRAD_RTOL (|ref| + env) + GRAD_ATOL_OF_MAX peak, with
    ``env`` the stop rules' envelope (none: 0) and ``peak`` the largest
    entry of the gradient the float32 envelope is taken from (none: ref's)."""
    e_abs = e_rel = excess = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        m = float(b.abs().max())
        e = 0.0 if env is None else env[i]
        err = (a - b).abs()
        e_abs = max(e_abs, float(err.max()))
        e_rel = max(e_rel, float(err.max()) / max(m, 1e-30))
        bound = e + GRAD_RTOL * (b.abs() + e) \
            + GRAD_ATOL_OF_MAX * (m if peak is None else peak[i])
        excess = max(excess, float((err - bound).max()))
    return e_abs, e_rel, excess


def hold_bwd(label, tl, tc, packed, d_panel, g, tile_size, tiles_x, **kw):
    """A backward kernel's gradient panel against the plain backward on the
    same inputs, per Gaussian after the scatter: with the kernels' own
    per-pixel stop within the float32 envelope, and with the TPU's tile
    stop within that plus the stop rules' envelope. Returns the errors;
    ``check_bwd`` fails past either."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import blend_train as BT

    n_rows = packed.shape[1]
    got = BT.panel_grads(d_panel, tl, n_rows, 5)
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"{label}: blend_train_bwd gradients not finite")
    refs = {}
    for stop in ("pixel", "tile"):
        _, ckpt = BT.blend_tiles_train_reference_fwd(
            tl, tc, packed, tile_size, tiles_x, stop=stop, **kw)
        refs[stop] = BT.panel_grads(BT.blend_tiles_train_reference_bwd(
            tl, tc, packed, ckpt, g, tile_size, tiles_x, stop=stop, **kw),
            tl, n_rows, 5)
    env = BT.panel_grads(BT.blend_tiles_train_stop_envelope(
        tl, tc, packed, ckpt, g, tile_size, tiles_x, **kw), tl, n_rows, 5)
    px = grad_error(got, refs["pixel"])
    tile = grad_error(got, refs["tile"], env=env,
                      peak=[float(r.abs().max()) for r in refs["pixel"]])
    errs = dict(
        max_abs_err_bwd=px[0], max_err_bwd_of_max=px[1],
        bwd_excess_over_tol=px[2], max_abs_err_bwd_vs_tile_stop=tile[0],
        max_err_bwd_vs_tile_stop_of_max=tile[1],
        bwd_vs_tile_stop_excess_over_tol=tile[2],
        stop_envelope_of_max=max(
            float(e.max()) / max(float(r.abs().max()), 1e-30)
            for e, r in zip(env, refs["tile"])))
    return errs


def check_bwd(label, errs):
    if errs["bwd_excess_over_tol"] > 0:
        fail(f"{label}: blend_train_bwd disagrees with its plain version")
    if errs["bwd_vs_tile_stop_excess_over_tol"] > 0:
        fail(f"{label}: blend_train_bwd parts from the tile-stop plain "
             "backward by more than the stop rules explain")


def compare_train_blend(label, args, values, tiles_x):
    """B1 forward and backward and B3 against their plain versions on the
    same card inputs. Returns the errors and the plain version's pair
    counts."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.ops.blend import _tile, _untile

    tl, tc, packed = args
    ts, chunk = TRAIN_RASTER["tile_size"], TRAIN_RASTER["chunk"]
    kw = dict(chunk=chunk)
    out, saved = BT.blend_train_fwd(tl, tc, packed, ts, tiles_x, **kw)
    stats = {}
    ref, _ = BT.blend_tiles_train_reference_fwd(
        tl, tc, packed, ts, tiles_x, stats=stats, **kw)
    ref_px, _ = BT.blend_tiles_train_reference_fwd(
        tl, tc, packed, ts, tiles_x, stop="pixel", **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: blend_train_fwd output not finite")
    dmax = float(values[:, 3].abs().max())
    e_fwd = []
    for r in (ref, ref_px):
        err = (_untile(out[0], 5, TRAIN_H, TRAIN_W, ts)
               - _untile(r[0], 5, TRAIN_H, TRAIN_W, ts)).abs()
        e_fwd.append([float(err[..., :3].max()), float(err[..., 4].max()),
                      float(err[..., 3].max())])
    img_ref = _untile(ref[0], 5, TRAIN_H, TRAIN_W, ts)

    gen = torch.Generator(device=out.device).manual_seed(SEED)
    g_img = torch.randn((TRAIN_H, TRAIN_W, 5), generator=gen,
                        device=out.device)
    g = _tile(g_img[None], ts)
    d = BT.blend_train_bwd(tl, tc, packed, saved, g, ts, tiles_x, **kw)
    torch.cuda.synchronize()
    e_fwd = [max(a, b) for a, b in zip(*e_fwd)]
    errs_bwd = hold_bwd(label, tl, tc, packed, d, g, ts, tiles_x, **kw)

    # B3 through the dispatcher the eval table blend is reached by
    p = packed[0, :-1]
    ev = R._blend_dispatch(tl[0], p[:, 0:2], p[:, 2:5], p[:, 5],
                           values[:, :3], values[:, 3],
                           torch.ones_like(p[:, 5], dtype=torch.bool),
                           TRAIN_H, TRAIN_W, ts, chunk, tile_counts=tc[0],
                           mode="eval")
    ev_ref = _untile(BT.blend_tiles_eval_reference(tl, tc, packed, ts,
                                                   tiles_x, **kw)[0], 5,
                     TRAIN_H, TRAIN_W, ts)
    torch.cuda.synchronize()
    e_eval = float((ev - ev_ref).abs().max())
    emit(phase="kernel_train", input=label,
         max_abs_err_fwd_rgb=e_fwd[0], max_abs_err_fwd_alpha=e_fwd[1],
         max_abs_err_fwd_depth=e_fwd[2], max_depth=dmax, **errs_bwd,
         max_abs_err_eval=e_eval,
         tol_rgb_alpha=TOL_RGB_ALPHA, tol_depth=TOL_DEPTH_REL * dmax,
         grad_rtol=GRAD_RTOL, grad_atol_of_max=GRAD_ATOL_OF_MAX,
         pairs=stats["pairs"], blended_pairs=stats["blended"],
         entries=int(tc.sum()), coverage=float((img_ref[..., 4] > 0.01)
                                               .float().mean()))
    if max(e_fwd[0], e_fwd[1]) > TOL_RGB_ALPHA or \
            e_fwd[2] > TOL_DEPTH_REL * dmax:
        fail(f"{label}: blend_train_fwd disagrees with its plain version")
    check_bwd(label, errs_bwd)
    if e_eval > max(TOL_RGB_ALPHA, TOL_DEPTH_REL * dmax):
        fail(f"{label}: blend_tiles_eval disagrees with its plain version")
    return (max(e_fwd[0], e_fwd[1]), errs_bwd["max_abs_err_bwd"], e_eval,
            stats)


def table_bounds(args, stats):
    """Least times of the three table kernels on these inputs: the bytes
    each must move over HBM rate, and this frame's pair work over the
    float32 rate. Bytes: the 64-byte rows the lists reference and the
    lists' live entries, read once; the tile counts; per pixel the 32-byte
    output and 8-byte state (forward), or the state and the 32-byte
    upstream gradient (backward); and the backward's 64-byte gradient of
    each live entry, written once."""
    import torch

    tl, tc, packed = args
    B, T, _ = tl.shape
    P = TRAIN_RASTER["tile_size"] ** 2
    n_rows = packed.shape[1]
    entries = int(tc.sum())
    rows = sum(int(torch.unique(tl[b][tl[b] < n_rows - 1]).numel())
               for b in range(B))
    common = 64 * rows + 4 * entries + 4 * B * T
    fwd_ops = (OPS_PER_PAIR * stats["pairs"]
               + OPS_PER_BLENDED_PAIR * stats["blended"])
    bwd_ops = (OPS_PER_PAIR * stats["pairs"]
               + OPS_BWD_PER_BLENDED_PAIR * stats["blended"])
    out = {}
    for name, nbytes, ops in (
            ("blend_train_fwd", common + (32 + 8) * B * T * P, fwd_ops),
            ("blend_train_bwd", common + (8 + 32) * B * T * P
             + 64 * entries, bwd_ops),
            ("blend_tiles_eval", common + 32 * B * T * P, fwd_ops)):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / FP32_FLOP_PER_S * 1e3
        out[name] = dict(bytes=nbytes, ops=ops, rows=rows, entries=entries,
                         bytes_ms=b_ms, ops_ms=o_ms,
                         bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations")
    return out


def pose_canvas(H, W):
    """A 512^2 OpenPose-style condition image in [0, 1]: the frontal stick
    figure of bench.py's 18 body keypoints, limbs drawn as 4-pixel-wide
    colored segments with numpy."""
    import numpy as np

    kp = np.array(
        [[.50, .12], [.50, .25], [.42, .25], [.38, .38], [.36, .50],
         [.58, .25], [.62, .38], [.64, .50], [.45, .52], [.44, .72],
         [.44, .90], [.55, .52], [.56, .72], [.56, .90], [.48, .10],
         [.52, .10], [.45, .11], [.55, .11]], np.float32) * [W, H]
    limbs = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
             (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14),
             (14, 16), (0, 15), (15, 17)]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) + 0.5
    canvas = np.zeros((H, W, 3), np.float32)
    for i, (a, b) in enumerate(limbs):
        pa, pb = kp[a], kp[b]
        d = pb - pa
        s = np.clip(((xx - pa[0]) * d[0] + (yy - pa[1]) * d[1])
                    / max(float(d @ d), 1e-6), 0.0, 1.0)
        dist2 = (xx - pa[0] - s * d[0]) ** 2 + (yy - pa[1] - s * d[1]) ** 2
        hue = i / len(limbs)
        color = np.array([abs(np.sin(np.pi * (hue + k / 3.0)))
                          for k in range(3)], np.float32)
        canvas[dist2 <= 4.0] = color
    return canvas


def build_guidance(dev):
    """The SD1.5-size bf16 UNet + pose ControlNet + VAE with random weights
    from the seed."""
    from dreamwaltz_g_tpu_torch import tests_support

    return tests_support.sd15_guidance(SEED, device=dev)


def params_snapshot(state, model):
    """Copies of the tensors whose movement the train phase checks."""
    p = state.params
    return {"positions": p.positions.detach().clone(),
            "log_scales": p.log_scales.detach().clone(),
            "triplane": p.encoder.planes.detach().clone(),
            "color_mlp": model.color_mlp.dense_0.weight.detach().clone(),
            "sq_net": model.sq_net.head_offset.weight.detach().clone()}


def small_train(dev):
    """One tiny SDS step of the tiny avatar with its mesh part, from the
    same state, weights and noise: on the CPU with the plain versions under
    each stop rule, and on the card with the kernels. The card is held to
    the CPU step under its own per-pixel stop, its blend gradient on the
    step's own inputs to both plain backwards (``hold_bwd``), and its loss
    to the CPU step under the TPU's tile stop."""
    import torch

    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
    from dreamwaltz_g_tpu_torch.training.gs_trainer import (
        init_avatar_train_state,
        make_avatar_render,
        make_avatar_sds_step,
    )
    from dreamwaltz_g_tpu_torch.training.optim import (
        avatar_param_groups,
        build_avatar_optimizer,
    )

    S = 32
    rk = dict(tile_size=16, capacity=64, chunk=32, max_tiles_per_gaussian=16)
    gen = torch.Generator().manual_seed(SEED)
    txt = torch.randn((1, 4, 32), generator=gen)
    cond = torch.rand((1, S, S, 3), generator=gen)
    bg = torch.rand((S, S, 3), generator=gen)
    noise = torch.randn((1, S // 2, S // 2, 4), generator=gen)
    cpu = torch.device("cpu")
    plain_bwd, plain_stop = BT.blend_train_bwd, BT.PLAIN_STOP
    captured = {}

    def capture(*args, **kw):
        d_panel = plain_bwd(*args, **kw)
        captured.update(args=args, kw=kw, d_panel=d_panel)
        return d_panel

    # the wrapper counts its launches on the module attribute bound to its
    # name, which is `capture` while it stands in
    capture.launches = 0

    runs = {}
    for label, d, stop in (("cpu_tile", cpu, "tile"),
                           ("cpu_pixel", cpu, "pixel"), ("card", dev, None)):
        tiny = tests_support.tiny_avatar_setup(device="cpu",
                                               mesh_part="hands")
        sd, gp = tests_support.tiny_guidance(SEED, with_controlnet=True,
                                             latent_size=S // 2,
                                             device="cpu")
        model, state = tiny.model, tiny.state
        if d.type == "cuda":
            model, state = to_device(model, d), to_device(state, d)
            gp = to_device(gp, d)
        cam = make_camera_batch(2.0, 20.0, 90.0, 50.0, S, S,
                                at_vector=((0.0, 0.7, 0.0),), device=d)
        if label == "cpu_tile":
            alpha = make_avatar_render(model, S, S, device=d, **rk)(
                state, tiny.observed, cam.extrinsic[0], cam.intrinsics[0],
                cam.tanfov[0], bg)[1]
            if not float(alpha.max()) > 1.0 - 1e-4:
                fail(f"tiny SDS step: alpha max {float(alpha.max())}: no "
                     "pixel reaches T = 1e-4, so the stop rules go untested")
        tx = build_avatar_optimizer(RenderConfig(), MAX_STEPS)
        ts = init_avatar_train_state(state, tx, model)
        step = make_avatar_sds_step(model, sd, S, S, device=d, **rk)
        # the plain versions follow `stop`; the card run takes the kernels,
        # and sets their rule too so that a CPU rehearsal of this script
        # stands in for them
        BT.PLAIN_STOP = stop or "pixel"
        if label == "card":
            BT.blend_train_bwd = capture
        new, metrics = step(
            ts, gp, to_device(tiny.observed, d), cam.extrinsic[0],
            cam.intrinsics[0], cam.tanfov[0], bg.to(d), txt.to(d),
            torch.zeros_like(txt).to(d), torch.tensor([TIMESTEP], device=d),
            noise=noise.to(d), cond_image=cond.to(d))
        BT.blend_train_bwd, BT.PLAIN_STOP = plain_bwd, plain_stop
        grads = {k: [t.grad.detach().cpu() if t.grad is not None
                     else torch.zeros(t.shape) for t in ts_]
                 for k, ts_ in avatar_param_groups(state.params,
                                                  model).items()}
        runs[label] = (float(metrics["loss"]), grads,
                       to_device(new.avatar, cpu))
    (l_cpu, g_cpu, a_cpu), (l_gpu, g_gpu, a_gpu) = (runs["cpu_pixel"],
                                                    runs["card"])
    l_tile, g_tile, _ = runs["cpu_tile"]
    # every Gaussian starts isotropic, so the quaternions' gradient is zero
    # in exact arithmetic: float32 noise on every side, held only to being
    # far below the positions' gradient
    scale = float(g_cpu["pos"][0].abs().max())
    quat_noise = max(float(g.pop("quat")[0].abs().max())
                     for g in (g_cpu, g_gpu, g_tile))
    e_abs, e_rel, excess = grad_error(
        [t for ts_ in g_gpu.values() for t in ts_],
        [t for ts_ in g_cpu.values() for t in ts_])
    acc_abs, _, acc_excess = grad_error([a_gpu.grad_accum],
                                        [a_cpu.grad_accum])
    flips = max(float((a_gpu.grad_denom != a_cpu.grad_denom).float().mean()),
                float((a_gpu.max_radii != a_cpu.max_radii).float().mean()))
    loss_rel = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-30)
    loss_rel_tile = abs(l_gpu - l_tile) / max(abs(l_tile), 1e-30)
    tl, tc, packed, _, g_out, tile_size, tiles_x = captured["args"]
    blend = hold_bwd("tiny SDS step", tl, tc, packed, captured["d_panel"],
                     g_out, tile_size, tiles_x, **captured["kw"])
    emit(phase="small_train", mesh_part="hands", loss_cpu=l_cpu,
         loss_card=l_gpu, loss_cpu_tile_stop=l_tile, loss_rel_err=loss_rel,
         loss_rel_err_vs_tile_stop=loss_rel_tile, grad_max_abs_err=e_abs,
         grad_max_err_of_max=e_rel, grad_excess_over_tol=excess,
         grad_accum_max_abs_err=acc_abs, stats_flip_share=flips,
         quat_grad_noise_of_pos=quat_noise / max(scale, 1e-30),
         grad_err_of_max_by_group={k: grad_error(g_gpu[k], g_cpu[k])[1]
                                   for k in g_cpu},
         grad_err_of_max_vs_tile_stop_by_group={
             k: grad_error(g_gpu[k], g_tile[k])[1] for k in g_tile},
         blend=blend, grad_denom_sum=float(a_cpu.grad_denom.sum()),
         tol_loss=TOL_STEP_LOSS, tol_stats_flips=TOL_STATS_FLIPS)
    check_bwd("tiny SDS step", blend)
    if loss_rel > TOL_STEP_LOSS or loss_rel_tile > TOL_STEP_LOSS \
            or excess > 0 or acc_excess > 0 or flips > TOL_STATS_FLIPS \
            or float(a_cpu.grad_denom.sum()) <= 0 \
            or quat_noise > 1e-6 * scale:
        fail("tiny SDS step: the card disagrees with the CPU")


# record_function ranges of make_avatar_sds_step and its callees -> stage
STAGE_RANGES = (("sds_step.render", "animate_project"),
                ("rasterize.bin", "bin"),
                ("rasterize.blend", "blend_fwd_b1"),
                ("sds_step.guidance", "sds_loss"),
                ("sds.encode_images", "vae_encode"),
                ("sds.latent_gradients", "controlnet_unet_cfg"),
                ("sds_step.backward", "backward"),
                ("sds_step.optimizer_stats", "optimizer_stats"))


def stage_times(trace_path):
    """Per-stage device and host ms of one profiled SDS step, from the
    profiler's Chrome trace. Each kernel, copy or fill on the card is
    charged to the innermost of the step's own ``record_function`` ranges
    whose host interval holds the runtime call that launched it (matched by
    correlation id). So kernels that autograd's device thread launches land
    in the backward's range, and a nested range's kernels leave its
    parent's: ``animate_project`` is the render range less ``bin`` and
    ``blend_fwd_b1``, ``sds_loss`` the guidance range less its two stages.
    Host ms is each range's whole span, nested ranges and the profiler's
    overhead included. Returns (device ms by stage, host ms by range, B1
    backward kernel ms)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = dict(STAGE_RANGES)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in names]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = {stage: 0.0 for _, stage in STAGE_RANGES}
    device["outside_ranges"] = 0.0
    b1_bwd = 0.0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms = e.get("dur", 0.0) / 1e3
        ts = launched.get(e.get("args", {}).get("correlation"))
        inner = None
        for r in ranges if ts is not None else ():
            if r["ts"] <= ts <= r["ts"] + r["dur"] and (
                    inner is None or r["dur"] < inner["dur"]):
                inner = r
        device[names[inner["name"]] if inner else "outside_ranges"] += ms
        if "blend_bwd_kernel" in e.get("name", ""):
            b1_bwd += ms
    host = {r["name"]: r["dur"] / 1e3 for r in ranges}
    return device, host, b1_bwd


def device_events(prof):
    """The profile's device work by name (kernels, copies, fills), without
    the device-side spans of the ``record_function`` ranges, which overlap
    the kernels inside them."""
    from torch.autograd import DeviceType

    ranges = {name for name, _ in STAGE_RANGES}
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in ranges]


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
    from dreamwaltz_g_tpu_torch.ops import blend_train as BT
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
    kernel_fns = {"blend_sorted": blend_sorted,
                  "blend_train_fwd": BT.blend_train_fwd,
                  "blend_train_bwd": BT.blend_train_bwd,
                  "blend_tiles_eval": BT.blend_tiles_eval_panels}
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
        want = N_FRAMES if name == "blend_sorted" else 0
        if n != want:
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = device_events(prof)
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

    # -- the table blends at the training size (512^2) --------------------
    from dreamwaltz_g_tpu_torch.configs import RenderConfig
    from dreamwaltz_g_tpu_torch.training.gs_trainer import (
        init_avatar_train_state,
        make_avatar_sds_step,
    )
    from dreamwaltz_g_tpu_torch.training.optim import (
        avatar_param_groups,
        build_avatar_optimizer,
    )

    tcams = make_camera_batch([2.5], [30.0], [85.0], [50.0], TRAIN_H,
                              TRAIN_W, at_vector=((0.0, 0.7, 0.0),),
                              device=dev)
    obs0 = type(frames)(*[x[0] for x in frames])
    tiles_x = -(-TRAIN_W // TRAIN_RASTER["tile_size"])
    with torch.no_grad():
        gs0 = animate(model, state, obs0)
        g_train = R.project_gaussians(
            gs0.positions, R.covariance3d(gs0.quats, gs0.scales),
            gs0.opacities, gs0.colors, tcams.extrinsic[0],
            tcams.intrinsics[0], TRAIN_H, TRAIN_W, tanfov=tcams.tanfov[0],
            alive=gs0.alive)
        t_args, t_values, t_overflow = panel_args(g_train, TRAIN_H, TRAIN_W,
                                                  TRAIN_RASTER)
        errs_avatar = compare_train_blend("avatar_512", t_args, t_values,
                                          tiles_x)
        g_scene = random_scene(dev, TRAIN_H, TRAIN_W)
        s_args, s_values, _ = panel_args(g_scene, TRAIN_H, TRAIN_W,
                                         TRAIN_RASTER)
        errs_scene = compare_train_blend("random_200k_512", s_args, s_values,
                                         tiles_x)

    # -- the tiny SDS step: CPU plain versions vs card kernels -------------
    small_train(dev)

    # -- the training path: counts to 0, 3 + 10 steps, counts read ---------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guidance, gparams = build_guidance(dev)
    torch.cuda.synchronize()
    guidance_s = time.perf_counter() - t0
    tx = build_avatar_optimizer(RenderConfig(), MAX_STEPS)
    tstate = init_avatar_train_state(state, tx, model)
    step = make_avatar_sds_step(model, guidance, TRAIN_H, TRAIN_W,
                                device=dev, **TRAIN_RASTER)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt = torch.bfloat16
    ctx_dim = gparams.unet.cfg.cross_attention_dim     # 768 for SD1.5
    txt = torch.randn((1, 77, ctx_dim), generator=gen, device=dev).to(dt)
    unc = torch.zeros_like(txt)
    t_step = torch.tensor([TIMESTEP], device=dev)
    cond = torch.as_tensor(pose_canvas(TRAIN_H, TRAIN_W), device=dev)[None]
    cond = cond.to(dt)
    bg_train = torch.zeros((TRAIN_H, TRAIN_W, 3), device=dev)
    step_in = (obs0, tcams.extrinsic[0], tcams.intrinsics[0],
               tcams.tanfov[0], bg_train, txt, unc, t_step)
    before = params_snapshot(state, model)
    train_fns = {"blend_sorted": blend_sorted,
                 "blend_train_fwd": BT.blend_train_fwd,
                 "blend_train_bwd": BT.blend_train_bwd,
                 "blend_tiles_eval": BT.blend_tiles_eval_panels}
    for fn in train_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, overflows, step_s = [], [], []
    start_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            start_ev.record()
        t0 = time.perf_counter()
        tstate, metrics = step(tstate, gparams, *step_in, cond_image=cond,
                               generator=gen)
        losses.append(float(metrics["loss"]))
        overflows.append(float(metrics["tile_overflow"]))
        step_s.append(time.perf_counter() - t0)
    end_ev.record()
    torch.cuda.synchronize()
    train_ms = start_ev.elapsed_time(end_ev) / TRAIN_STEPS
    train_launches = {name: fn.launches for name, fn in train_fns.items()}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    for name in ("blend_train_fwd", "blend_train_bwd"):
        if train_launches[name] != n_steps:
            fail(f"{name} launched {train_launches[name]} times for "
                 f"{n_steps} steps")
    for name in ("blend_sorted", "blend_tiles_eval"):
        if train_launches[name] != 0:
            fail(f"{name} launched on the training path")
    state = tstate.avatar
    after = params_snapshot(state, model)
    moved = {k: float((after[k] - before[k]).abs().max()) for k in before}
    finite_params = all(
        bool(torch.isfinite(p).all())
        for ts_ in avatar_param_groups(state.params, model).values()
        for p in ts_)
    emit(phase="train", steps=n_steps, warmup=TRAIN_WARMUP,
         resolution=[TRAIN_H, TRAIN_W], launches=train_launches,
         loss=losses, tile_overflow=overflows, first_step_s=step_s[0],
         grad_denom_sum=float(state.grad_denom.sum()),
         grad_accum_max=float(state.grad_accum.max()), moved=moved,
         params_finite=finite_params, guidance_build_s=guidance_s,
         guidance_params=sum(p.numel() for m in gparams if m is not None
                             for p in m.parameters()),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         flash_attention="off", **card)
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite SDS loss")
    if float(state.grad_denom.sum()) <= 0:
        fail("no Gaussian was visible to the densifier stats")
    if min(moved.values()) <= 0.0:
        fail(f"a parameter group did not move: {moved}")
    if not finite_params:
        fail("a parameter is not finite after training")

    # -- train times -------------------------------------------------------
    tl_, tc_, packed_ = t_args
    with torch.no_grad():
        _, saved_ = BT.blend_train_fwd(tl_, tc_, packed_,
                                       TRAIN_RASTER["tile_size"], tiles_x)
        ref_, ckpt_ = BT.blend_tiles_train_reference_fwd(
            tl_, tc_, packed_, TRAIN_RASTER["tile_size"], tiles_x)
        g_ = torch.randn(ref_.shape, generator=gen, device=dev)
        ts_ = TRAIN_RASTER["tile_size"]
        kargs = (tl_, tc_, packed_)
        k_ms = {
            "blend_train_fwd": cuda_ms(lambda: BT.blend_train_fwd(
                *kargs, ts_, tiles_x), 20),
            "blend_train_bwd": cuda_ms(lambda: BT.blend_train_bwd(
                *kargs, saved_, g_, ts_, tiles_x), 20),
            "blend_tiles_eval": cuda_ms(lambda: BT.blend_tiles_eval_panels(
                *kargs, ts_, tiles_x), 20)}
        p_ms = {
            "blend_train_fwd": cuda_ms(
                lambda: BT.blend_tiles_train_reference_fwd(
                    *kargs, ts_, tiles_x), 3),
            "blend_train_bwd": cuda_ms(
                lambda: BT.blend_tiles_train_reference_bwd(
                    *kargs, ckpt_, g_, ts_, tiles_x), 3),
            "blend_tiles_eval": cuda_ms(
                lambda: BT.blend_tiles_eval_reference(*kargs, ts_, tiles_x),
                3)}
    bounds = table_bounds(t_args, errs_avatar[3])
    emit(phase="train_times", sds_step_ms=train_ms,
         sds_it_per_s=1e3 / train_ms, kernel_ms=k_ms, plain_ms=p_ms,
         bounds=bounds, tile_overflow_frame=t_overflow,
         flash_attention="off", **card)

    # -- busy share, stage breakdown and top kernels over one SDS step ------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tstate, _ = step(tstate, gparams, *step_in, cond_image=cond,
                         generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = device_events(prof)
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.device_time_total)[:12]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = kernels.BUILD_DIR / "sds_step_trace.json"
    prof.export_chrome_trace(str(trace))
    stage_dev, stage_host, b1_bwd_ms = stage_times(trace)
    emit(phase="train_profile", steps=1, wall_ms=wall_ms,
         device_busy_ms=busy_ms if on_card else None,
         device_busy_share=busy_ms / wall_ms if on_card else None,
         kernel_launches=sum(e.count for e in on_card),
         stage_device_ms=stage_dev, stage_host_ms=stage_host,
         backward_blend_train_bwd_kernel_ms=b1_bwd_ms,
         top_kernels=[[e.key[:80], e.device_time_total / 1e3, e.count]
                      for e in top], **card)

    def entry(name, source, replaces, launches, err, ms, plain, bound):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                "plain_ms": plain, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "library_ms": None}

    train_src = "dreamwaltz_g_tpu_torch/csrc/blend_train.cu"
    print(json.dumps({"kernels": [
        entry("blend_sorted", "dreamwaltz_g_tpu_torch/csrc/blend_sorted.cu",
              "dreamwaltz_g_tpu/ops/pallas_blend.py:326",
              launches["blend_sorted"], max(err_avatar, err_scene),
              kernel_ms, plain_ms,
              {"bound_ms": bound_ms,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}),
        entry("blend_train_fwd", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:579",
              train_launches["blend_train_fwd"],
              max(errs_avatar[0], errs_scene[0]), k_ms["blend_train_fwd"],
              p_ms["blend_train_fwd"], bounds["blend_train_fwd"]),
        entry("blend_train_bwd", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:579",
              train_launches["blend_train_bwd"],
              max(errs_avatar[1], errs_scene[1]), k_ms["blend_train_bwd"],
              p_ms["blend_train_bwd"], bounds["blend_train_bwd"]),
        entry("blend_tiles_eval", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:126",
              train_launches["blend_tiles_eval"],
              max(errs_avatar[2], errs_scene[2]), k_ms["blend_tiles_eval"],
              p_ms["blend_tiles_eval"], bounds["blend_tiles_eval"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

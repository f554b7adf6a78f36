"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device       -- CUDA present (else exit 2), card name and power limit;
2. build        -- compile every CUDA kernel of the port from ``csrc/``
                   (three sources), one ``nvcc`` per source, all started
                   together;
3. avatar       -- build the full-width avatar on the card;
4. kernel       -- ``blend_sorted`` (B2) against its plain version on the
                   same card inputs: one projected 1024^2 frame of the avatar,
                   a 200k-Gaussian random scene and the avatar on a
                   Motion-X-ReEnact camera at 720 x 1280 (half a tile row
                   at the bottom); the kernel's device ms
                   alone, its build facts, the entries a tile and the share
                   of pairs its footprint cull keeps;
5. small        -- the tiny avatar rendered on the CPU (plain blend) and on
                   the card (kernel) agree;
6. main         -- the render path: launch counts set to 0, 8 animated
                   1024^2 frames through ``make_avatar_render_frames``,
                   counts read (``blend_sorted`` once a frame, no other
                   kernel);
7. times        -- render ms/frame, a per-stage breakdown, B2's time beside
                   its plain version and its bound: the wrapper call, the
                   kernel alone, and the wrapper's row packing and untiling;
8. profile      -- device busy share and top kernels over one 8-frame render;
9. kernel_train -- the table blends at 512^2 on one projected avatar frame
                   and on the random scene: B1 forward and backward and B3
                   (through ``_blend_dispatch(mode="eval")``) against their
                   plain versions, each kernel's device ms alone (with its
                   launches' median, min and max) and build facts, and the
                   per-tile work as for B2;
10. kernel_flash -- flash attention (B4) forward at the eight shapes the
                   training paths give it (bf16, and float32 for the tiny
                   step and the float32-guidance step), and backward at the
                   four that are differentiated, against the plain versions;
11. small_train -- one SDS step of the tiny avatar, with its mesh part,
                   and the tiny guidance with its ControlNet, attention
                   through flash (``FLASH_ATTENTION = "on"``) and the
                   pixel-gradient hook set: on the CPU (plain versions,
                   under each stop rule) and on the card (kernels), from the
                   same state and noise;
12. clip_text    -- the SD1.5 text tower (12 layers, 768 wide, 77 tokens)
                   with random weights from the seed, on the card and on
                   the CPU from the same weights and ``HashTokenizer`` ids;
                   its embeddings of the run's prompts (the first, and the
                   null prompt last) condition every SDS phase below;
13. train       -- the training path: the full avatar, the SD1.5-size bf16
                   UNet + ControlNet + VAE with ``FLASH_ATTENTION = "auto"``,
                   timesteps and guidance scale from
                   ``TimePrioritizedScheduler``, the condition renderer's
                   OpenPose canvas of the posed body; counts set to 0, 3 warm-up and
                   10 steps through ``make_avatar_sds_step``, counts read
                   (``blend_train_fwd`` and ``blend_train_bwd`` once a step,
                   flash forward and backward as often as the models'
                   structure gives, no other kernel), outputs and parameter
                   updates checked;
14. train_times -- SDS it/s with flash and, over 2 + 4 steps, with einsum
                   attention (``"off"``); each table kernel's and each flash
                   shape's time beside its plain version, its bound and, for
                   flash, the einsum path and
                   ``scaled_dot_product_attention`` (timed here only); for
                   each flash forward also the kernels' device ms (by
                   name: the D = 512 forward is two kernels, the wide
                   forward and its combine), TFLOP/s and share of the
                   bound, and its instantiation's build facts (registers
                   and spills from ptxas, shared memory and blocks an SM
                   from the library; the combine's too); the same for each
                   differentiated shape's backward (``bwd_kernel_ms``,
                   ``bwd_build``: delta and the two passes, or at D = 512
                   the dK / dV pass and the dS K product);
15. train_profile -- device busy share, the step's device and host ms by
                   stage (its own ``record_function`` ranges), the
                   hand-written kernels' device ms by name (B1 forward's,
                   B1 backward's, flash forward's and backward's) and top
                   kernels over one profiled SDS step;
16. train_densify -- ``gs_trainer.densify`` on the full avatar, at the
                   defaults and with thresholds at the medians so that
                   clones and splits happen; invariants checked; two more
                   SDS steps; then ``train_profile_densified``: one
                   profiled step again, with the buffer full;
17. small_nerf_train -- one stage-1 SDS step of a tiny NeRF (16^2 x 8
                   triplane) with the tiny guidance and its ControlNet,
                   flash ``"on"``, rays in checkpointed chunks, sigma
                   guidance, volume sparsity and the background MLP: on the
                   CPU (plain versions) and on the card (kernels), from the
                   same field, grid and draws;
18. nerf_train  -- the stage-1 path at the full width of step 1.2 of
                   ``scripts/train_w_expr.sh``: ``NeRFConfig()``'s field
                   rendered at 512^2, the SD1.5-size bf16 guidance of phase
                   13 under ``FLASH_ATTENTION = "auto"``, sigma guidance on
                   5,000 body points a step; counts set to 0, 3 warm-up and
                   10 steps through ``make_nerf_sds_step`` with the
                   occupancy cadence and one forced refresh, counts read
                   (flash forward and backward each step as the models'
                   structure gives, no blend kernel, no library
                   attention); then ``nerf_profile``: device ms by the
                   step's own ranges, busy share, top kernels;
19. train_f32   -- the same step with the UNet, ControlNet and VAE in
                   float32 (the JAX package's ``guide.dtype = "fp32"``): the
                   bf16 stack freed, counts set to 0, 1 warm-up and 3 steps
                   with flash, counts and the calls' types read (15 float32
                   forwards and 1 backward a step), 1 + 2 steps with einsum
                   attention, one profiled step; step ms, the float32 flash
                   kernels' device ms a step, busy share, peak memory;
20. cli_assets / cli_two_stage -- ``scripts/train_w_expr.sh`` steps 1.2,
                   2.1 and 2.3 through the port's CLI in-process
                   (``dreamwaltz_g_tpu_torch.main.main``) at full width:
                   the synthetic SMPL-X-sized body (with landmark tables
                   and a segmentation of hands and head) and the SD1.5
                   card's UNet, pose ControlNet, VAE and CLIP text tower
                   with random weights in diffusers layout, written to a
                   temporary directory, and a field fitted to the body
                   standing in for step 1.1's output; 4, 4 and 3 steps,
                   the last of each run profiled; counts set to 0 before
                   each run and read after it (flash (15, 1) a step, the
                   table blends (0, 0) in stage 1 and (1, 1) in stage 2);
                   losses, s/step, peak memory, busy share, the device ms
                   of the trainer's batch build, condition render and
                   step; the handoff's export (dense cells before and
                   after the isolated-cell filter, points, capacity), its
                   LBS smoothing ms, the stage-1 planes carried verbatim,
                   and step 2.3's warm start equal to step 2.1's last
                   checkpoint to every bit;
21. cli_inference -- in the same directory, the inference and evaluation
                   paths through ``dreamwaltz_g_tpu_torch.main.main``:
                   step 3 of the script (``--log.eval_only``: 60 frames of
                   a synthetic TalkSHOW demo motion at 1024^2 through B2,
                   their PNGs, mp4 and R-Precision with full-size random
                   CLIP towers), steps 1.2 and 2.3 for 2 steps with a
                   snapshot every step and an evaluation every 2, and
                   ``scripts/inference_reenact.sh``'s command on a
                   synthetic Motion-X-ReEnact sequence (30 frames of
                   720 x 1280 on its own cameras over its inpainted video,
                   the overlay mp4); counts set to 0 before each run and
                   read after it;
22. cli_modes   -- in the same directory, the CLI's other modes through
                   ``dreamwaltz_g_tpu_torch.main.main`` at full width:
                   ``scripts/pretrain_nerf.sh``'s arguments for 3 steps
                   (no kernel; the checkpoint, and step 1.1's warm start
                   from it equal to it to every bit), ``--log.nerf2gs``
                   from step 1.2's field for 3 steps (B1 forward and
                   backward once a step; the frozen field unchanged),
                   ``--log.check --log.check_sd`` on step 2.3's avatar
                   (the condition images and the 50-step DDIM samples;
                   flash forwards equal to the models' structural count,
                   no backward) and ``--log.nerf2mesh`` on step 1.2's field
                   at resolution 128 (an OBJ with valid indices, its
                   texture; the field queries' device time apart from the
                   host's mesh work); counts set to 0 before each run and
                   read after it;
23. cli_geometry -- in the same directory, the trainer's other geometries
                   through the CLI at full width, 3 steps each: the DMTet
                   finetune from step 1.2's field (``tet_grid_size`` 128,
                   512^2; then a resumed construction and one eval frame
                   through B1's forward), the vanilla avatar from 2.1's
                   arguments (densified at step 2, its opacities reset at
                   step 3; then ``--log.eval_only`` over 8 1024^2 frames,
                   B2 once a frame) and the hash avatar (then one eval
                   frame); B1 (1, 1) and flash (15, 1) a step in each run.

Then the kernels line, the ``nvidia-smi`` name/power-limit line, and the
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. The avatar is the synthetic
SMPL-X-sized body (10,475 vertices, 55 joints) with random weights from a
seed: 180k points in a 200k-slot buffer, a 256^2 x 32 triplane, the
trainer's decode heads, 6,000 hand-bound mesh Gaussians. The guidance,
text tower and stage-1 field weights are random from the seed too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
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
BF16_FLOP_PER_S = 989e12    # dense, tensor cores
TF32_FLOP_PER_S = 495e12    # dense, tensor cores
# float32 operations per (pixel, entry) pair of the blend: every pair
# evaluates q and w (2 sub, 6 mul + 2 add for q, 2 mul + 1 exp for w) = 13;
# a pair that passes min_alpha adds the clip, T*w, 8 multiply-adds and the
# transmittance update = 20 more
OPS_PER_PAIR = 13
OPS_PER_BLENDED_PAIR = 20
# The blends cull (every table kernel and B2): a pair counts only where its
# pixel's patch keeps the entry, and each block boxes every entry it walks,
# in float64
# (csrc/blend_common.cuh: footprint_box): 1 mul for the op test, 3 for det,
# 3 for kappa, 9 for r (a log), 3 each for the half-widths (a sqrt each) and
# 4 for the box's sides = 26
BOX_OPS = 26
FP64_FLOP_PER_S = 34e12     # H100 SXM, outside the tensor cores
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


# -- flash attention (B4): (shape (B, N, H, D), type, backward held too).
# The full-width step gives it the three bf16 shapes (UNet and ControlNet
# under CFG at 64^2 and 32^2 latents, the VAE encoder's mid block, which is
# differentiated); the tiny step the first two float32 ones; the full-width
# step with the guidance in float32 (phase ``train_f32``) the last three
FLASH_SHAPES = (((2, 4096, 8, 40), "bf16", False),
                ((2, 1024, 8, 80), "bf16", False),
                ((1, 4096, 1, 512), "bf16", True),
                ((1, 1024, 2, 16), "f32", True),
                ((1, 1024, 1, 64), "f32", True),
                ((2, 4096, 8, 40), "f32", False),
                ((2, 1024, 8, 80), "f32", False),
                ((1, 4096, 1, 512), "f32", True))
# kernel vs plain version (float32 scores) on the same card inputs.
# float32: 1e-5 absolute on the output, 1e-4 of each gradient's largest
# entry, the JAX package's own for its TPU kernel. bf16: the kernel rounds
# each probability and each output to bf16 once, at most 2^-8 relative a
# rounding. The output's rounding gives at most 2^-8 |out|; the
# probabilities' roundings are independent over the keys, so their sum stays
# far inside its worst case 2^-8 sum_j p_j |v_j|. The limit, per element, is
# 2^-9 (sum_j p_j |v_j| + |out|): all of the first (sum p |v| >= |out|) and
# what is left for the second. With these inputs it is ~2e-3 where an output
# is ~0.03 (up to ~0.25), so a kernel that drops keys or normalises wrongly
# fails it. The backward rounds P, dS and each result likewise, a sum of such
# terms held to 2^-6 of each gradient's largest entry
TOL_FLASH_F32_OUT = 1e-5
TOL_FLASH_F32_GRAD = 1e-4
TOL_FLASH_BF16_OUT = 2.0 ** -9
TOL_FLASH_BF16_GRAD = 2.0 ** -6
# flash launches a step of the SD1.5-size stack (forward, backward): UNet
# 5 + 5 and ControlNet 2 + 2 self-attentions at 4096 and 1024 tokens, the
# VAE encoder's mid block forward and backward; the 256- and 64-token layers
# stay on einsum
FLASH_PER_STEP = (15, 1)
OFF_STEPS, OFF_WARMUP = 4, 2   # the einsum-attention comparison run
# the float32-guidance step (phase train_f32): warm-up and timed steps with
# flash ("auto"), then with einsum attention ("off")
F32_WARMUP, F32_STEPS = 1, 3
F32_OFF_WARMUP, F32_OFF_STEPS = 1, 2


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after one
    untimed call (a library's first call may load or pick its kernel)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
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


def blend_inputs(g, tile_size, capacity, max_tiles, height=H, width=W):
    """The wrapper's arguments for one projected frame, as the render path
    builds them."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import rasterize as R

    s_idx, seg_start, counts, overflow = R.bin_gaussians_sorted(
        g.means2d, g.radius, g.depth, g.mask, height, width, tile_size,
        capacity, max_tiles)
    N = g.colors.shape[0]
    values = torch.cat([g.colors, g.depth[:, None],
                        torch.ones((N, 1), device=g.colors.device)], -1)
    return (s_idx, seg_start, counts, g.means2d, g.conic,
            g.opacity * g.mask.to(g.opacity.dtype), values), overflow


def compare_blend(label, args, build, height=H, width=W):
    """Kernel vs plain version on the same inputs (a ``height`` x ``width``
    frame); returns the errors and the
    pair counts of the plain version's run, with ``tile_work``'s. The
    kernel's device ms alone is taken in phase ``times``, after the render's
    own timings: a profiler session (``kernel_device_ms``) slows the host's
    kernel launches for the rest of the process, and the render is bound by
    them."""
    import torch

    from dreamwaltz_g_tpu_torch.ops.blend import (
        blend_sorted,
        blend_sorted_reference,
        pack_rows,
    )

    kw = dict(tile_size=RASTER["tile_size"], chunk=RASTER["chunk"],
              capacity=RASTER["capacity"])
    out = blend_sorted(*args, height, width, **kw)
    stats = {}
    ref = blend_sorted_reference(*args, height, width, stats=stats, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: kernel output not finite")
    err = (out - ref).abs()
    e_rgb = float(err[..., :3].max())
    e_alpha = float(err[..., 4].max())
    e_depth = float(err[..., 3].max())
    dmax = float(args[6][:, 3].abs().max())
    s_idx, seg_start, counts, means2d, conic, op, values = args
    slot = torch.arange(RASTER["capacity"], device=s_idx.device)
    src = (seg_start[:, None] + slot).clamp(max=s_idx.shape[0] - 1).long()
    lists = torch.where(slot < counts[:, None], s_idx[src], means2d.shape[0])
    work = tile_work(lists[None], counts[None],
                     pack_rows(means2d, conic, op, values)[None],
                     RASTER["tile_size"], -(-width // RASTER["tile_size"]),
                     stats["reached"][None])
    stats.update(work)
    emit(phase="kernel", input=label, kernel="blend_sorted",
         resolution=[height, width],
         max_abs_err_rgb=e_rgb, max_abs_err_alpha=e_alpha,
         max_abs_err_depth=e_depth, max_depth=dmax,
         tol_rgb_alpha=TOL_RGB_ALPHA, tol_depth=TOL_DEPTH_REL * dmax,
         pixels_over_1e4=int((err[..., [0, 1, 2, 4]].amax(-1) > 1e-4).sum()),
         pairs=stats["pairs"], blended_pairs=stats["blended"],
         entries=int(args[2].sum()), coverage=float((ref[..., 4] > 0.01)
                                                    .float().mean()),
         build=build, **work)
    if max(e_rgb, e_alpha) > TOL_RGB_ALPHA or e_depth > TOL_DEPTH_REL * dmax:
        fail(f"{label}: blend_sorted disagrees with its plain version")
    return max(e_rgb, e_alpha), stats


def tile_work(tile_lists, tile_counts, packed, tile_size, tiles_x, reached):
    """The per-tile work of a (B, T, K) table: entries a tile (max, mean,
    tiles holding K), the share of the (pixel, entry) pairs of the live
    entries -- every pixel of the entry's tile, before any pixel's stop --
    that the footprint cull keeps, and the most entries it keeps for one
    8 x 4 patch (the longest walk a warp makes), from the cull's plain twins
    (``ops/blend.py:footprint_boxes``, ``patch_keep``), not counted in a
    kernel. With ``reached``, the (B, T, P) entries each pixel reaches
    before its stop (the plain version's ``stats``), also the work a culling
    kernel needs: ``kept_pairs``, the reached pairs whose entry the pixel's
    patch keeps, and ``boxed_entries``, the entries each 8-row block boxes
    (up to its pixels' largest reach), summed over the blocks."""
    import torch

    from dreamwaltz_g_tpu_torch.ops import blend as BL
    from dreamwaltz_g_tpu_torch.ops.blend_train import _gather

    K = tile_lists.shape[-1]
    dev = tile_lists.device
    live = torch.arange(K, device=dev) < tile_counts[..., None]
    keep = BL.patch_keep(BL.footprint_boxes(_gather(packed, tile_lists)),
                         tile_size, tiles_x) & live[..., None, :]
    per_patch = keep.sum(-1)                           # (B, T, patches)
    kept = int(per_patch.sum()) * BL.PATCH_W * BL.PATCH_H
    # kept entries among each pixel's first `reached`, by a prefix count
    # over its patch's row of `keep`
    prefix = torch.cat([torch.zeros_like(per_patch[..., None]),
                        keep.cumsum(-1)], -1).flatten(-2)
    pid = torch.arange(tile_size ** 2, device=dev)
    patch = (pid // tile_size // BL.PATCH_H * (tile_size // BL.PATCH_W)
             + pid % tile_size // BL.PATCH_W)
    reached = reached.long()
    kept_pairs = prefix.gather(-1, patch * (K + 1) + reached)
    # blocks of 8 tile rows (blend_common.cuh: kBlockRows)
    boxed = reached.unflatten(-1, (tile_size // 8, -1)).amax(-1)
    counts = tile_counts.float()
    return dict(entries_per_tile_max=int(tile_counts.max()),
                entries_per_tile_mean=float(counts.mean()),
                tiles_at_K=int((tile_counts == K).sum()), tiles=counts.numel(),
                cull_keep_share=kept / max(int(live.sum()) * tile_size ** 2,
                                           1),
                kept_entries_per_patch_max=int(per_patch.max()),
                kept_pairs=int(kept_pairs.sum()),
                boxed_entries=int(boxed.sum()))


def named_ms(by_name, pattern):
    """The device ms of the kernels whose name holds ``pattern``, from
    ``kernel_device_ms``'s by-name dict."""
    found = [ms for name, ms in by_name.items() if pattern in name]
    if not found:
        fail(f"no kernel named like {pattern!r} in {sorted(by_name)}")
    return sum(found)


# blend_sorted_info's and blend_train_info's six numbers
BLEND_INFO_KEYS = ("threads", "static_smem_bytes", "dynamic_smem_bytes",
                   "blocks_per_sm", "registers", "local_bytes")


def blend_builds(logs):
    """Each blend kernel's build facts at the paths' launch shapes: spills
    from the ptxas log, and threads, static and dynamic shared memory,
    resident blocks an SM, registers and local memory from the library's
    ``blend_sorted_info`` / ``blend_train_info``."""
    import ctypes

    from dreamwaltz_g_tpu_torch import kernels

    facts = {**ptxas_facts(logs["blend_sorted"]),
             **ptxas_facts(logs["blend_train"])}
    ts = RASTER["tile_size"]
    sorted_info = kernels.load("blend_sorted").blend_sorted_info
    train_info = kernels.load("blend_train").blend_train_info
    out = {}
    for name, fn, args, family in (
            ("blend_sorted_kernel", sorted_info, (ts,), "blend_sorted_kernel"),
            ("blend_fwd_kernel<true>", train_info, (0, ts),
             "blend_fwd_kernelILb1E"),
            ("blend_fwd_kernel<false>", train_info, (1, ts),
             "blend_fwd_kernelILb0E"),
            ("blend_bwd_kernel", train_info, (2, ts), "blend_bwd_kernelE"),
            ("blend_bwd_sum_kernel", train_info, (3, ts),
             "blend_bwd_sum_kernel"),
            ("blend_bwd_order_kernel", train_info, (4, ts),
             "blend_bwd_order_kernel")):
        info = (ctypes.c_int * len(BLEND_INFO_KEYS))()
        rc = fn(*args, ctypes.addressof(info))
        if rc != 0:
            fail(f"{name}: build facts failed: CUDA error {rc}")
        ptx = next((f for k, f in facts.items() if family in k), None)
        if ptx is None:
            fail(f"no ptxas entry for {name}")
        out[name] = dict(spill_stores=ptx.get("spill_stores"),
                         spill_loads=ptx.get("spill_loads"),
                         **dict(zip(BLEND_INFO_KEYS, info)))
    return out


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


def compare_train_blend(label, args, values, tiles_x, build):
    """B1 forward and backward and B3 against their plain versions on the
    same card inputs. Returns the errors, the plain version's pair counts
    with ``tile_work``'s, and each kernel's device ms alone
    (``kernel_device_ms``; the backward's three kernels summed), whose
    per-launch median, min and max stand beside it in
    ``kernel_launch_spread_ms``."""
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
    stats.update(tile_work(tl, tc, packed, ts, tiles_x, stats["reached"]))
    profiled = {
        "blend_train_fwd": kernel_device_ms(lambda: BT.blend_train_fwd(
            tl, tc, packed, ts, tiles_x, **kw), 20, spread=True),
        "blend_train_bwd": kernel_device_ms(lambda: BT.blend_train_bwd(
            tl, tc, packed, saved, g, ts, tiles_x, **kw), 20, spread=True),
        "blend_tiles_eval": kernel_device_ms(
            lambda: BT.blend_tiles_eval_panels(tl, tc, packed, ts, tiles_x,
                                               **kw), 20, spread=True)}
    by_name = {k: v[1] for k, v in profiled.items()}
    alone = {"blend_train_fwd": named_ms(by_name["blend_train_fwd"],
                                         "blend_fwd_kernel<true>"),
             "blend_train_bwd": named_ms(by_name["blend_train_bwd"],
                                         "blend_bwd"),
             "blend_tiles_eval": named_ms(by_name["blend_tiles_eval"],
                                          "blend_fwd_kernel<false>")}
    emit(phase="kernel_train", input=label,
         max_abs_err_fwd_rgb=e_fwd[0], max_abs_err_fwd_alpha=e_fwd[1],
         max_abs_err_fwd_depth=e_fwd[2], max_depth=dmax, **errs_bwd,
         max_abs_err_eval=e_eval,
         tol_rgb_alpha=TOL_RGB_ALPHA, tol_depth=TOL_DEPTH_REL * dmax,
         grad_rtol=GRAD_RTOL, grad_atol_of_max=GRAD_ATOL_OF_MAX,
         pairs=stats["pairs"], blended_pairs=stats["blended"],
         entries=int(tc.sum()), coverage=float((img_ref[..., 4] > 0.01)
                                               .float().mean()),
         kernel_alone_ms=alone, kernel_ms_by_name=by_name,
         kernel_launch_spread_ms={k: v[2] for k, v in profiled.items()},
         build=build,
         **{k: v for k, v in stats.items() if k not in ("pairs", "blended",
                                                         "reached")})
    if max(e_fwd[0], e_fwd[1]) > TOL_RGB_ALPHA or \
            e_fwd[2] > TOL_DEPTH_REL * dmax:
        fail(f"{label}: blend_train_fwd disagrees with its plain version")
    check_bwd(label, errs_bwd)
    if e_eval > max(TOL_RGB_ALPHA, TOL_DEPTH_REL * dmax):
        fail(f"{label}: blend_tiles_eval disagrees with its plain version")
    return (max(e_fwd[0], e_fwd[1]), errs_bwd["max_abs_err_bwd"], e_eval,
            stats, alone)


def cull_ops_ms(stats, ops_per_blended):
    """The operations a culling blend (every table kernel, B2) needs on a
    frame, and their least ms: the 13 of a pair for the reached pairs whose
    patch keeps the entry, the blended pairs' own, over the float32 rate,
    and each block's float64 boxes over the float64 rate."""
    f32 = (OPS_PER_PAIR * stats["kept_pairs"]
           + ops_per_blended * stats["blended"])
    f64 = BOX_OPS * stats["boxed_entries"]
    return f32 + f64, (f32 / FP32_FLOP_PER_S + f64 / FP64_FLOP_PER_S) * 1e3


def table_bounds(args, stats):
    """Least times of the three table kernels on these inputs: the bytes
    each must move over HBM rate, and this frame's pair work over the
    float32 rate. Bytes: the 64-byte rows the lists reference and the
    lists' live entries, read once; the tile counts; per pixel the 32-byte
    output and 8-byte state (forward), or the state and the 32-byte
    upstream gradient (backward); and the backward's 64-byte gradient of
    each live entry, written once. All three cull, so each counts only the
    reached pairs its patches keep and its blocks' boxes (``cull_ops_ms``),
    and beside that ``ops_unculled``, every reached pair."""
    import torch

    tl, tc, packed = args
    B, T, _ = tl.shape
    P = TRAIN_RASTER["tile_size"] ** 2
    n_rows = packed.shape[1]
    entries = int(tc.sum())
    rows = sum(int(torch.unique(tl[b][tl[b] < n_rows - 1]).numel())
               for b in range(B))
    common = 64 * rows + 4 * entries + 4 * B * T
    out = {}
    for name, nbytes, per_blended in (
            ("blend_train_fwd", common + (32 + 8) * B * T * P,
             OPS_PER_BLENDED_PAIR),
            ("blend_train_bwd", common + (8 + 32) * B * T * P
             + 64 * entries, OPS_BWD_PER_BLENDED_PAIR),
            ("blend_tiles_eval", common + 32 * B * T * P,
             OPS_PER_BLENDED_PAIR)):
        ops, o_ms = cull_ops_ms(stats, per_blended)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(bytes=nbytes, ops=ops, rows=rows, entries=entries,
                         bytes_ms=b_ms, ops_ms=o_ms,
                         bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations",
                         ops_unculled=OPS_PER_PAIR * stats["pairs"]
                         + per_blended * stats["blended"])
    return out


def flash_inputs(dev, shape, kind):
    """Seeded q, k, v and an upstream gradient on the card, contiguous
    (B, N, H, D) as the modules' projections give them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape))
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def flash_bound(shape, kind, backward):
    """Least time of one flash call on the card: 4 B H N^2 D operations
    forward (two products), 10 B H N^2 D backward (five), at the real D;
    q, k, v, out (and d_out, dq, dk, dv) and lse moved once over the HBM
    rate. bf16 operations run at the tensor cores' bf16 rate. float32-grade
    products have two routes, whichever is faster, whatever a kernel's
    design: the CUDA cores at 67 TFLOP/s, or three TF32 tensor-core products
    for each at 495 TFLOP/s (165 TFLOP/s of float32 products); both times
    are reported."""
    B, N, H, D = shape
    elt = 2 if kind == "bf16" else 4
    ops = (10 if backward else 4) * B * H * N * N * D
    nbytes = (8 if backward else 4) * B * N * H * D * elt + 4 * B * H * N
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    routes = {}
    if kind == "bf16":
        o_ms = ops / BF16_FLOP_PER_S * 1e3
    else:
        routes = dict(cuda_cores_ms=ops / FP32_FLOP_PER_S * 1e3,
                      tf32x3_ms=3 * ops / TF32_FLOP_PER_S * 1e3)
        o_ms = min(routes.values())
    return dict(ops=ops, bytes=nbytes, ops_ms=o_ms, bytes_ms=b_ms, **routes,
                bound_ms=max(o_ms, b_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


def compare_flash(dev):
    """B4 forward at every shape of ``FLASH_SHAPES`` and backward where the
    path differentiates it, against the plain versions on the same inputs.
    Returns the worst error of each kernel relative to its tolerance's
    scale. No input outlives its shape's check: the training phases' peak
    memory is the step's own."""
    import torch

    from dreamwaltz_g_tpu_torch.guidance import flash as FL

    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, kind, backward in FLASH_SHAPES:
        q, k, v, g = flash_inputs(dev, shape, kind)
        out, lse = FL.flash_attn_fwd(q, k, v)
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref, ref_lse = FL.flash_attention_plain(qf, kf, vf)
        if not bool(torch.isfinite(out).all()):
            fail(f"flash forward {shape}: output not finite")
        err = (out.float() - ref).abs()
        e_out = float(err.max())
        e_lse = float((lse - ref_lse).abs().max())
        if kind == "bf16":
            # per element: 2^-9 (sum_j p_j |v_j| + |out|)
            tol = TOL_FLASH_BF16_OUT * (
                FL.flash_attention_plain(qf, kf, vf.abs())[0] + ref.abs())
        else:
            tol = torch.full_like(ref, TOL_FLASH_F32_OUT)
        line = dict(shape=list(shape), type=kind, max_abs_err_out=e_out,
                    tol_out_min=float(tol.min()), tol_out_max=float(tol.max()),
                    max_err_out_of_tol=float((err / tol).max()),
                    max_abs_err_lse=e_lse, max_abs_out=float(ref.abs().max()),
                    mean_abs_out=float(ref.abs().mean()))
        worst["fwd"] = max(worst["fwd"], e_out)
        bad = bool((err > tol).any()) or e_lse > 1e-4
        if backward:
            grads = FL.flash_attn_bwd(q, k, v, out, lse, g)
            torch.cuda.synchronize()
            refs = FL.flash_attention_plain_bwd(qf, kf, vf, out.float(), lse,
                                                g.float())
            tol_g = TOL_FLASH_BF16_GRAD if kind == "bf16" \
                else TOL_FLASH_F32_GRAD
            rel = [float((a.float() - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads, refs)]
            e_abs = max(float((a.float() - b).abs().max())
                        for a, b in zip(grads, refs))
            line.update(max_err_dq_dk_dv_of_max=rel, tol_grad_of_max=tol_g,
                        max_abs_err_bwd=e_abs)
            worst["bwd"] = max(worst["bwd"], e_abs)
            bad = bad or max(rel) > tol_g or not all(
                bool(torch.isfinite(x).all()) for x in grads)
        emit(phase="kernel_flash", **line)
        if bad:
            fail(f"flash attention {shape} {kind} disagrees with its plain "
                 "version")
    return worst


def einsum_attention(q, k, v):
    """The modules' einsum path: scores in the working type, float32
    softmax, cast back."""
    import torch

    a = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    a = torch.softmax(a.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


def sdpa_times(q, k, v, g, backward):
    """``scaled_dot_product_attention`` on (B, H, N, D) views of the same
    tensors: ms of the default dispatch (forward, and backward where asked),
    and forward ms under each backend alone, or "refused". A yardstick
    only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt)

    out = {"fwd_ms": cuda_ms(call, 10), "bwd_ms": None, "backends": {}}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out["backends"][backend.name] = cuda_ms(call, 5)
        except RuntimeError:
            out["backends"][backend.name] = "refused"
    if backward:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*[x.transpose(1, 2)
                                             for x in leaves])
        gt = g.transpose(1, 2)

        def back():
            torch.autograd.grad(o, leaves, gt, retain_graph=True)

        out["bwd_ms"] = cuda_ms(back, 5)
    return out


def kernel_device_ms(fn, reps, spread=False):
    """Mean device ms of the kernels one ``fn()`` launches, from a profile
    of ``reps`` calls after one untimed call: the card's time alone, without
    the host's cost of each wrapper call, which at the small shapes is as
    long as the kernel. Returns (the sum, {kernel name: ms}); with
    ``spread``, also {kernel name: the median, min and max ms of its
    launches and their count}, from the profile's per-launch device events,
    not ``key_averages``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profile can come back without device events (seen once on a fresh
    # machine, in the first such profile of the run): take another
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key[:80]: e.device_time_total / reps / 1e3
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        if sum(by_name.values()) <= 0:
            continue
        if not spread:
            return sum(by_name.values()), by_name
        launches = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                launches.setdefault(e.key[:80], []).append(
                    e.device_time_total / 1e3)
        return sum(by_name.values()), by_name, {
            name: dict(median=statistics.median(ms), min=min(ms),
                       max=max(ms), launches=len(ms))
            for name, ms in launches.items()}
    fail("the profiler recorded no device time in three profiles")


def ptxas_facts(log):
    """{kernel's mangled name: {registers, spill_stores, spill_loads}} from
    an ``nvcc -Xptxas -v`` log."""
    facts, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            facts.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            facts[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            facts[name]["registers"] = int(m.group(1))
    return facts


# flash_attn_fwd_info's and flash_attn_bwd_info's seven numbers
FWD_INFO_KEYS = ("tile_width", "threads", "rows_per_block", "smem_bytes",
                 "blocks_per_sm", "registers_runtime", "local_bytes")


def template_args(name, family):
    """The template arguments in a mangled kernel name after ``family``:
    the integers and booleans (``Li48E``, ``Lb1E``) as ints, and the raw
    text (a type argument such as ``13__nv_bfloat16`` or ``f``); None if
    ``family`` is not in the name."""
    if family not in name:
        return None
    tail = name.split(family, 1)[1]
    raw = tail[1:].split("EEv", 1)[0] if tail.startswith("I") else ""
    return [int(a) for a in re.findall(r"L[ib](\d+)E", raw)], raw


def kernel_build(facts, info_fn, shape, kind, part, family, match):
    """One flash kernel's build facts: ``info_fn`` (the library's
    ``flash_attn_fwd_info`` or ``flash_attn_bwd_info``) gives its dynamic
    shared memory, threads, rows a block and resident blocks an SM for
    ``part``; the ptxas log's entry of ``family`` whose template arguments
    satisfy ``match(args, raw, info)`` gives its registers and spills (the
    log has no dynamic shared memory and no occupancy)."""
    import ctypes

    info = (ctypes.c_int * len(FWD_INFO_KEYS))()
    rc = info_fn(shape[-1], int(kind == "bf16"), part, ctypes.addressof(info))
    if rc != 0:
        fail(f"{family}: build facts failed for {shape} {kind} part {part}: "
             f"{rc}")
    out = dict(zip(FWD_INFO_KEYS, info))
    for name, f in facts.items():
        got = template_args(name, family)
        if got is not None and match(*got, out):
            label = ", ".join(map(str, got[0])) or got[1]
            return dict(kernel=f"{family}<{label}>" if label else family,
                        template=got[0], **f, **out)
    fail(f"no ptxas entry for {family} ({shape} {kind})")


# the float32 kernels' names: the three-pass TF32 kernels, or the CUDA-core
# kernels of an older checkout, so that this script times either tree
F32_FWD_FAMILIES = ("flash_fwd_tf32_kernel", "flash_fwd_f32_kernel")
F32_BWD_FAMILIES = ("flash_bwd_tf32_kernel", "flash_bwd_f32_kernel")


def f32_family(facts, families):
    """The first of ``families`` that the ptxas log names."""
    for family in families:
        if any(family in name for name in facts):
            return family
    fail(f"no ptxas entry for any of {families}")


def flash_fwd_build(log, shape, kind):
    """The forward instantiation that ``shape`` runs: its template (tile
    width, then warps and key tile and ring stages, or key tile and ring
    stages; float32: tile width, D-split warps, row groups, key tile and
    ring stages), registers and spills, dynamic shared memory, threads and
    resident blocks an SM (``kernel_build``). The wide forward (bf16,
    D > 128) adds its combine kernel's facts under ``combine``."""
    from dreamwaltz_g_tpu_torch import kernels

    fn = kernels.load("flash_attn").flash_attn_fwd_info
    facts = ptxas_facts(log)
    wide = kind == "bf16" and shape[-1] > 128
    family = f32_family(facts, F32_FWD_FAMILIES) if kind != "bf16" else \
        "flash_fwd_rows_kernel" if not wide else "flash_fwd_wide_kernel"
    build = kernel_build(
        facts, fn, shape, kind, 0, family,
        lambda args, raw, info: not args or args[:1] == [info["tile_width"]])
    if wide:
        build["combine"] = kernel_build(facts, fn, shape, kind, 1,
                                        "flash_combine_kernel",
                                        lambda *_: True)
    return build


def flash_bwd_build(log, shape, kind):
    """The backward's kernels for ``shape``, in launch order (delta, then
    the two passes; bf16 at D > 128: the dK / dV pass, then the dS K
    product; float32: both passes in one grid), each as ``kernel_build``
    gives it, from the library's ``flash_attn_bwd_info``."""
    from dreamwaltz_g_tpu_torch import kernels

    fn = kernels.load("flash_attn").flash_attn_bwd_info
    facts = ptxas_facts(log)
    bf16, D = kind == "bf16", shape[-1]
    f32 = None if bf16 else f32_family(facts, F32_BWD_FAMILIES)
    if bf16 and D > 128:
        passes = [("flash_bwd_kv_wide_kernel", lambda *_: True),
                  ("flash_bwd_dq_wide_kernel", lambda *_: True)]
    elif f32 == F32_BWD_FAMILIES[0]:
        passes = [(f32, lambda args, raw, info:
                   args[:1] == [info["tile_width"]])]
    else:
        family = f32 or "flash_bwd_bf16_kernel"

        def one_pass(kv):
            # bf16: <tile width, key tile, kv>; float32: <kv>
            return lambda args, raw, info: args[-1:] == [kv] and (
                not bf16 or args[:1] == [info["tile_width"]])

        passes = [(family, one_pass(0)), (family, one_pass(1))]
    parts = [("flash_delta_kernel",
              lambda args, raw, info: ("bfloat16" in raw) == bf16)] + passes
    return [kernel_build(facts, fn, shape, kind, part, family, match)
            for part, (family, match) in enumerate(parts)]


def launch_median(spread):
    """One call's kernels alone on the launch medians: the sum over the
    kernels it launches of each one's median launch (``kernel_device_ms``'s
    ``spread``)."""
    return sum(x["median"] for x in spread.values())


def flash_times(dev, build_log):
    """Per shape: the kernels' ms beside the plain versions', the einsum
    path's and the library call's, and the bounds. For the forward, and the
    backward where the path differentiates it, also the kernels' own device
    ms (profiler: the mean over the calls, and each kernel's launches'
    median, min and max), the rate 4 (10 backward) B H N^2 D / that mean,
    its share of the bound, and the build facts of each kernel. Each
    shape's inputs are made again from the seed (``flash_inputs``), out and
    lse by the kernel, as in ``compare_flash``."""
    import torch

    from dreamwaltz_g_tpu_torch.guidance import flash as FL

    rows = []
    with torch.no_grad():
        for shape, kind, backward in FLASH_SHAPES:
            q, k, v, g = flash_inputs(dev, shape, kind)
            out, lse = FL.flash_attn_fwd(q, k, v)
            bound = flash_bound(shape, kind, False)
            dev_ms, by_kernel, spread = kernel_device_ms(
                lambda: FL.flash_attn_fwd(q, k, v), 20, spread=True)
            row = dict(
                shape=list(shape), type=kind,
                fwd_ms=cuda_ms(lambda: FL.flash_attn_fwd(q, k, v), 10),
                fwd_kernel_ms=dev_ms, fwd_kernel_ms_by_name=by_kernel,
                fwd_kernel_launch_ms=spread,
                fwd_kernel_launch_median_ms=launch_median(spread),
                fwd_tflops=bound["ops"] / dev_ms / 1e9,
                fwd_share_of_bound=bound["bound_ms"] / dev_ms,
                build=flash_fwd_build(build_log, shape, kind),
                fwd_plain_ms=cuda_ms(
                    lambda: FL.flash_attention_plain(q, k, v), 3),
                fwd_einsum_ms=cuda_ms(lambda: einsum_attention(q, k, v), 5),
                fwd_bound=bound)
            if backward:
                bwd_bound = flash_bound(shape, kind, True)
                bwd_dev_ms, bwd_by_kernel, bwd_spread = kernel_device_ms(
                    lambda: FL.flash_attn_bwd(q, k, v, out, lse, g), 20,
                    spread=True)
                row.update(
                    bwd_ms=cuda_ms(lambda: FL.flash_attn_bwd(
                        q, k, v, out, lse, g), 10),
                    bwd_kernel_ms=bwd_dev_ms,
                    bwd_kernel_ms_by_name=bwd_by_kernel,
                    bwd_kernel_launch_ms=bwd_spread,
                    bwd_kernel_launch_median_ms=launch_median(bwd_spread),
                    bwd_tflops=bwd_bound["ops"] / bwd_dev_ms / 1e9,
                    bwd_share_of_bound=bwd_bound["bound_ms"] / bwd_dev_ms,
                    bwd_build=flash_bwd_build(build_log, shape, kind),
                    bwd_plain_ms=cuda_ms(
                        lambda: FL.flash_attention_plain_bwd(
                            q, k, v, out, lse, g), 3),
                    bwd_bound=bwd_bound)
            rows.append(row)
    for row, (shape, kind, backward) in zip(rows, FLASH_SHAPES):
        row["library"] = sdpa_times(*flash_inputs(dev, shape, kind),
                                    backward)
    return rows


def flash_domain(tokens, d):
    """The flash kernel's domain for a self-attention of ``tokens`` tokens
    and head dimension ``d``, written out here so that the expected launch
    counts do not lean on the port's own gate: at least 1024 tokens, a
    multiple of 128, and d <= 128 or a multiple of 128 up to 512."""
    return tokens >= 1024 and tokens % 128 == 0 \
        and (d <= 128 or d % 128 == 0) and d <= 512


def expected_flash_launches(gparams, latent):
    """Flash launches of one SDS step, from the models' structure: every
    self-attention of the UNet (down, mid, up) and the ControlNet (down,
    mid) whose tokens and head dimension lie in ``flash_domain``, under CFG
    in one batched pass, and the VAE encoder's mid-block attention, the only
    one differentiated. Returns (forward, backward)."""
    cfg = gparams.unet.cfg
    fwd = 0
    last = len(cfg.block_out_channels) - 1
    for i, ch in enumerate(cfg.block_out_channels):
        tokens = (latent >> i) ** 2
        d = ch // cfg.block_heads(ch)
        if not flash_domain(tokens, d):
            continue
        depth = cfg.block_depth(i)
        nets = 1 if gparams.controlnet is None else 2
        if cfg.attn_down[i]:
            fwd += cfg.layers_per_block * depth * nets        # down blocks
            fwd += (cfg.layers_per_block + 1) * depth         # up blocks
        if i == last:
            fwd += depth * nets                               # mid block
    vcfg = gparams.vae.cfg
    vae = int(flash_domain(latent * latent, vcfg.block_out_channels[-1]))
    return fwd + vae, vae


def openpose_canvas(model, observed, extrinsic, intrinsics, H, W):
    """The ControlNet's condition image in [0, 1]: the trainer's pose
    condition of the posed synthetic body (``human/condition.py``: its 128
    OpenPose keypoints projected by the training camera, occlusion-culled
    by ray casts against the mesh, drawn by ``draw_openpose_map``)."""
    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch.human.condition import ConditionRenderer
    from dreamwaltz_g_tpu_torch.human.smplx_model import smplx_forward

    with torch.no_grad():
        canvas = ConditionRenderer(model.smpl).render_pose(
            smplx_forward(model.smpl, observed), extrinsic, intrinsics, H, W)
    if canvas.shape != (H, W, 3) or int(canvas.max()) == 0:
        fail("the OpenPose canvas is empty")
    return canvas.astype(np.float32) / 255.0


def build_guidance(dev, dtype):
    """The SD1.5-size UNet + pose ControlNet + VAE in ``dtype`` with random
    weights from the seed."""
    from dreamwaltz_g_tpu_torch import tests_support

    return tests_support.sd15_guidance(SEED, device=dev, dtype=dtype)


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
    to the CPU step under the TPU's tile stop. Attention runs with
    ``FLASH_ATTENTION = "on"`` on both sides (the plain version on the CPU,
    the kernels on the card: 1,024 tokens in the tiny UNet, d = 16, and the
    tiny VAE, d = 64, which is differentiated), and the render's gradient
    passes through the clip + norm pixel-gradient hook."""
    import torch

    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import GuideConfig, RenderConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.guidance import flash as FL
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.guidance.sds import build_pixel_grad_hook
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

    S = 64      # a 32^2 latent: 1,024 tokens pass the flash gate
    rk = dict(tile_size=16, capacity=64, chunk=32, max_tiles_per_gaussian=16)
    pgc = build_pixel_grad_hook(GuideConfig(grad_rgb_clip=True,
                                            grad_rgb_norm=True))
    flash_setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = "on"
    FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
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
            sd = dataclasses.replace(sd, schedule=sd.schedule.to(d))
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
        step = make_avatar_sds_step(model, sd, S, S, pgc=pgc, device=d, **rk)
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
    TL.FLASH_ATTENTION = flash_setting
    flash_launches = [FL.flash_attn_fwd.launches, FL.flash_attn_bwd.launches]
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
         flash_attention="on", flash_launches_fwd_bwd=flash_launches,
         pixel_grad_hook="grad_rgb_clip + grad_rgb_norm",
         tol_loss=TOL_STEP_LOSS, tol_stats_flips=TOL_STATS_FLIPS)
    if min(flash_launches) <= 0:
        fail("tiny SDS step: the card run launched no flash kernel: "
             f"{flash_launches}")
    check_bwd("tiny SDS step", blend)
    if loss_rel > TOL_STEP_LOSS or loss_rel_tile > TOL_STEP_LOSS \
            or excess > 0 or acc_excess > 0 or flips > TOL_STATS_FLIPS \
            or float(a_cpu.grad_denom.sum()) <= 0 \
            or quat_noise > 1e-6 * scale:
        fail("tiny SDS step: the card disagrees with the CPU")


def train_densify(tstate, model, sds_step, gen):
    """``gs_trainer.densify`` on the full avatar after the timed steps: once
    at ``DensifyConfig()``'s defaults, then, from the same statistics, with
    ``grad_threshold`` at the median accumulated gradient of the visible
    slots and ``percent_dense`` at the median scale of the hot ones, so
    that clones and splits both happen. The second pass is held to its
    invariants (the masks recomputed here from the state before it), then
    two more SDS steps run. Returns the train state."""
    import torch

    from dreamwaltz_g_tpu_torch.gaussian.densify import (
        DensifyConfig,
        allocate_slots,
    )
    from dreamwaltz_g_tpu_torch.system.avatar import decode_opacities
    from dreamwaltz_g_tpu_torch.training.gs_trainer import densify

    def timed(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = densify(tstate, cfg, generator=gen, model=model)
        torch.cuda.synchronize()
        return new, (time.perf_counter() - t0) * 1e3

    av = tstate.avatar
    stats = [x.clone() for x in (av.grad_accum, av.grad_denom, av.max_radii)]
    alive0 = int(av.alive.sum())
    tstate, default_ms = timed(DensifyConfig())
    alive_default = int(tstate.avatar.alive.sum())
    if any(float(x.abs().max()) != 0.0 for x in (
            tstate.avatar.grad_accum, tstate.avatar.grad_denom,
            tstate.avatar.max_radii)):
        fail("densify left statistics behind")
    # the statistics of the 13 + 6 steps again, for the pass that grows
    av = tstate.avatar._replace(grad_accum=stats[0], grad_denom=stats[1],
                                max_radii=stats[2])
    tstate = tstate._replace(avatar=av)
    p = av.params
    visible = av.alive & (av.grad_denom > 0)
    avg = av.grad_accum / torch.clamp(av.grad_denom, min=1.0)
    thr = float(avg[visible].median())
    max_s = torch.exp(p.log_scales.detach()).max(-1).values
    hot = visible & (avg > thr)
    limit = float(max_s[hot].median())
    cfg = DensifyConfig(grad_threshold=thr, percent_dense=limit)
    clone, split = hot & (max_s <= limit), hot & (max_s > limit)
    prune = av.alive & (decode_opacities(model, av) < cfg.min_opacity) \
        & ~split
    dest, granted = allocate_slots(clone | split, av.alive & ~prune)
    src = torch.nonzero(granted)[:, 0]
    dst = dest[src].long()
    written = torch.zeros_like(av.alive)
    written[dst] = True
    written = written | (split & granted) | prune
    kept = {n: getattr(p, n).detach().clone()
            for n in ("quats", "lbs_weights", "positions")}
    vidx0 = av.vertex_indices.clone()
    adam = tstate.opt_state.adam
    moments = {n: {k: adam.state[getattr(p, n)][k].clone()
                   for k in ("exp_avg", "exp_avg_sq")}
               for n in ("positions", "log_scales", "quats")}
    alive1 = int(av.alive.sum())

    tstate, grow_ms = timed(cfg)
    new = tstate.avatar
    alive2 = int(new.alive.sum())
    n_prune, n_granted = int(prune.sum()), int(granted.sum())
    counts = dict(clones=int((clone & granted).sum()),
                  splits=int((split & granted).sum()), prunes=n_prune,
                  asked=int((clone | split).sum()), granted=n_granted)
    emit(phase="train_densify", alive_before=alive0,
         alive_after_defaults=alive_default, defaults_ms=default_ms,
         grad_threshold=thr, percent_dense=limit, alive_before_grow=alive1,
         alive_after_grow=alive2, grow_ms=grow_ms, capacity=new.capacity,
         **counts)
    if min(counts["clones"], counts["splits"]) <= 0:
        fail(f"densify: no clone or no split happened: {counts}")
    if alive2 != alive1 - n_prune + n_granted:
        fail(f"densify: alive {alive1} -> {alive2}, expected "
             f"{alive1 - n_prune + n_granted}")
    if not bool(new.alive[dst].all()) or bool(new.alive[prune].any()):
        fail("densify: a child's slot is not alive, or a pruned one is")
    q = new.params
    if not (torch.equal(q.quats.detach()[dst], kept["quats"][src])
            and torch.equal(q.lbs_weights.detach()[dst],
                            kept["lbs_weights"][src])
            and torch.equal(new.vertex_indices[dst], vidx0[src])):
        fail("densify: a child's quats, lbs_weights or vertex_indices "
             "differ from its parent's")
    clone_src = clone[src]
    if not torch.equal(q.positions.detach()[dst][clone_src],
                       kept["positions"][src][clone_src]):
        fail("densify: a clone is not at its parent's position")
    if any(float(x.abs().max()) != 0.0 for x in (
            new.grad_accum, new.grad_denom, new.max_radii)):
        fail("densify left statistics behind")
    for n, ms in moments.items():
        st = adam.state[getattr(q, n)]
        for k, old in ms.items():
            if float(st[k][written].abs().max()) != 0.0:
                fail(f"densify: Adam's {k} of {n} is not zero on a written "
                     "slot")
            if not torch.equal(st[k][~written], old[~written]):
                fail(f"densify: Adam's {k} of {n} changed on a slot that "
                     "was not written")
    for _ in range(2):
        tstate, metrics = sds_step(tstate)
        if not math.isfinite(float(metrics["loss"])):
            fail("non-finite SDS loss after densification")
    return tstate


# ---------------------------------------------------------------------------
# Stage 1: the text tower, the tiny and the full-width NeRF SDS step
# ---------------------------------------------------------------------------

# the prompts of the run: the view-dependent prompts of one avatar and the
# null prompt, last; the first is the text embedding of every SDS phase
CLIP_PROMPTS = ("a DSLR photo of a dancer in a red dress, full body, front "
                "view", "a DSLR photo of a dancer in a red dress, full body, "
                "side view", "a DSLR photo of a dancer in a red dress, full "
                "body, back view", "")
# the text tower in float32 on the card (no TF32) against the CPU, the same
# weights and ids: within 1e-5 of the largest output entry, the JAX
# package's tolerance for its own float32 guidance modules
TOL_CLIP_REL = 1e-5
# the full-width stage-1 step: scripts/train_w_expr.sh step 1.2 (5k steps
# at 512^2) on the NeRF defaults
NERF_H = NERF_W = 512
NERF_MAX_STEPS = 5000
NERF_WARMUP, NERF_STEPS = 3, 10
SIGMA_POINTS = 5000


def clip_text(dev):
    """The SD1.5 text tower (``CLIPTextConfig()``: 12 layers, 768 wide, 77
    tokens) with random weights from the seed and ``HashTokenizer`` ids, on
    the card and on the CPU from the same weights. Returns the card's
    embeddings of ``CLIP_PROMPTS`` (N, 77, 768), float32."""
    import copy

    import torch

    from dreamwaltz_g_tpu_torch._device import resolve_device
    from dreamwaltz_g_tpu_torch.guidance.clip_text import (
        CLIPTextConfig,
        CLIPTextModel,
        HashTokenizer,
    )

    dev = resolve_device(dev)
    cfg = CLIPTextConfig()
    cpu_model = CLIPTextModel(cfg).eval().requires_grad_(False)
    cpu_model.reset_parameters(torch.Generator().manual_seed(SEED))
    card_model = copy.deepcopy(cpu_model).to(dev)
    ids = torch.as_tensor(HashTokenizer(cfg.vocab_size, cfg.max_length)(
        list(CLIP_PROMPTS)))
    with torch.no_grad():
        want = cpu_model(ids)
        got = card_model(ids.to(dev))
        ms = cuda_ms(lambda: card_model(ids.to(dev)), 10)
    err = float((got.cpu() - want).abs().max())
    rel = err / float(want.abs().max())
    emit(phase="clip_text", config=cfg._asdict(), prompts=len(CLIP_PROMPTS),
         shape=list(got.shape), max_abs_err=err, max_err_of_max=rel,
         tol_of_max=TOL_CLIP_REL, ms_per_call=ms,
         params=sum(p.numel() for p in card_model.parameters()))
    if not bool(torch.isfinite(got).all()) or rel > TOL_CLIP_REL:
        fail(f"text tower: card vs CPU {rel} of the largest entry")
    return got


def nerf_groups_snapshot(model):
    """Copies of one tensor of each optimizer group of the NeRF."""
    from dreamwaltz_g_tpu_torch.training.optim import nerf_param_groups

    return {label: [p.detach().clone() for p in params]
            for label, params in nerf_param_groups(model).items()}


def small_nerf_train(dev):
    """One stage-1 SDS step of a tiny NeRF (a 16^2 x 8 triplane, a 16^3
    grid, 16 samples a ray, 8 compacted) with the tiny guidance and its
    ControlNet at 64^2, from the same field, grid, weights and draws: on
    the CPU with the plain versions and on the card with the kernels.
    Attention runs with ``FLASH_ATTENTION = "on"`` (1,024 tokens in the tiny
    UNet, d = 16, and the tiny VAE, d = 64, which is differentiated); the
    rays march in checkpointed chunks of 1,000 (4,096 rays); sigma
    guidance, volume sparsity, ray sparsity and the background MLP are on.
    The loss within 1e-3 relative, every gradient in ``grad_error``'s
    envelope."""
    import copy

    import torch

    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.guidance import flash as FL
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.nerf.renderer import (
        init_occupancy,
        update_occupancy,
    )
    from dreamwaltz_g_tpu_torch.training import nerf_trainer as NT
    from dreamwaltz_g_tpu_torch.training.losses import (
        make_sigma_guidance_points,
        volume_sparsity_draws,
    )
    from dreamwaltz_g_tpu_torch.training.optim import (
        build_nerf_optimizer,
        nerf_param_groups,
    )

    S, chunk, steps = 64, 1000, 16
    cfg = NeRFConfig(triplane_resolution=16, triplane_dim=8, grid_size=16,
                     num_steps=steps, compact_steps=8, lambda_opacity=1e-2)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    field = build_nerf(cfg, generator=gen, device=cpu)
    grid = update_occupancy(init_occupancy(cfg.grid_size, device=cpu), field,
                            generator=gen)
    body = make_synthetic_model(num_vertices=120, num_joints=6, seed=SEED,
                                device=cpu)
    sigma_pts = make_sigma_guidance_points(body.v_template, body.faces, 256,
                                           generator=gen)
    txt = torch.randn((1, 4, 32), generator=gen)
    cond = torch.rand((1, S, S, 3), generator=gen)
    draws = dict(jitter=torch.rand(NT.jitter_shape(S, S, chunk, steps),
                                   generator=gen),
                 noise=torch.randn((1, S // 2, S // 2, 4), generator=gen),
                 vs_draws=volume_sparsity_draws(gen, cfg.bound,
                                                n_surface=S * S))
    sd, gp = tests_support.tiny_guidance(SEED, with_controlnet=True,
                                         latent_size=S // 2, device=cpu)
    flash_setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = "on"
    FL.flash_attn_fwd.launches = FL.flash_attn_bwd.launches = 0
    runs = {}
    try:
        for label, d in (("cpu", cpu), ("card", dev)):
            model = copy.deepcopy(field).to(d)
            tx = build_nerf_optimizer(cfg, NERF_MAX_STEPS)
            ts = NT.init_train_state(model, tx)
            step = NT.make_nerf_sds_step(
                model, dataclasses.replace(sd, schedule=sd.schedule.to(d)),
                S, S, cfg, num_steps=steps,
                max_iteration=NERF_MAX_STEPS, bg_mode="nerf",
                ray_chunk=chunk, device=d)
            cam = make_camera_batch(2.5, 30.0, 80.0, 50.0, S, S, device=d)
            new, metrics = step(
                ts, to_device(grid, d), to_device(gp, d), cam.c2w[0],
                cam.intrinsics[0], torch.full((3,), 0.5, device=d),
                txt.to(d), torch.zeros_like(txt).to(d),
                torch.tensor([TIMESTEP], device=d), cond_image=cond.to(d),
                sigma_pts=to_device(sigma_pts, d), use_sigma=True,
                **to_device(draws, d))
            grads = {k: [torch.zeros(p.shape) if p.grad is None
                         else p.grad.detach().cpu() for p in ps]
                     for k, ps in nerf_param_groups(model).items()}
            runs[label] = ({k: float(v) for k, v in metrics.items()}, grads)
    finally:
        TL.FLASH_ATTENTION = flash_setting
    flash_launches = [FL.flash_attn_fwd.launches, FL.flash_attn_bwd.launches]
    (m_cpu, g_cpu), (m_gpu, g_gpu) = runs["cpu"], runs["card"]
    loss_rel = abs(m_gpu["loss"] - m_cpu["loss"]) / max(abs(m_cpu["loss"]),
                                                         1e-30)
    e_abs, e_rel, excess = grad_error(
        [t for k in g_cpu for t in g_gpu[k]],
        [t for k in g_cpu for t in g_cpu[k]])
    emit(phase="small_nerf_train", metrics_cpu=m_cpu, metrics_card=m_gpu,
         loss_rel_err=loss_rel, grad_max_abs_err=e_abs,
         grad_max_err_of_max=e_rel, grad_excess_over_tol=excess,
         grad_err_of_max_by_group={k: grad_error(g_gpu[k], g_cpu[k])[1]
                                   for k in g_cpu},
         occupied_share=float(grid.occupied.float().mean()),
         flash_attention="on", flash_launches_fwd_bwd=flash_launches,
         ray_chunk=chunk, rays=S * S, tol_loss=TOL_STEP_LOSS)
    if min(flash_launches) <= 0:
        fail(f"tiny NeRF step: the card launched no flash kernel: "
             f"{flash_launches}")
    if loss_rel > TOL_STEP_LOSS or excess > 0 or not all(
            math.isfinite(v) for v in m_gpu.values()):
        fail("tiny NeRF step: the card disagrees with the CPU")
    if min(float(g.abs().max()) for gs in g_cpu.values() for g in gs[:1]) \
            <= 0.0:
        fail("tiny NeRF step: a parameter group took no gradient")


# record_function ranges of make_nerf_sds_step and its callees -> stage;
# the render's ranges recur once a ray chunk, and again inside the backward
# when the checkpointed chunks are recomputed ("backward_recompute")
NERF_STAGE_RANGES = (("nerf.rays_occupancy", "rays_occupancy"),
                     ("nerf.march_field", "march_field"),
                     ("nerf.composite", "composite"),
                     ("nerf_step.regularizers", "regularizers"),
                     ("nerf_step.guidance", "sds_loss"),
                     ("sds.encode_images", "vae_encode"),
                     ("sds.latent_gradients", "controlnet_unet_cfg"),
                     ("nerf_step.backward", "backward"),
                     ("nerf_step.optimizer", "optimizer"))


# record_function ranges of make_dmtet_sds_step and of make_vanilla_sds_step
DMTET_STAGE_RANGES = (("dmtet_step.extract", "extract"),
                      ("dmtet_step.albedo_decode", "albedo_decode"),
                      ("dmtet_step.render", "shade_splat_project"),
                      ("rasterize.bin", "bin"),
                      ("rasterize.blend", "blend_fwd_b1"),
                      ("dmtet_step.guidance", "sds_loss"),
                      ("sds.encode_images", "vae_encode"),
                      ("sds.latent_gradients", "controlnet_unet_cfg"),
                      ("dmtet_step.regularizers", "regularizers"),
                      ("dmtet_step.backward", "backward"),
                      ("dmtet_step.optimizer", "optimizer"))
VANILLA_STAGE_RANGES = (("vanilla_step.render", "animate_project"),
                        ("rasterize.bin", "bin"),
                        ("rasterize.blend", "blend_fwd_b1"),
                        ("vanilla_step.guidance", "sds_loss"),
                        ("sds.encode_images", "vae_encode"),
                        ("sds.latent_gradients", "controlnet_unet_cfg"),
                        ("vanilla_step.backward", "backward"),
                        ("vanilla_step.optimizer_stats", "optimizer_stats"))


def nerf_train(dev, card, guidance, gparams, body, embeds, kernel_fns):
    """The stage-1 training path at the full width of step 1.2 of
    ``scripts/train_w_expr.sh``: a 512^2 render of ``NeRFConfig()``'s field
    (a 256^2 x 32 triplane, a 128^3 grid, 96 samples a ray of which 32
    compacted, rays marched in checkpointed chunks of 4,096, bound 2, gray
    background; the background MLP built, as the trainer builds it, and
    unreached), ``build_nerf_optimizer(NeRFConfig(), 5000)``, sigma
    guidance on 5,000 points of the SMPL-X-sized synthetic body a step,
    the volume-sparsity prior at 3e-3, and the SD1.5-size bf16 guidance
    under ``FLASH_ATTENTION = "auto"`` with the scheduler's timesteps and
    guidance scales and the text tower's embeddings. Counts set to 0, then
    3 warm-up and 10 timed steps with ``maybe_update_occupancy`` before
    each (it refreshes at step 0) and one refresh forced between the two
    runs; counts read. Then one profiled step (phase ``nerf_profile``).
    Returns the flash launches of the 13 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dreamwaltz_g_tpu_torch import kernels
    from dreamwaltz_g_tpu_torch.configs import GuideConfig, NeRFConfig
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.guidance.time_prior import (
        TimePrioritizedScheduler,
    )
    from dreamwaltz_g_tpu_torch.human.smplx_model import (
        default_params,
        smplx_forward,
    )
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.nerf.renderer import (
        init_occupancy,
        update_occupancy,
    )
    from dreamwaltz_g_tpu_torch.training import nerf_trainer as NT
    from dreamwaltz_g_tpu_torch.training.losses import (
        make_sigma_guidance_points,
    )
    from dreamwaltz_g_tpu_torch.training.optim import build_nerf_optimizer

    if TL.FLASH_ATTENTION != "auto":
        fail(f"FLASH_ATTENTION is {TL.FLASH_ATTENTION!r}, not its default")
    cfg = NeRFConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    field = build_nerf(cfg, with_background=cfg.bg_mode == "nerf"
                       or cfg.bg_radius > 0, generator=gen, device=dev)
    tstate = NT.init_train_state(field, build_nerf_optimizer(
        cfg, NERF_MAX_STEPS))
    step = NT.make_nerf_sds_step(
        field, guidance, NERF_H, NERF_W, cfg, num_steps=cfg.num_steps,
        max_iteration=NERF_MAX_STEPS, bg_mode="color",
        ray_chunk=cfg.max_ray_batch, device=dev)
    grid = init_occupancy(cfg.grid_size, device=dev)
    grid0 = grid.occupied.clone()
    n = NERF_WARMUP + NERF_STEPS + 1
    cams = make_camera_batch([3.0] * n, [360.0 * i / n for i in range(n)],
                             [80.0] * n, [45.0] * n, NERF_H, NERF_W,
                             at_vector=((0.0, 0.7, 0.0),), device=dev)
    smpl = body.smpl
    obs = default_params(smpl, 1)
    with torch.no_grad():
        verts = smplx_forward(smpl, obs).vertices[0]
    dt = gparams.unet.conv_in.weight.dtype
    canvases = [torch.as_tensor(openpose_canvas(
        body, obs, cams.extrinsic[i], cams.intrinsics[i], NERF_H, NERF_W),
        device=dev)[None].to(dt) for i in range(n)]
    txt, unc = embeds[:1].to(dt), embeds[-1:].to(dt)
    bg = torch.full((3,), 0.5, device=dev)
    sched = TimePrioritizedScheduler(GuideConfig(), seed=SEED)
    timesteps, scales, occupied = [], [], []

    def run_step(tstate, grid):
        """The trainer's stage-1 iteration: the occupancy cadence, the
        step's sigma points, the scheduler, the step."""
        i = tstate.step
        grid = NT.maybe_update_occupancy(
            tstate, grid, field, interval=cfg.update_extra_interval,
            density_thresh=cfg.density_thresh, generator=gen)
        pts = make_sigma_guidance_points(verts, smpl.faces, SIGMA_POINTS,
                                         generator=gen)
        t = sched.get_timestep(1, i + 1, NERF_MAX_STEPS)
        gs = sched.get_guidance_scale(i + 1, NERF_MAX_STEPS)
        timesteps.append(int(t[0]))
        scales.append(gs)
        tstate, metrics = step(
            tstate, grid, gparams, cams.c2w[i], cams.intrinsics[i], bg,
            txt, unc, torch.as_tensor(t, device=dev), generator=gen,
            cond_image=canvases[i], guidance_scale=gs, sigma_pts=pts,
            use_sigma=True)
        return tstate, grid, metrics

    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_calls = []

    def counted_sdpa(*a, **k):
        library_calls.append(1)
        return sdpa(*a, **k)

    before = nerf_groups_snapshot(field)
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.nn.functional.scaled_dot_product_attention = counted_sdpa
    per_step, losses, refresh_ms = [], [], None
    start_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
    try:
        torch.cuda.reset_peak_memory_stats()
        for i in range(NERF_WARMUP + NERF_STEPS):
            if i == NERF_WARMUP:
                # the refresh the trainer runs every 16 steps, forced here
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grid = update_occupancy(grid, field, generator=gen,
                                        density_thresh=cfg.density_thresh)
                torch.cuda.synchronize()
                refresh_ms = (time.perf_counter() - t0) * 1e3
                start_ev.record()
            n0 = [kernel_fns[k].launches for k in ("flash_attn_fwd",
                                                   "flash_attn_bwd")]
            tstate, grid, metrics = run_step(tstate, grid)
            per_step.append([kernel_fns[k].launches - n0[j] for j, k in
                             enumerate(("flash_attn_fwd", "flash_attn_bwd"))])
            losses.append({k: float(v) for k, v in metrics.items()})
            occupied.append(int(grid.occupied.sum()))
        end_ev.record()
        torch.cuda.synchronize()
    finally:
        torch.nn.functional.scaled_dot_product_attention = sdpa
    step_ms = start_ev.elapsed_time(end_ev) / NERF_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    after = nerf_groups_snapshot(field)
    moved = {k: max(float((a - b).abs().max()) for a, b in
                    zip(after[k], before[k])) for k in before}
    expected = list(expected_flash_launches(gparams, guidance.latent_size))
    emit(phase="nerf_train", steps=[NERF_WARMUP, NERF_STEPS],
         resolution=[NERF_H, NERF_W], config=dataclasses.asdict(cfg),
         sds_step_ms=step_ms, sds_it_per_s=1e3 / step_ms,
         peak_mem_gib=peak_gib, launches=launches,
         flash_launches_per_step=per_step,
         flash_expected_per_step=expected,
         library_attention_calls=len(library_calls), loss=losses,
         moved=moved, timesteps=timesteps, guidance_scales=scales,
         occupied_cells=occupied, grid_cells=cfg.grid_size ** 3,
         occupancy_refresh_ms=refresh_ms, sigma_points=SIGMA_POINTS,
         flash_attention=TL.FLASH_ATTENTION, **card)
    if any(s != expected for s in per_step):
        fail(f"stage-1 step: flash launched {per_step} a step, expected "
             f"{expected} from the models' structure")
    if any(launches[k] for k in launches if k.startswith("blend")):
        fail(f"stage-1 step: a blend kernel launched: {launches}")
    if library_calls:
        fail("stage-1 step: a library attention ran")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        fail("stage-1 step: a non-finite loss")
    if min(moved["encoder"], moved["mlp"]) <= 0.0:
        fail(f"stage-1 step: a parameter group the loss reaches did not "
             f"move: {moved}")
    if torch.equal(grid.occupied, grid0) or len(set(occupied)) < 2:
        fail(f"stage-1 step: the occupancy grid did not change: {occupied}")

    # -- one profiled step: device ms by the step's own ranges ------------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tstate, grid, metrics = run_step(tstate, grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = device_events(prof)
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.device_time_total)[:15]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = kernels.BUILD_DIR / "nerf_step_trace.json"
    prof.export_chrome_trace(str(trace))
    stage_dev, stage_host, named = stage_times(
        trace, NERF_STAGE_RANGES, recompute_in="nerf_step.backward")
    emit(phase="nerf_profile", steps=1, wall_ms=wall_ms,
         loss=float(metrics["loss"]),
         device_busy_ms=busy_ms if on_card else None,
         device_busy_share=busy_ms / wall_ms if on_card else None,
         kernel_launches=sum(e.count for e in on_card),
         stage_device_ms=stage_dev, stage_host_ms=stage_host,
         flash_fwd_kernels_ms=named["flash_fwd"] + named["flash_combine"],
         flash_bwd_kernels_ms=named["flash_bwd"] + named["flash_delta"],
         index_backward_kernels_ms=named["indexing_backward"],
         top_kernels=[[e.key[:80], e.device_time_total / 1e3, e.count]
                      for e in top], **card)
    return [launches["flash_attn_fwd"], launches["flash_attn_bwd"]]


# -- the two-stage run through the port's CLI (phase cli_two_stage) --------

CLI_TEXT = "a DSLR photo of a dancer in a red dress"
# steps of each run of scripts/train_w_expr.sh driven here: the first is a
# warm-up, the last is profiled, the ones between are timed
CLI_STEPS = {"1.2": 4, "2.1": 4, "2.3": 3}
CLI_PARTS = "hands,face"
# the trainer's host-side ranges around its batch build and its step
CLI_RANGES = (("trainer.batch", "batch_build"),
              ("trainer.condition", "condition_render"),
              ("trainer.step", "step"))
CLI_SEQUENTIAL_STEPS = 2
TEMPLATE_FIT_STEPS = 300
TEMPLATE_SIGMA_IN, TEMPLATE_SIGMA_OUT = 50.0, 0.05
TEMPLATE_SHELL = 0.05   # a point within this of a vertex lies in the body
# the inference path (phase cli_inference): the synthetic demo motion, in
# Demo's layout of 265 values a frame, each a slow sine of this amplitude
DEMO_FRAMES = 240
DEMO_AMPLITUDE = 0.3    # rad
EVAL_RUN_STEPS = 2      # the short runs with a snapshot and an evaluation
# the reenact sequence: Motion-X-ReEnact's layout, a 1280 x 720 video
REENACT_SEQ = "dance_0001"
REENACT_FRAMES = 30
REENACT_H, REENACT_W = 720, 1280
REENACT_FOCAL = 900.0


def write_body(path, seg_path):
    """The SMPL-X-sized synthetic body in ``load_smplx_npz``'s layout
    (SMPL-X's 300 shape + 100 expression directions, the first 10 of each
    random), with 51 landmark triangles and barycentric weights, and a
    vertex segmentation whose hand and head labels cover 1,000 and 500
    whole triangles."""
    import numpy as np

    from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model

    smpl = make_synthetic_model(num_vertices=10_475, num_joints=55,
                                num_betas=10, num_expr=10, seed=SEED,
                                device="cpu")
    V, J = smpl.num_vertices, smpl.num_joints
    shapedirs = np.zeros((V, 3, 400), np.float32)
    shapedirs[..., :10] = smpl.shapedirs.numpy()
    shapedirs[..., 300:310] = smpl.expr_dirs.numpy()
    faces = np.asarray(smpl.faces, np.int64)
    rng = np.random.default_rng(SEED)
    np.savez(path, v_template=smpl.v_template.numpy(), shapedirs=shapedirs,
             posedirs=smpl.posedirs.numpy(),
             J_regressor=smpl.J_regressor.numpy(),
             weights=smpl.lbs_weights.numpy(),
             kintree_table=np.stack([np.asarray(smpl.parents, np.int64),
                                     np.arange(J)]),
             f=faces, lmk_faces_idx=rng.choice(len(faces), 51,
                                               replace=False),
             lmk_bary_coords=rng.dirichlet(np.ones(3), 51).astype(
                 np.float32))
    order = rng.permutation(len(faces))

    def verts(ids):
        return sorted(set(faces[ids].reshape(-1).tolist()))

    with open(seg_path, "w") as f:
        json.dump({"leftHand": verts(order[:500]),
                   "rightHand": verts(order[500:1000]),
                   "head": verts(order[1000:1500])}, f)


def write_guidance(root, dev):
    """The SD1.5 card in diffusers layout with random weights from the seed:
    the UNet, the pose ControlNet, the VAE and the CLIP text tower as
    float16 ``torch.save`` files, and a BPE vocabulary of the 256 byte
    symbols, their word ends and the two special tokens."""
    import torch

    from dreamwaltz_g_tpu_torch import tests_support
    from dreamwaltz_g_tpu_torch.guidance.clip_text import (
        CLIPTextConfig,
        CLIPTextModel,
        _bytes_to_unicode,
    )
    from dreamwaltz_g_tpu_torch.guidance.layers import build

    _, gp = tests_support.sd15_guidance(SEED, device=dev, dtype=torch.float16)
    clip = build(lambda: CLIPTextModel(CLIPTextConfig()), dev, torch.float16)
    clip.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    for name, module, file in (
            ("unet", gp.unet, "diffusion_pytorch_model.bin"),
            ("controlnet_pose", gp.controlnet, "diffusion_pytorch_model.bin"),
            ("vae", gp.vae, "diffusion_pytorch_model.bin"),
            ("text_encoder", clip, "pytorch_model.bin")):
        (root / name).mkdir(parents=True)
        torch.save({k: v.cpu() for k, v in module.state_dict().items()},
                   root / name / file)
    symbols = list(_bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols] \
        + ["<|startoftext|>", "<|endoftext|>"]
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(vocab)}))
    (root / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")


def fit_template(npz, ckpt_dir, dev, cfg=None):
    """The stand-in for step 1.1's output (itself warm-started from the
    human-template NeRF): the field of ``cfg`` (``NeRFConfig()`` when None)
    fitted to the canonical body, density 50 within ``TEMPLATE_SHELL`` of a
    vertex and 0.05 elsewhere (a log-density regression on 400k fixed
    points, half near the body), saved as a port checkpoint. Returns its
    fit numbers."""
    import torch

    from dreamwaltz_g_tpu_torch.configs import NeRFConfig
    from dreamwaltz_g_tpu_torch.human.poses import canonical_params
    from dreamwaltz_g_tpu_torch.human.smplx_model import (
        load_smplx_npz,
        smplx_forward,
    )
    from dreamwaltz_g_tpu_torch.nerf.network import build_nerf
    from dreamwaltz_g_tpu_torch.ops.mesh import knn
    from dreamwaltz_g_tpu_torch.training.checkpoint import save_pytree

    smpl = load_smplx_npz(npz, device=dev)
    with torch.no_grad():
        verts = smplx_forward(smpl, canonical_params(smpl)).vertices[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cfg = cfg or NeRFConfig()
    field = build_nerf(cfg, generator=gen, device=dev)
    n = 200_000
    near = verts[torch.randint(0, verts.shape[0], (n,), generator=gen,
                               device=dev)] \
        + 0.04 * torch.randn((n, 3), generator=gen, device=dev)
    far = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * cfg.bound
    pts = torch.cat([near, far])
    d2, _ = knn(pts, verts, 1, chunk=2048)
    inside = d2[:, 0] < TEMPLATE_SHELL ** 2
    target = torch.where(inside, math.log(TEMPLATE_SIGMA_IN),
                         math.log(TEMPLATE_SIGMA_OUT))
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    t0 = time.perf_counter()
    for _ in range(TEMPLATE_FIT_STEPS):
        i = torch.randint(0, pts.shape[0], (65_536,), generator=gen,
                          device=dev)
        sigma, _ = field.density(pts[i])
        loss = torch.mean((torch.log(sigma + 1e-3) - target[i]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        sigma = torch.cat([field.density(p)[0]
                           for p in torch.split(pts, 65_536)])
    torch.cuda.synchronize()
    save_pytree(ckpt_dir, {"params": field.state_dict(), "opt_state": {},
                           "step": 0})
    return {"fit_steps": TEMPLATE_FIT_STEPS,
            "fit_s": time.perf_counter() - t0, "loss": float(loss.detach()),
            "inside_points": int(inside.sum()),
            "inside_above_10": float((sigma[inside] > 10).float().mean()),
            "outside_above_10": float((sigma[~inside] > 10).float().mean())}


def cli_launches_per_step(stage2):
    """Each kernel's launches a trainer step: flash as the SD1.5-size
    stack's structure gives, the table blends once a step in stage 2."""
    return {"flash_attn_fwd": FLASH_PER_STEP[0],
            "flash_attn_bwd": FLASH_PER_STEP[1],
            "blend_train_fwd": int(stage2), "blend_train_bwd": int(stage2),
            "blend_sorted": 0, "blend_tiles_eval": 0}


def cli_run(label, argv, n_steps, kernel_fns, check=None, prefetch=True,
            stage_ranges=None):
    """One run of the port's CLI as ``dreamwaltz_g_tpu_torch.main.run``
    makes it: ``Trainer(parse_args(argv))``, ``check(trainer)`` when given,
    then ``train``, with the counts set to 0 just before the trainer is
    built and read just after training, and the trainer's timing spans on
    (``utils/timing.py``: the export, the avatar's initialisation, the LBS
    smoothing). ``train``'s ``on_step`` records a CUDA event at the end of
    each step's update: s/step runs from step 1's end to the last
    unprofiled step's. With ``prefetch`` the last step is profiled
    (torch.profiler's schedule, stepped by ``on_step``), its launches
    counted apart, and then one batch build is profiled on the main
    thread; ``prefetch=False`` trains with each batch built on the main
    thread before its step and profiles nothing. ``stage_ranges``: the
    step's own ranges (the stage's default step's when None). Returns its
    fields."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from dreamwaltz_g_tpu_torch import kernels
    from dreamwaltz_g_tpu_torch.configs import parse_args
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer
    from dreamwaltz_g_tpu_torch.utils import timing

    stage = argv[argv.index("--stage") + 1]
    if stage_ranges is None:
        stage_ranges = NERF_STAGE_RANGES if stage == "nerf" else STAGE_RANGES
    ranges = CLI_RANGES + stage_ranges
    line = {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = kernels.BUILD_DIR / f"cli_{label}_trace.json"

    def profile_line(prof, wall):
        prof.export_chrome_trace(str(trace))
        dev_ms, host_ms, named = stage_times(
            trace, ranges, recompute_in="nerf_step.backward"
            if stage_ranges is NERF_STAGE_RANGES else None)
        busy = sum(e.device_time_total for e in device_events(prof)) / 1e3
        return dict(wall_ms=wall, device_busy_ms=busy,
                    device_busy_share=busy / wall, stage_device_ms=dev_ms,
                    stage_host_ms=host_ms, named_kernels_ms=named)

    events, window = {}, {}

    def on_step(k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[k] = ev
        if not prefetch:
            return
        if k == n_steps - 1:       # the profiled step starts
            torch.cuda.synchronize()
            window["before"] = {name: fn.launches
                                for name, fn in kernel_fns.items()}
        elif k == n_steps:
            torch.cuda.synchronize()
            window["wall"] = (time.perf_counter() - window["t0"]) * 1e3
            window["launches"] = {
                name: fn.launches - window["before"][name]
                for name, fn in kernel_fns.items()}
        prof.step()
        window["t0"] = time.perf_counter()

    timing.enabled = True
    timing.records.clear()
    try:
        for fn in kernel_fns.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(parse_args(argv))
        line["build_s"] = time.perf_counter() - t0
        if check is not None:
            check(trainer)
        # the last step profiled: the schedule's steps are on_step's
        profiler = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=n_steps - 1, warmup=0, active=1,
                              repeat=1),
            on_trace_ready=lambda p: window.update(
                line=profile_line(p, window["wall"]))) \
            if prefetch else contextlib.nullcontext()
        t0 = time.perf_counter()
        with profiler as prof:
            trainer.train(on_step=on_step, prefetch=prefetch)
        torch.cuda.synchronize()
        line["train_s"] = time.perf_counter() - t0
        line["launches"] = {name: fn.launches
                            for name, fn in kernel_fns.items()}
        line["spans_ms"] = {name: timing.times(name)
                            for name in timing.records}
    finally:
        timing.enabled = False
    line["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    line["steps"] = trainer.train_step
    line["loss"] = list(trainer.losses)
    last = n_steps - 1 if prefetch else n_steps
    line["s_per_step"] = events[1].elapsed_time(events[last]) / 1e3 \
        / (last - 1)
    if prefetch:
        line["profiled_step"] = dict(step=n_steps,
                                     launches=window["launches"],
                                     **window["line"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer._train_batch(trainer.train_step)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        line["batch_build_profile"] = profile_line(prof, wall)
    return line


def cli_two_stage(dev, card, kernel_fns, times_ms):
    """Phase ``cli_two_stage``: ``scripts/train_w_expr.sh`` steps 1.2, 2.1
    and 2.3 through the port's CLI in-process, at full width on the
    synthetic SMPL-X-sized body with the SD1.5-size card's random weights
    in diffusers layout (both written to a temporary directory the phase
    deletes; step 1.2 warm-starts from a field fitted to the body, standing
    in for step 1.1's output), each run with its script arguments plus
    ``--optim.iters N`` and a save interval of N, then a short run of the
    same step without the prefetch worker (its own experiment directory,
    ``CLI_SEQUENTIAL_STEPS`` + 1 steps). Checks: finite losses,
    flash (15, 1) a step in every run and in its profiled step, the table
    blends (0, 0) in stage 1 and (1, 1) a step in stage 2, the stage-1
    planes carried into the avatar with a difference of 0, the warm start
    of step 2.3 equal to step 2.1's last checkpoint to every bit. Returns
    the runs' launches and, from phase ``cli_inference`` (run after these
    checks in the same directory), its runs' launches, and those of the
    phases ``cli_modes`` and ``cli_geometry`` after it."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from dreamwaltz_g_tpu_torch.configs import paths
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree

    tmp = Path(tempfile.mkdtemp(prefix="cli_two_stage_"))
    old_paths = (paths.HUMAN_TEMPLATES, paths.GUIDANCE_WEIGHTS,
                 paths.DEMO_MOTIONS, paths.MOTIONX_REENACT_ROOT)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        t0 = time.perf_counter()
        human = tmp / "human_templates"
        (human / "smplx").mkdir(parents=True)
        npz = human / "smplx" / "SMPLX_NEUTRAL_2020.npz"
        write_body(npz, human / "smplx" / "smplx_vert_segmentation.json")
        write_guidance(tmp / "guidance", dev)
        template = human / "instant-ngp" / "adult_neutral"
        fit = fit_template(str(npz), template / "checkpoints"
                           / "step_00000000", dev)
        torch.cuda.empty_cache()
        assets_s = time.perf_counter() - t0
        paths.HUMAN_TEMPLATES = str(human)
        paths.GUIDANCE_WEIGHTS = str(tmp / "guidance")
        emit(phase="cli_assets", seconds=assets_s,
             guidance_bytes=sum(f.stat().st_size for f in
                                (tmp / "guidance").rglob("*")
                                if f.is_file()),
             template=fit, **card)
        if fit["inside_above_10"] <= 0.5:
            fail(f"the template field is not dense in the body: {fit}")

        out = tmp / "outputs"
        exp = {k: f"dancer/{k}" for k in CLI_STEPS}

        def argv(step, *extra, n=None, name=None):
            n = n or CLI_STEPS[step]
            return ["--guide.text", CLI_TEXT, "--log.exp_root", str(out),
                    "--log.exp_name", name or exp[step],
                    "--predefined_body_parts", CLI_PARTS,
                    "--optim.iters", str(n), "--log.save_interval", str(n),
                    "--log.snapshot_interval", "0",
                    "--log.evaluate_interval", "0"] + list(extra)

        args = {
            "1.2": ("--optim.ckpt", str(template), "--stage", "nerf",
                    "--nerf.bg_mode", "gray", "--prompt.scene", "canonical",
                    "--data.train_w", "512", "--data.train_h", "512",
                    "--use_sigma_guidance", "true"),
            "2.1": ("--render.from_nerf", str(out / exp["1.2"]),
                    "--stage", "gs", "--prompt.scene", "canonical",
                    "--render.learn_hand_betas", "true",
                    "--render.lbs_weight_smooth", "true",
                    "--render.bg_color", "(0.5,0.5,0.5)"),
            "2.3": ("--optim.ckpt", str(out / exp["2.1"]), "--stage", "gs",
                    "--prompt.scene", "random-body,hand,expr",
                    "--render.bg_color", "(0.5,0.5,0.5)")}
        carried, warm = {}, {}

        # 2.1: the avatar seeded from 1.2's field
        def check_planes(tr):
            stage1 = load_pytree(resolve_ckpt_path(out / exp["1.2"]),
                                 map_location=dev)["params"]["planes"]
            carried["planes_max_abs_diff"] = float(
                (tr.state.avatar.params.encoder.planes.detach() - stage1)
                .abs().max())
            carried["seeded_from_cloud"] = tr._nerf_guidance is not None
            carried["mesh_parts"] = {
                k: len(p.points_to_triangles)
                for k, p in tr.avatar_model.mesh_parts.items()}
            carried["alive"] = int(tr.state.avatar.alive.sum())
            carried.update(tr.export_stats)

        # 2.3: random poses, warm-started from 2.1's last checkpoint
        def check_warm_start(tr):
            want = load_pytree(resolve_ckpt_path(out / exp["2.1"]),
                               map_location=dev)["params"]
            got = avatar_tree(tr.state.avatar, tr.avatar_model)
            diff = []

            def walk(g, w, name):
                if isinstance(g, dict):
                    for k in g:
                        walk(g[k], w[k], f"{name}.{k}")
                elif not torch.equal(g, w):
                    diff.append(name)

            walk(got, want, "avatar")
            warm["differs"] = diff
            warm["tensors"] = len(_leaf_names(got))

        checks = {"2.1": check_planes, "2.3": check_warm_start}
        runs, sequential = {}, {}
        for step in CLI_STEPS:
            runs[step] = cli_run(step, argv(step, *args[step]),
                                 CLI_STEPS[step], kernel_fns,
                                 check=checks.get(step))
            free()
            # the same step's own short run without the prefetch worker
            n = CLI_SEQUENTIAL_STEPS + 1
            sequential[step] = cli_run(
                f"{step}-sequential", argv(step, *args[step], n=n,
                                           name=exp[step] + "-sequential"),
                n, kernel_fns, prefetch=False)
            free()
            runs[step]["s_per_step_no_prefetch"] = \
                sequential[step]["s_per_step"]
        spans = runs["2.1"]["spans_ms"]
        handoff = dict(carried, export_ms=spans["trainer.export"],
                       init_avatar_state_ms=spans[
                           "trainer.init_avatar_state"],
                       lbs_smooth_ms=spans["avatar.lbs_smooth"])
        check_two_stage(card, runs, handoff, warm, sequential)
        inference = cli_inference(dev, card, kernel_fns, tmp, argv, args,
                                  exp, times_ms)
        free()
        modes = cli_modes(dev, card, kernel_fns, tmp, argv, args, exp)
        free()
        geometry = cli_geometry(dev, card, kernel_fns, tmp, argv, args, exp)
        free()
        scene = cli_scene(dev, card, kernel_fns, tmp, argv, args, exp)
    finally:
        (paths.HUMAN_TEMPLATES, paths.GUIDANCE_WEIGHTS, paths.DEMO_MOTIONS,
         paths.MOTIONX_REENACT_ROOT) = old_paths
        shutil.rmtree(tmp, ignore_errors=True)
    return {step: line["launches"] for step, line in runs.items()}, \
        inference, modes, geometry, scene


def check_two_stage(card, runs, handoff, warm, sequential):
    """Emit phase ``cli_two_stage``'s line and hold its checks."""
    emit(phase="cli_two_stage", runs=runs, handoff=handoff,
         warm_start=warm, sequential=sequential, **card)
    for step, line in list(runs.items()) + [
            (f"{k}-sequential", v) for k, v in sequential.items()]:
        n = line["steps"]
        want = CLI_STEPS[step] if step in CLI_STEPS \
            else CLI_SEQUENTIAL_STEPS + 1
        stage2 = step.startswith("2")
        if n != want or len(line["loss"]) != n \
                or not all(math.isfinite(x) for x in line["loss"]):
            fail(f"cli {step}: {line['steps']} steps, losses "
                 f"{line['loss']}")
        profiled = line.get("profiled_step", {}).get("launches")
        for name, k in cli_launches_per_step(stage2).items():
            if line["launches"][name] != k * n \
                    or (profiled is not None and profiled[name] != k):
                fail(f"cli {step}: {name} launched "
                     f"{line['launches'][name]} times in {n} steps "
                     f"({profiled and profiled[name]} in the profiled "
                     f"one), expected {k} a step")
    if not handoff["seeded_from_cloud"] or handoff["points"] <= 0:
        fail(f"cli 2.1: not seeded from the exported cloud: {handoff}")
    if handoff["planes_max_abs_diff"] != 0.0:
        fail("cli 2.1: the stage-1 planes did not arrive verbatim: "
             f"{handoff['planes_max_abs_diff']}")
    if warm["differs"]:
        fail(f"cli 2.3: the warm start differs from 2.1's checkpoint in "
             f"{warm['differs']}")


def reenact_cam_params(i):
    """Frame ``i``'s camera in Motion-X-ReEnact's json: OpenCV axes (x
    right, y down, z forward) looking at the body from +z, 3 m away and
    drifting along x, the principal point at the centre of the frame."""
    return {"cam_R": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
            "cam_T": [0.01 * i - 0.15, 0.1, 3.0],
            "intrins": [REENACT_FOCAL, REENACT_FOCAL, REENACT_W / 2,
                        REENACT_H / 2]}


def reenact_camera(i):
    """Frame ``i``'s camera as the reenact loader parses it (the y row of
    the extrinsic flipped, fy negated)."""
    import numpy as np

    from dreamwaltz_g_tpu_torch.data.motion.loaders import (
        _parse_reenact_camera,
    )

    return _parse_reenact_camera({k: np.asarray([v]) for k, v in
                                  reenact_cam_params(i).items()})


def write_demo_motion(root):
    """``talkshow.npy`` in ``Demo``'s layout: ``DEMO_FRAMES`` frames of jaw
    (3), eyes (6), root orientation (3, left at 0: the body faces the
    camera), body (63), hands (90) and expression (100), each a 0.5 Hz
    sine at 30 frames a second of amplitude ``DEMO_AMPLITUDE`` on its own
    phase."""
    import numpy as np

    t = np.arange(DEMO_FRAMES)[:, None] / 30.0
    phase = np.random.default_rng(SEED).random((1, 265)) * 2 * np.pi
    arr = DEMO_AMPLITUDE * np.sin(np.pi * t + phase)
    arr[:, 9:12] = 0.0
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "talkshow.npy", arr.astype(np.float32))


def write_reenact(root):
    """``Motion-X-ReEnact.zip``: ``motion/<seq>.json`` (``REENACT_FRAMES``
    frames of SMPL-X parameters, small smooth angles, zero shape, each
    with ``reenact_cam_params``) and ``inpainting/<seq>_inpainting.mp4``,
    a moving color ramp written by OpenCV at 1280 x 720."""
    import zipfile

    import cv2
    import numpy as np

    root.mkdir(parents=True)
    t = np.arange(REENACT_FRAMES)[:, None] / 30.0
    phase = np.random.default_rng(SEED + 1).random((1, 162)) * 2 * np.pi
    ang = 0.2 * np.sin(np.pi * t + phase)
    ann = [{"smplx_params": {"root_orient": [0.0, 0.0, 0.0],
                             "pose_body": ang[i, :63].tolist(),
                             "pose_hand": ang[i, 63:153].tolist(),
                             "pose_jaw": ang[i, 153:156].tolist(),
                             "trans": [0.0, 0.0, 0.0],
                             "betas": [0.0] * 10},
            "cam_params": reenact_cam_params(i)}
           for i in range(REENACT_FRAMES)]
    mp4 = root / "inpainting.mp4"
    writer = cv2.VideoWriter(str(mp4), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (REENACT_W, REENACT_H))
    if not writer.isOpened():
        fail("OpenCV cannot write the reenact video")
    yy, xx = np.mgrid[0:REENACT_H, 0:REENACT_W]
    for i in range(REENACT_FRAMES):
        writer.write(np.stack([(xx // 5 + 4 * i) % 256, (yy // 3) % 256,
                               np.full_like(xx, 96)], -1).astype(np.uint8))
    writer.release()
    with zipfile.ZipFile(root / "Motion-X-ReEnact.zip", "w") as z:
        z.writestr(f"motion/{REENACT_SEQ}.json",
                   json.dumps({"annotations": ann}))
        z.write(mp4, f"inpainting/{REENACT_SEQ}_inpainting.mp4")
    mp4.unlink()


def write_retrieval(root, tokenizer_dir, dev):
    """The R-Precision towers at the JAX package's default sizes (the
    ViT-B/32 image tower: 224^2, patch 32, 768 wide, 12 layers; the
    768-wide, 12-layer text tower; projections of 512) with random weights
    from the seed, as one float16 torch file in transformers' ``CLIPModel``
    names, beside the BPE vocabulary of ``write_guidance``."""
    import shutil

    import torch

    from dreamwaltz_g_tpu_torch.utils.r_precision import (
        CLIPTextTower,
        CLIPVisionModel,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    towers = (CLIPVisionModel().to(dev), CLIPTextTower().to(dev))
    sd = {}
    for m in towers:
        m.reset_parameters(gen)
        sd.update({k: v.half().cpu() for k, v in m.state_dict().items()})
    root.mkdir(parents=True)
    torch.save(sd, root / "pytorch_model.bin")
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(tokenizer_dir / name, root / name)
    return sum(v.numel() for v in sd.values())


def cli_inference(dev, card, kernel_fns, tmp, argv, args, exp, times_ms):
    """Phase ``cli_inference``, in ``cli_two_stage``'s directory after its
    runs: the inference and evaluation paths through
    ``dreamwaltz_g_tpu_torch.main.main`` on step 2.3's avatar, each run
    with the counts set to 0 just before it and read just after.

    (a) step 3 of ``scripts/train_w_expr.sh`` as written: ``full_eval`` of
    the synthetic demo motion at the reference's defaults (60 frames at
    1024^2) and its R-Precision with the full-size random towers; the
    restored avatar equal to 2.3's last checkpoint to every bit; 60 PNGs
    and an mp4 of 60 1024^2 frames; frames 0 and 59 rendered again after
    the run, finite, covered and within one 8-bit level of their PNGs; B2
    60 times, the table blends and flash never.
    (b) steps 1.2 and 2.3 for 2 steps with a snapshot every step and an
    evaluation every 2: 8 eval PNGs at 512^2 and the mp4, the snapshots;
    flash (15, 1) a step, the table blends (0, 0) / (1, 1), B2 0 in stage 1
    and 8 + 2 in stage 2.
    (c) ``scripts/inference_reenact.sh``'s command on a synthetic
    Motion-X-ReEnact sequence, with the avatar's body parts, the
    sequence's length as ``full_eval_size`` and, as the background, the
    inpainted video that ``MotionXReEnact.extract_video`` writes (the JAX
    rule reads only a '.mp4' value): 30 frames of 720 x 1280 on the
    sequence's own cameras, B2 once a frame, the overlay mp4 of 30.
    Returns each run's launches."""
    import gc

    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch.configs import paths
    from dreamwaltz_g_tpu_torch.data.motion.loaders import MotionXReEnact
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.gs_trainer import (
        make_avatar_render,
        make_avatar_render_frames,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree
    from dreamwaltz_g_tpu_torch.utils.media import (
        load_image,
        read_video,
        to_uint8,
    )

    out = tmp / "outputs"

    def drive(argv_):
        return cli_drive(kernel_fns, argv_)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- (a) step 3: the avatar animated by the demo motion at 1024^2 -----
    t0 = time.perf_counter()
    write_demo_motion(tmp / "motions")
    n_retrieval = write_retrieval(tmp / "guidance" / "clip_retrieval",
                                  tmp / "guidance" / "tokenizer", dev)
    paths.DEMO_MOTIONS = str(tmp / "motions")
    assets_s = time.perf_counter() - t0
    step3 = ["--log.exp_root", str(out), "--log.exp_name", exp["2.3"],
             "--predefined_body_parts", CLI_PARTS, "--stage", "gs",
             "--log.eval_only", "true", "--optim.resume", "true",
             "--prompt.scene", "demo,talkshow",
             "--data.eval_elevation", "90",
             "--data.eval_camera_track", "fixed"]
    ckpt = resolve_ckpt_path(out / exp["2.3"])
    want = load_pytree(ckpt, map_location=dev)["params"]
    tr, a = drive(step3)
    d = tr.cfg.data
    n_full, test_size = d.full_eval_size, [d.test_h, d.test_w, 3]
    got = avatar_tree(tr.state.avatar, tr.avatar_model)
    differs = []

    def walk(g, w, name):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], f"{name}.{k}")
        elif not torch.equal(g, w):
            differs.append(name)

    walk(got, want, "avatar")
    results = out / exp["2.3"] / "results"
    step_dir = results / f"step_{tr.train_step:06d}"
    pngs = sorted(step_dir.glob("*.png"))
    video = read_video(str(step_dir) + ".mp4")
    rerender = {}
    with torch.no_grad():
        for i in (0, n_full - 1):
            obs, _ = tr.prompt(frame_idx=i)
            cam = tr.test_camera(i / n_full)
            bg = torch.zeros((d.test_h, d.test_w, 3), device=dev)
            img, alpha, _ = tr.test_render(
                tr.state.avatar, obs, cam.extrinsic[0], cam.intrinsics[0],
                cam.tanfov[0], bg)
            img = torch.clamp(img, 0, 1).cpu().numpy()
            rerender[i] = dict(
                finite=bool(np.isfinite(img).all()),
                coverage=float((alpha > 0.01).float().mean()),
                # in 8-bit levels, counted as integers: a level's float32
                # difference lies on either side of 1 / 255
                png_max_levels=int(np.abs(
                    to_uint8(img).astype(np.int16)
                    - np.rint(load_image(str(pngs[i])) * 255.0).astype(
                        np.int16)).max()) if len(pngs) > i else None,
                image=img)
    # the render span's parts, after the counts: the prompt's draws (an
    # SMPL-X forward a frame) and one chunk of 8 frames through the frame
    # render alone, on the same poses and cameras
    t0 = time.perf_counter()
    poses = [tr.prompt(frame_idx=i)[0] for i in range(8)]
    torch.cuda.synchronize()
    prompt_ms = (time.perf_counter() - t0) * 1e3 / 8
    cams = [tr.test_camera(i / n_full) for i in range(8)]
    chunk = (type(poses[0])(*[torch.stack(x) for x in zip(*poses)]),
             torch.cat([c.extrinsic for c in cams]),
             torch.cat([c.intrinsics for c in cams]),
             torch.cat([c.tanfov for c in cams]),
             torch.zeros((d.test_h, d.test_w, 3), device=dev))
    frames_fn = make_avatar_render_frames(
        tr.avatar_model, d.test_h, d.test_w,
        tile_size=tr.cfg.render.tile_size,
        capacity=tr.cfg.render.tile_capacity, chunk=tr.cfg.render.chunk,
        device=dev)
    chunk_ms = cuda_ms(lambda: frames_fn(tr.state.avatar, *chunk), 2) / 8
    spans = a.pop("spans_ms")
    render_dev, render_host = spans["evaluate.render"][0]
    a.update(
        full_eval_size=n_full, test_size=test_size,
        checkpoint=str(ckpt.name), restored_tensors=len(_leaf_names(got)),
        restored_differs=differs, pngs=len(pngs),
        png_size=list(load_image(str(pngs[0])).shape) if pngs else None,
        mp4_frames=int(video.shape[0]), mp4_size=list(video.shape[1:]),
        rerender={k: {kk: vv for kk, vv in v.items() if kk != "image"}
                  for k, v in rerender.items()},
        frames_differ=float(np.abs(rerender[0]["image"]
                                   - rerender[n_full - 1]["image"]).max()),
        render_ms_per_frame=render_dev and render_dev / n_full,
        render_host_ms_per_frame=render_host / n_full,
        frame_render_ms_per_frame=chunk_ms,
        prompt_draw_ms_per_frame=prompt_ms,
        alive=int(tr.state.avatar.alive.sum()),
        capacity=int(tr.state.avatar.alive.numel()),
        times_phase_ms_per_frame=times_ms,
        write_host_ms=spans["evaluate.write"][0][1],
        r_precision_ms=spans["trainer.r_precision"][0],
        retrieval_params=n_retrieval, assets_s=assets_s)
    tr = None
    free()

    # -- (b) evaluation and snapshots inside training ---------------------
    b = {}
    for step in ("1.2", "2.3"):
        name = exp[step] + "-evaluate"
        tr, run = drive(argv(step, *args[step], n=EVAL_RUN_STEPS, name=name)
                        + ["--log.snapshot_interval", "1",
                           "--log.evaluate_interval", str(EVAL_RUN_STEPS)])
        e = out / name
        ev = sorted((e / "results" / f"step_{EVAL_RUN_STEPS:06d}")
                    .glob("*.png"))
        run.update(
            steps=tr.train_step, loss=list(tr.losses),
            eval_size=tr.cfg.data.eval_size,
            eval_res=[tr.cfg.data.eval_h, tr.cfg.data.eval_w, 3],
            eval_pngs=len(ev),
            eval_png_size=list(load_image(str(ev[0])).shape) if ev else None,
            eval_mp4_frames=int(read_video(str(
                e / "results" / f"step_{EVAL_RUN_STEPS:06d}.mp4")).shape[0]),
            snapshots=sorted(f.name for f in
                             (e / "snapshots" / "train").glob("*.png")))
        ev_ms = run.pop("spans_ms")["evaluate.render"][0][0]
        run["eval_render_ms_per_frame"] = ev_ms and ev_ms / max(len(ev), 1)
        b[step] = run
        tr = None
        free()

    # -- (c) the reenact path -----------------------------------------------
    write_reenact(tmp / "reenact")
    paths.MOTIONX_REENACT_ROOT = str(tmp / "reenact")
    bg_path = MotionXReEnact(str(tmp / "reenact")).extract_video(
        REENACT_SEQ, str(tmp / "reenact_bg" / f"{REENACT_SEQ}.mp4"))
    tr, c = drive(["--stage", "gs", "--log.eval_only", "true",
                   "--optim.resume", "true", "--log.exp_root", str(out),
                   "--log.exp_name", exp["2.3"],
                   "--prompt.scene", f"motionx_reenact,{REENACT_SEQ}",
                   "--render.use_video_background", bg_path,
                   "--predefined_body_parts", CLI_PARTS,
                   "--data.full_eval_size", str(REENACT_FRAMES)])
    step_dir = results / f"step_{tr.train_step:06d}"
    shots = [load_image(str(step_dir / f"{i:04d}.png"))
             for i in range(REENACT_FRAMES)]
    render_dev = c.pop("spans_ms")["evaluate.render"][0][0]
    # frame 0 again over a transparent background (after the counts)
    cp = tr.prompt.get_camera_params_from_sequences(0)
    obs, _ = tr.prompt(frame_idx=0)
    _, alpha, _ = make_avatar_render(
        tr.avatar_model, REENACT_H, REENACT_W,
        tile_size=tr.cfg.render.tile_size,
        capacity=tr.cfg.render.tile_capacity, chunk=tr.cfg.render.chunk,
        device=dev)(tr.state.avatar, obs, cp["extrinsic"], cp["intrinsics"],
                    torch.tensor(cp["tanfov"], device=dev),
                    torch.zeros((REENACT_H, REENACT_W, 3), device=dev))
    c.update(frames=len(shots), frame_size=list(shots[0].shape),
             camera=tr.prompt.get_camera_params_from_sequences(0)[
                 "intrinsics"].tolist(),
             mp4_frames=int(read_video(str(step_dir) + ".mp4").shape[0]),
             overlay_frames=int(read_video(
                 str(step_dir) + "_overlay.mp4").shape[0]),
             coverage_frame0=float((alpha > 0.01).float().mean()),
             render_ms_per_frame=render_dev and render_dev / REENACT_FRAMES)
    tr = None
    free()

    emit(phase="cli_inference", step3=a, in_training=b, reenact=c, **card)
    quiet = {"blend_train_fwd": 0, "blend_train_bwd": 0,
             "blend_tiles_eval": 0, "flash_attn_fwd": 0, "flash_attn_bwd": 0}
    for label, run, n_b2 in (("step 3", a, n_full),
                             ("reenact", c, REENACT_FRAMES)):
        want_l = dict(quiet, blend_sorted=n_b2)
        if run["launches"] != want_l:
            fail(f"cli_inference {label}: launches {run['launches']}, "
                 f"expected {want_l}")
    if differs:
        fail(f"cli_inference: the restored avatar differs from {ckpt} in "
             f"{differs}")
    if a["pngs"] != n_full or a["png_size"] != test_size \
            or a["mp4_frames"] != n_full or a["mp4_size"] != test_size:
        fail(f"cli_inference step 3: {a['pngs']} PNGs of {a['png_size']}, "
             f"an mp4 of {a['mp4_frames']} x {a['mp4_size']}")
    for i, r in a["rerender"].items():
        if not r["finite"] or r["coverage"] <= 0.0 \
                or r["png_max_levels"] is None or r["png_max_levels"] > 1:
            fail(f"cli_inference step 3: frame {i} {r}")
    if a["frames_differ"] <= 0.0:
        fail("cli_inference step 3: frame 0 equals the last frame")
    for step, run in b.items():
        stage2 = step.startswith("2")
        want_l = {k: v * EVAL_RUN_STEPS
                  for k, v in cli_launches_per_step(stage2).items()}
        want_l["blend_sorted"] = (run["eval_size"] + EVAL_RUN_STEPS) \
            * stage2
        snaps = sorted(f"{s:06d}_{k}.png" for s in
                       range(1, EVAL_RUN_STEPS + 1) for k in ("cond", "rgb"))
        if run["launches"] != want_l or run["steps"] != EVAL_RUN_STEPS \
                or not all(math.isfinite(x) for x in run["loss"]) \
                or run["eval_pngs"] != run["eval_size"] \
                or run["eval_png_size"] != run["eval_res"] \
                or run["eval_mp4_frames"] != run["eval_size"] \
                or run["snapshots"] != snaps:
            fail(f"cli_inference {step} with evaluation: {run}, expected "
                 f"launches {want_l}")
    if c["frames"] != REENACT_FRAMES \
            or c["frame_size"] != [REENACT_H, REENACT_W, 3] \
            or c["overlay_frames"] != REENACT_FRAMES \
            or c["mp4_frames"] != REENACT_FRAMES or c["camera"][1][1] >= 0 \
            or c["coverage_frame0"] <= 0.0:
        fail(f"cli_inference reenact: {c}")
    return {"step3": a["launches"], "reenact": c["launches"],
            **{f"{k}-evaluate": v["launches"] for k, v in b.items()}}


def cli_drive(kernel_fns, argv_):
    """``dreamwaltz_g_tpu_torch.main.main(argv_)`` with the counts set to 0
    just before it and read just after, and the timing spans on; returns
    (its result, its fields: wall s, launches, spans, peak memory)."""
    import torch

    from dreamwaltz_g_tpu_torch import main as M
    from dreamwaltz_g_tpu_torch.utils import timing

    for fn in kernel_fns.values():
        fn.launches = 0
    timing.records.clear()
    timing.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tr = M.main(argv_)
        torch.cuda.synchronize()
    finally:
        timing.enabled = False
    run = {"wall_s": time.perf_counter() - t0,
           "launches": {k: fn.launches for k, fn in kernel_fns.items()},
           "spans_ms": {k: timing.times(k) for k in timing.records},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return tr, run


def flash_unet_launches(gparams, latent, nets):
    """Flash launches of one CFG eps pass: every self-attention of the UNet
    (down, mid, up) and, with ``nets`` = 2, of the ControlNet (down, mid),
    whose tokens and head dimension lie in ``flash_domain``."""
    cfg = gparams.unet.cfg
    n = 0
    last = len(cfg.block_out_channels) - 1
    for i, ch in enumerate(cfg.block_out_channels):
        tokens = (latent >> i) ** 2
        d = ch // cfg.block_heads(ch)
        if not flash_domain(tokens, d):
            continue
        depth = cfg.block_depth(i)
        if cfg.attn_down[i]:
            n += cfg.layers_per_block * depth * nets          # down blocks
            n += (cfg.layers_per_block + 1) * depth           # up blocks
        if i == last:
            n += depth * nets                                 # mid block
    return n


def vae_flash_launches(gparams, latent):
    """The VAE's mid-block attention (encoder's or decoder's: one each, at
    the last block's width over the latent grid) in the flash domain."""
    return int(flash_domain(latent * latent,
                            gparams.vae.cfg.block_out_channels[-1]))


def expected_check_sd_launches(gparams, latent, steps, n_control, n_plain):
    """Flash forwards of ``_check_sd``: each sample ``steps`` CFG passes
    (UNet + ControlNet for the ``n_control`` condition views, the UNet
    alone for the ``n_plain`` guidance scales) and one VAE decode."""
    vae = vae_flash_launches(gparams, latent)
    return n_control * (steps * flash_unet_launches(gparams, latent, 2)
                        + vae) \
        + n_plain * (steps * flash_unet_launches(gparams, latent, 1) + vae)


MODES_STEPS = 3     # pretrain and nerf2gs steps in phase cli_modes


def obj_stats(path):
    """Counts of an OBJ's vertices, UVs and faces, and whether every face's
    vertex and UV index lies in range."""
    nv = nvt = 0
    faces = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                nv += 1
            elif line.startswith("vt "):
                nvt += 1
            elif line.startswith("f "):
                faces.append([tuple(int(x) for x in c.split("/"))
                              for c in line.split()[1:]])
    ok = all(len(f) == 3 and all(1 <= v <= nv and 1 <= t <= nvt
                                 for v, t in f) for f in faces)
    return {"vertices": nv, "uvs": nvt, "faces": len(faces),
            "indices_valid": ok}


def cli_modes(dev, card, kernel_fns, tmp, argv, args, exp):
    """Phase ``cli_modes``, in ``cli_two_stage``'s directory after
    ``cli_inference``: the CLI's other modes through
    ``dreamwaltz_g_tpu_torch.main.main`` at full width, each run with the
    counts set to 0 just before it and read just after.

    (a) ``scripts/pretrain_nerf.sh``'s arguments for ``MODES_STEPS`` steps:
    a checkpoint written, finite losses, the field moved, no kernel
    launched; then a stage-1 ``Trainer`` warm-started from it
    (``--optim.ckpt``, step 1.1's flag) holds its parameters to every bit.
    (b) ``--log.nerf2gs`` from step 1.2's field for ``MODES_STEPS`` steps:
    B1 forward and backward once a step, nothing else; finite losses; the
    frozen field equal to its checkpoint to every bit; the avatar moved;
    the field's target render timed beside the step.
    (c) ``--log.check --log.check_sd`` on step 2.3's avatar with
    ``--optim.iters 0`` (construction only) and the default 50-step DDIM
    grid: the four condition images and the six samples written, finite
    and not flat; flash forwards equal to ``expected_check_sd_launches``,
    no backward, no blend.
    (d) ``--log.nerf2mesh`` on step 1.2's field at the default resolution
    128 and texture 1024: ``mesh.obj`` / ``.mtl`` / ``albedo.png``, faces
    > 0, every index valid; the field queries' device time apart from the
    host's mesh work. Each run prints one line (wall s, spans, launches,
    peak memory and its own fields). Returns each run's launches."""
    import gc

    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch.configs import parse_args
    from dreamwaltz_g_tpu_torch.guidance.sds import ScoreDistillation
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer, avatar_tree
    from dreamwaltz_g_tpu_torch.utils.media import load_image

    out = tmp / "outputs"
    quiet = {k: 0 for k in kernel_fns}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def first_state(method, take):
        """Wrap ``Trainer.<method>`` so that the built trainer's starting
        tensors are copied by ``take(trainer)`` as it returns."""
        orig = getattr(Trainer, method)
        seen = {}

        def wrapped(self):
            orig(self)
            seen.update(take(self))

        return orig, wrapped, seen

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.detach().clone()
                for k, v in tree.items()}

    # -- (a) the NeRF pretrain, then step 1.1's warm start from it ---------
    pre_exp = "pretrain/instant-ngp-adult-neutral"
    orig, wrapped, start = first_state(
        "_init_nerf", lambda t: {"nerf": clone(t.nerf.state_dict())})
    Trainer._init_nerf = wrapped
    try:
        tr, a = cli_drive(kernel_fns, [
            "--stage", "nerf", "--log.pretrain_only", "true",
            "--log.exp_root", str(out), "--log.exp_name", pre_exp,
            "--optim.iters", str(MODES_STEPS), "--data.train_w", "512",
            "--data.train_h", "512", "--prompt.scene", "canonical",
            "--guide.text", CLI_TEXT, "--log.snapshot_interval", "1"])
    finally:
        Trainer._init_nerf = orig
    ckpt = resolve_ckpt_path(out / pre_exp)
    saved = load_pytree(ckpt, map_location=dev)["params"] if ckpt else {}
    spans = a["spans_ms"]
    a.update(steps=tr.train_step, loss=list(tr.losses),
             batch_ms=spans["trainer.pretrain_batch"],
             step_ms=spans["trainer.pretrain_step"],
             checkpoint=ckpt and ckpt.name,
             moved=[k for k, v in tr.nerf.state_dict().items()
                    if not torch.equal(v, start["nerf"][k])],
             saved_differs=_differs(clone(tr.nerf.state_dict()), saved,
                                   "nerf") if ckpt else None)
    tr = None
    free()
    t0 = time.perf_counter()
    warm = Trainer(parse_args(argv("1.2", *args["1.2"], name="dancer/warm")
                              + ["--optim.ckpt", str(out / pre_exp)]))
    a["warm_start_differs"] = _differs(clone(warm.nerf.state_dict()), saved,
                                      "nerf")
    a["warm_start_build_s"] = time.perf_counter() - t0
    warm = None
    free()

    # -- (b) the nerf2gs distill from step 1.2's field ---------------------
    orig, wrapped, start = first_state(
        "_init_avatar", lambda t: {"avatar": clone(avatar_tree(
            t.state.avatar, t.avatar_model))})
    Trainer._init_avatar = wrapped
    try:
        tr, b = cli_drive(kernel_fns, argv(
            "2.1", *args["2.1"], n=MODES_STEPS, name="dancer/nerf2gs")
            + ["--log.nerf2gs", "true"])
    finally:
        Trainer._init_avatar = orig
    field = load_pytree(resolve_ckpt_path(out / exp["1.2"]),
                        map_location=dev)["params"]
    spans = b["spans_ms"]
    b.update(steps=tr.train_step, loss=list(tr.losses),
             target_differs=_differs(clone(tr._nerf_guidance[0].state_dict()),
                                    field, "nerf"),
             avatar_moved=[n for n in _differs(
                 clone(avatar_tree(tr.state.avatar, tr.avatar_model)),
                 start["avatar"], "avatar")],
             train_res=tr.train_res,
             target_render_ms=[t[0] for t in spans["trainer.nerf2gs_target"]],
             step_ms=[t[0] for t in spans["trainer.nerf2gs_step"]],
             export_ms=spans["trainer.export"][0])
    tr = None
    free()

    # -- (c) check / check_sd on step 2.3's avatar -------------------------
    samples = []
    orig_sample = ScoreDistillation.sample_images

    def sample(self, *a_, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        img = orig_sample(self, *a_, **kw)
        ev[1].record()
        samples.append(dict(events=ev, finite=bool(torch.isfinite(img).all()),
                            shape=list(img.shape),
                            steps=kw["num_inference_steps"],
                            controlnet=kw.get("cond_image") is not None))
        return img

    ScoreDistillation.sample_images = sample
    try:
        tr, c = cli_drive(kernel_fns, argv(
            "2.3", *args["2.3"], n=0) + ["--optim.resume", "true",
                                         "--log.check", "true",
                                         "--log.check_sd", "true"])
    finally:
        ScoreDistillation.sample_images = orig_sample
    torch.cuda.synchronize()
    for s in samples:
        ev = s.pop("events")
        s["ms"] = ev[0].elapsed_time(ev[1])
    check_dir = out / exp["2.3"] / "check"
    files = {}
    for f in sorted(check_dir.glob("*.png")):
        img = load_image(str(f))
        files[f.name] = {"std": float(img.std()),
                         "finite": bool(np.isfinite(img).all()),
                         "size": list(img.shape)}
    gp = tr.guidance_params
    latent = tr.guidance.latent_size
    steps = tr.cfg.log.check_sd_steps
    n_ctl = sum(s["controlnet"] for s in samples)
    with torch.no_grad():
        z = torch.randn((1, latent, latent, 4), device=dev)
        decode_ms = cuda_ms(lambda: gp.vae.decode(z), 2)
    spans = c["spans_ms"]
    c.update(files=files, samples=samples, ddim_steps=steps,
             latent=latent, vae_decode_ms=decode_ms,
             ddim_ms_per_step=[(s["ms"] - decode_ms) / steps
                               for s in samples],
             check_sd_ms=spans["trainer.check_sd"][0],
             expected_flash_fwd=expected_check_sd_launches(
                 gp, latent, steps, n_ctl, len(samples) - n_ctl),
             conditions=list(tr.cfg.guide.controlnet_condition),
             guidance_scale=tr.cfg.guide.guidance_scale)
    tr = gp = None
    free()

    # -- (d) nerf2mesh on step 1.2's field ---------------------------------
    tr, dd = cli_drive(kernel_fns, argv("1.2", *args["1.2"], name=exp["1.2"])
                       + ["--optim.resume", "true",
                          "--log.nerf2mesh", "true"])
    mesh = out / exp["1.2"] / "mesh"
    spans = dd["spans_ms"]
    q = spans.get("mesh.field_query", [])
    total_dev, total_host = spans["trainer.export_mesh"][0]
    query_host = sum(h for _, h in q)
    march_dev, march_host = spans["mesh.marching_tets"][0]
    dd.update(files=sorted(f.name for f in mesh.iterdir()),
              obj=obj_stats(mesh / "mesh.obj"),
              texture=list(load_image(str(mesh / "albedo.png")).shape),
              resolution=tr.cfg.log.mesh_resolution,
              texture_size=tr.cfg.log.mesh_texture_size,
              field_query_device_ms=[d for d, _ in q],
              field_query_host_ms=[h for _, h in q],
              marching_tets_ms=[march_dev, march_host],
              export_total_ms=[total_dev, total_host],
              host_mesh_work_ms=total_host - query_host - march_host)
    tr = None
    free()

    for run, line in (("pretrain", a), ("nerf2gs", b), ("check_sd", c),
                      ("nerf2mesh", dd)):
        emit(phase="cli_modes", run=run, **line, **card)
    if a["steps"] != MODES_STEPS or a["checkpoint"] is None \
            or not all(math.isfinite(x) for x in a["loss"]) \
            or not a["moved"] or a["saved_differs"] \
            or a["launches"] != quiet or a["warm_start_differs"]:
        fail(f"cli_modes pretrain: {a}")
    want_b = dict(quiet, blend_train_fwd=MODES_STEPS,
                  blend_train_bwd=MODES_STEPS)
    if b["steps"] != MODES_STEPS or b["launches"] != want_b \
            or not all(math.isfinite(x) for x in b["loss"]) \
            or b["target_differs"] or not b["avatar_moved"]:
        fail(f"cli_modes nerf2gs: {b}, expected launches {want_b}")
    azims = (0, 90, 180, 270)
    scales = {7.5, float(c["guidance_scale"])}
    want_files = {f"cond_{cond}_az{az}.png" for az in azims
                  for cond in c["conditions"] if cond != "depth_raw"}
    want_files |= {f"control_az{az}.png" for az in azims}
    want_files |= {f"sd_{g:g}.png" for g in scales}
    want_c = dict(quiet, flash_attn_fwd=c["expected_flash_fwd"])
    if set(c["files"]) != want_files or c["launches"] != want_c \
            or any(f["std"] <= 0.0 or not f["finite"]
                   for f in c["files"].values()) \
            or not all(s["finite"] for s in c["samples"]) \
            or len(c["samples"]) != len(azims) + len(scales):
        fail(f"cli_modes check_sd: {c}, expected files {sorted(want_files)}"
             f" and launches {want_c}")
    o = dd["obj"]
    if dd["launches"] != quiet or o["faces"] <= 0 \
            or not o["indices_valid"] \
            or set(dd["files"]) != {"mesh.obj", "mesh.mtl", "albedo.png"}:
        fail(f"cli_modes nerf2mesh: {dd}")
    return {"pretrain": a["launches"], "nerf2gs": b["launches"],
            "check_sd": c["launches"], "nerf2mesh": dd["launches"]}


# phase cli_geometry: steps of each run, the vanilla run's cuts (a grad
# threshold at which every visible slot clones or splits: at the default
# of 100 the densifier never fires in 3 steps) and its eval frames
GEOMETRY_STEPS = 3
VANILLA_GRAD_THRESHOLD = 0.0
VANILLA_EVAL_FRAMES = 8


def _differs(got, want, name):
    """Names of the tensors of tree ``got`` that differ from ``want``'s in
    any bit (non-tensor leaves compared with ==)."""
    if isinstance(got, dict):
        return [n for k in got for n in _differs(got[k], want[k],
                                                 f"{name}.{k}")]
    if isinstance(got, (list, tuple)):
        return [n for i, (g, w) in enumerate(zip(got, want))
                for n in _differs(g, w, f"{name}[{i}]")]
    import torch

    if torch.is_tensor(got):
        return [] if torch.equal(got, want.to(got.device)) else [name]
    return [] if got == want else [name]


def cli_geometry(dev, card, kernel_fns, tmp, argv, args, exp):
    """Phase ``cli_geometry``, in ``cli_two_stage``'s directory after
    ``cli_modes``: the trainer's other geometries through the port's CLI at
    full width, each run with the counts set to 0 just before it and read
    just after.

    (a) DMTet: step 1.2's arguments + ``--nerf.dmtet true --optim.ckpt
    <1.2's run>`` (512^2, ``tet_grid_size`` 128), ``GEOMETRY_STEPS``
    steps, the last profiled by the step's ranges; the band's tets, the
    valid triangles, each step's tile overflow, the albedo decode's peak
    memory (its checkpointed chunks, forward and backward); then a resumed
    construction whose restored field, sdf, deform and optimizers equal the
    checkpoint to the bit, and one eval frame (B1's forward, no backward).
    (b) vanilla: step 2.1's arguments + ``--render.gs_type vanilla`` with
    densification at step 2 and the opacity reset at step 3 (grad threshold
    ``VANILLA_GRAD_THRESHOLD``); then ``--log.eval_only --optim.resume``
    over ``VANILLA_EVAL_FRAMES`` 1024^2 frames of step 3's scene (B2 once a
    frame, no table blend), the restored avatar equal to the checkpoint.
    (c) hash: step 2.1's arguments + ``--render.gs_type hash``, then one
    eval frame (B2 once).

    Every training step launches B1 (1, 1) and B4 (15, 1). Each run prints
    a line. Returns each run's launches."""
    import gc

    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch.configs import parse_args
    from dreamwaltz_g_tpu_torch.gaussian.model import logit32
    from dreamwaltz_g_tpu_torch.training import dmtet_trainer, gs_trainer
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import (
        Trainer,
        _opt_tree,
        vanilla_tree,
    )

    out = tmp / "outputs"
    n = GEOMETRY_STEPS
    quiet = {k: 0 for k in kernel_fns}
    per_step = cli_launches_per_step(True)
    lines = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def recorder(seen):
        """A ``check`` for ``cli_run``: keeps the trainer and wraps its
        step to record each step's metrics."""
        def check(tr):
            seen["trainer"] = tr
            fn = tr.sds_step_fn

            def step(*a, **k):
                st, m = fn(*a, **k)
                seen.setdefault("metrics", []).append(
                    {key: float(v) for key, v in m.items()})
                return st, m

            tr.sds_step_fn = step
        return check

    def eval_frames(tr, size, save_dir):
        for fn in kernel_fns.values():
            fn.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        frames = tr.evaluate(size=size, save_dir=save_dir)
        ev[1].record()
        torch.cuda.synchronize()
        return dict(frames=len(frames), shape=list(frames[0].shape),
                    finite=bool(all(np.isfinite(f).all() for f in frames)),
                    ms_per_frame=ev[0].elapsed_time(ev[1]) / size,
                    launches={k: fn.launches
                              for k, fn in kernel_fns.items()})

    # -- (a) the DMTet finetune from step 1.2's field ---------------------
    dm_exp = "dancer/dmtet"
    dm_argv = argv("1.2", *args["1.2"], n=n, name=dm_exp) + [
        "--nerf.dmtet", "true", "--optim.ckpt", str(out / exp["1.2"])]
    seen = {}

    def dm_check(tr):
        seen["seed"] = {k: v.detach().clone()
                        for k, v in tr.state.dmtet._asdict().items()}
        recorder(seen)(tr)

    a = cli_run("dmtet", dm_argv, n, kernel_fns, check=dm_check,
                stage_ranges=DMTET_STAGE_RANGES)
    tr = seen.pop("trainer")
    dm = tr.dmtet_model
    with torch.no_grad():
        soup = dm.extract(tr.state.dmtet)
        centroids = torch.mean(soup.vertices, dim=1)
    G = tr.cfg.nerf.tet_grid_size
    a.update(tet_grid_size=G, tets=int(dm.tets.shape[0]),
             tets_full_grid=6 * (G - 1) ** 3,
             triangle_slots=int(soup.valid.shape[0]),
             valid_triangles=int(soup.valid.sum()),
             edges=int(tr._tet_edges.shape[0]),
             deform_scale=dm.deform_scale,
             tile_overflow=[m["tile_overflow"] for m in seen["metrics"]],
             step_terms=seen["metrics"],
             moved={k: not torch.equal(v, seen["seed"][k])
                    for k, v in tr.state.dmtet._asdict().items()})
    # the albedo decode alone, forward and backward through its
    # checkpointed chunks, at the final surface's centroids
    tr.nerf.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    dmtet_trainer.query_albedo(tr.nerf, centroids).sum().backward()
    ev[1].record()
    torch.cuda.synchronize()
    a.update(albedo_decode_peak_gib=(torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30,
             albedo_decode_fwd_bwd_ms=ev[0].elapsed_time(ev[1]),
             albedo_chunks=-(-centroids.shape[0]
                             // dmtet_trainer.ALBEDO_CHUNK))
    tr = soup = centroids = None
    free()
    # a resumed construction restores step n, then one eval frame
    ckpt = resolve_ckpt_path(out / dm_exp)
    saved = load_pytree(ckpt, map_location=dev)
    t0 = time.perf_counter()
    tr = Trainer(parse_args(dm_argv + ["--optim.resume", "true"]))
    tr.load_checkpoint()
    a["resume_s"] = time.perf_counter() - t0
    a["restored_differs"] = _differs(
        {"params": tr.nerf.state_dict(),
         "dmtet": tr.state.dmtet._asdict(),
         "opt_state": _opt_tree(tr.state.opt_state)},
        {k: saved[k] for k in ("params", "dmtet", "opt_state")}, "dmtet")
    a["eval"] = eval_frames(tr, 1, tmp / "geometry_eval" / "dmtet")
    lines["dmtet"] = a
    tr = saved = None
    free()

    # -- (b) the vanilla avatar, then its eval-only run --------------------
    v_exp = "dancer/vanilla"
    v_argv = argv("2.1", *args["2.1"], n=n, name=v_exp) + [
        "--render.gs_type", "vanilla", "--render.use_densifier", "true",
        "--render.densify_from_iter", "0",
        "--render.densification_interval", "2",
        "--render.densify_disable_reset", "false",
        "--render.opacity_reset_interval", "3",
        "--render.densify_grad_threshold", str(VANILLA_GRAD_THRESHOLD)]
    events = []
    densify_step, reset = gs_trainer.densify_step, \
        gs_trainer.reset_vanilla_opacity

    def densify_rec(state, cfg, *a_, **k):
        before = int(state.alive.sum())
        res = densify_step(state, cfg, *a_, **k)
        events.append(dict(event="densify", alive_before=before,
                           alive_after=int(res[0].alive.sum()),
                           written=int(res[1].sum())))
        return res

    def reset_rec(tstate, value=0.01):
        res = reset(tstate, value)
        g = res.avatar.gaussians
        logits = g.params.opacity_logit[:, 0].detach()
        op = torch.sigmoid(logits)
        # the clamp's bound through the same sigmoid kernel
        bound = torch.sigmoid(torch.full_like(logits, logit32(value)))
        events.append(dict(event="opacity_reset", value=value,
                           bound=float(bound[0]),
                           max_alive_opacity=float(op[g.alive].max()),
                           within=bool((op <= bound)[g.alive].all())))
        return res

    gs_trainer.densify_step = densify_rec
    gs_trainer.reset_vanilla_opacity = reset_rec
    seen = {}
    try:
        b = cli_run("vanilla", v_argv, n, kernel_fns, check=recorder(seen),
                    stage_ranges=VANILLA_STAGE_RANGES)
    finally:
        gs_trainer.densify_step = densify_step
        gs_trainer.reset_vanilla_opacity = reset
    tr = seen.pop("trainer")
    b.update(capacity=tr.state.avatar.capacity,
             alive=int(tr.state.avatar.gaussians.alive.sum()),
             events=events, grad_threshold=VANILLA_GRAD_THRESHOLD,
             tile_overflow=[m["tile_overflow"] for m in seen["metrics"]])
    lines["vanilla"] = b
    tr = None
    free()
    saved = load_pytree(resolve_ckpt_path(out / v_exp),
                        map_location=dev)["params"]
    tr, c = cli_drive(kernel_fns, v_argv + [
        "--log.eval_only", "true", "--optim.resume", "true",
        "--prompt.scene", "demo,talkshow", "--data.eval_elevation", "90",
        "--data.eval_camera_track", "fixed",
        "--data.full_eval_size", str(VANILLA_EVAL_FRAMES)])
    step_dir = out / v_exp / "results" / f"step_{tr.train_step:06d}"
    render_ms = c["spans_ms"]["evaluate.render"][0]
    c.update(restored_differs=_differs(vanilla_tree(tr.state.avatar), saved,
                                       "vanilla"),
             pngs=len(list(step_dir.glob("*.png"))),
             size=[tr.cfg.data.test_h, tr.cfg.data.test_w],
             render_ms_per_frame=[x and x / VANILLA_EVAL_FRAMES
                                  for x in render_ms])
    lines["vanilla_eval"] = c
    tr = saved = None
    free()

    # -- (c) the hash avatar, then one eval frame ---------------------------
    h_argv = argv("2.1", *args["2.1"], n=n, name="dancer/hash") + [
        "--render.gs_type", "hash"]
    seen = {}
    d = cli_run("hash", h_argv, n, kernel_fns, check=recorder(seen))
    tr = seen.pop("trainer")
    d.update(mesh_parts=len(tr.avatar_model.mesh_parts),
             tile_overflow=[m["tile_overflow"] for m in seen["metrics"]],
             eval=eval_frames(tr, 1, tmp / "geometry_eval" / "hash"))
    lines["hash"] = d
    tr = None
    free()

    for run, line in lines.items():
        emit(phase="cli_geometry", run=run, **line, **card)
    for run in ("dmtet", "vanilla", "hash"):
        line = lines[run]
        prof = line["profiled_step"]["launches"]
        for name, k in per_step.items():
            if line["launches"][name] != k * n or prof[name] != k:
                fail(f"cli_geometry {run}: {name} launched "
                     f"{line['launches'][name]} times in {n} steps "
                     f"({prof[name]} in the profiled one), expected {k} a "
                     "step")
        if line["steps"] != n or len(line["loss"]) != n \
                or not all(math.isfinite(x) for x in line["loss"]):
            fail(f"cli_geometry {run}: {line['steps']} steps, losses "
                 f"{line['loss']}")
    one_fwd = dict(quiet, blend_train_fwd=1)
    if not (0 < a["tets"] < 6 * a["tet_grid_size"] ** 3) \
            or a["valid_triangles"] <= 0 or not all(a["moved"].values()) \
            or a["restored_differs"] or a["eval"]["launches"] != one_fwd \
            or not a["eval"]["finite"]:
        fail(f"cli_geometry dmtet: {a}")
    dens = [e for e in events if e["event"] == "densify"]
    resets = [e for e in events if e["event"] == "opacity_reset"]
    if len(dens) != 1 or dens[0]["written"] <= 0 or len(resets) != 1 \
            or not resets[0]["within"]:
        fail(f"cli_geometry vanilla: densify / reset events {events}")
    want_c = dict(quiet, blend_sorted=VANILLA_EVAL_FRAMES)
    if c["launches"] != want_c or c["restored_differs"] \
            or c["pngs"] != VANILLA_EVAL_FRAMES:
        fail(f"cli_geometry vanilla eval: {c}, expected launches {want_c}")
    if d["eval"]["launches"] != dict(quiet, blend_sorted=1) \
            or not d["eval"]["finite"] or d["mesh_parts"]:
        fail(f"cli_geometry hash: {d}")
    return {"dmtet": a["launches"], "dmtet_eval": a["eval"]["launches"],
            "vanilla": b["launches"], "vanilla_eval": c["launches"],
            "hash": d["launches"], "hash_eval": d["eval"]["launches"]}


SCENE_STEPS = 3          # steps of each training run of phase cli_scene
SCENE_BG_GAUSSIANS = 200_000
SCENE_SHELL_RADIUS = 4.0  # beyond every training and eval camera
SCENE_EVAL_FRAMES = 4
GRID_STEPS = 3           # grid stage 2; stage 1 runs 2, unprofiled
REFERENCE_POINTS = 100_000
# record_function ranges of make_avatar_sds_step_split -> stage
SPLIT_STAGE_RANGES = (("split_step.render_encode", "render_encode"),
                      ("split_step.latent_gradients", "controlnet_unet_cfg"),
                      ("split_step.render", "render_encode_again"),
                      ("rasterize.bin", "bin"),
                      ("rasterize.blend", "blend_fwd_b1"),
                      ("split_step.backward", "backward"),
                      ("split_step.optimizer_stats", "optimizer_stats"))


def write_scene_ply(path, n):
    """A seeded trained-3DGS PLY of ``n`` Gaussians on a shell of radius
    ``SCENE_SHELL_RADIUS`` (+-5%) around the avatar, the size of a small
    captured scene: DC colors, no higher bands, scales ~0.03."""
    import numpy as np

    from dreamwaltz_g_tpu_torch.utils.point_cloud import save_gaussian_ply

    rng = np.random.default_rng(SEED + 16)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = SCENE_SHELL_RADIUS * (1.0 + 0.05 * rng.uniform(-1, 1, size=(n, 1)))
    return save_gaussian_ply(
        str(path), d * r, rng.normal(size=(n, 3)), None,
        rng.normal(size=n) + 1.0,
        np.full((n, 3), -3.5) + 0.2 * rng.normal(size=(n, 3)),
        rng.normal(size=(n, 4)))


def write_reference_pth(path, model, n):
    """A seeded ``.pth`` in the reference's checkpoint wrapper and scene key
    layout for ``model`` (an ``AvatarModel`` on a grid field): ``n``
    Gaussians near the template's vertices with their LBS weights, the flat
    hash tables, the sigma MLP and the deform net with its three heads
    (``layers.{i}``, ``gaussian_warp`` / ``_rotation`` / ``_scaling``); the
    mesh parts keep their initial binding."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 17)
    enc = model.enc_cfg
    rows = sum(enc.level_table_size(lv) for lv in range(enc.num_levels))
    v = model.smpl.v_template.cpu().numpy()
    pick = rng.integers(0, v.shape[0], n)
    q = rng.normal(size=(n, 4))
    sd = {"avatar._positions": v[pick] + 0.01 * rng.normal(size=(n, 3)),
          "avatar._scales": np.full((n, 3), -5.0) + 0.3 * rng.normal(
              size=(n, 3)),
          "avatar._quaternions": q / np.linalg.norm(q, axis=1,
                                                    keepdims=True),
          "avatar._lbs_weights":
              model.smpl.lbs_weights.cpu().numpy()[pick],
          "avatar.nerf_encoder.embeddings": 0.1 * rng.normal(
              size=(rows, enc.level_dim)),
          "avatar._betas": 0.3 * rng.normal(size=(10,))}

    def dense(prefix, lin, scale=1.0):
        o, i = lin.weight.shape
        sd[f"{prefix}.weight"] = scale * rng.normal(size=(o, i)) / np.sqrt(i)
        sd[f"{prefix}.bias"] = np.zeros(o)

    for i in range(model.color_mlp.num_layers):
        dense(f"avatar.nerf_opacity_and_color_net.net.{i}",
              getattr(model.color_mlp, f"dense_{i}"))
    for i in range(model.sq_net.depth):
        dense(f"avatar.deform_model.layers.{i}",
              getattr(model.sq_net, f"dense_{i}"))
    for ours, theirs in (("head_offset", "gaussian_warp"),
                         ("head_quat", "gaussian_rotation"),
                         ("head_scale", "gaussian_scaling")):
        dense(f"avatar.deform_model.{theirs}", getattr(model.sq_net, ours),
              scale=1e-3)
    torch.save({"train_step": 15000, "checkpoints": ["step_015000.pth"],
                "model": {k: torch.as_tensor(np.asarray(a, np.float32))
                          for k, a in sd.items()}}, str(path))
    return path


def cli_scene(dev, card, kernel_fns, tmp, argv, args, exp):
    """Phase ``cli_scene``, in ``cli_two_stage``'s directory after
    ``cli_geometry``: the scene options, the grid backbone and a converted
    reference avatar through the port's CLI at full width, each run with
    the counts set to 0 just before it and read just after.

    Step 2.1's arguments go without the LBS smoothing here.

    (a) MLP background: step 2.1's arguments + ``--render.use_mlp_background
    true`` (the split step), ``SCENE_STEPS`` steps saved at the last two;
    then ``main`` restores the last but one and trains the last again. Both
    runs under ``torch.use_deterministic_algorithms`` (the gathers'
    backward and the blends' panel sums then add in one order), so the
    resumed step-3 checkpoint equals the uninterrupted one to every bit,
    "background" (the net and its Adan state) included; the net moved.
    (b) Gaussian background: step 2.1's arguments + ``--render.
    use_gs_background`` (``SCENE_BG_GAUSSIANS`` Gaussians on a shell,
    written with ``save_gaussian_ply``) + ``--render.avatar_scale`` /
    ``avatar_transl``; each step's tile overflow, then one eval frame with
    the background and one without it (B2 once each) with their overflow.
    (c) Composition: ``--log.eval_only`` on (b)'s run with
    ``--optim.ckpt_extra`` naming (a)'s and a translation for each avatar,
    ``SCENE_EVAL_FRAMES`` frames of the demo motion (one person: the ported
    motion loaders tile none), B2 once a frame; the extra avatar restored
    to every bit.
    (d) Grid: step 1.2's arguments + ``--nerf.backbone tiledgrid`` (16
    levels, 2^19 tables, F = 2, 2048 x bound) from a grid template fitted
    like ``fit_template``'s, 2 steps unprofiled, then the handoff and step
    2.1 on it, ``GRID_STEPS`` steps; the tables carried into the avatar
    with a difference of 0.
    (e) A seeded reference ``.pth`` (``REFERENCE_POINTS`` Gaussians on (d)'s
    avatar model) through ``convert_reference`` and one 1024^2 eval frame
    (B2 once).

    Checks: B1 (2, 1) and B4 (fused + the VAE's second encode, 1) every
    split step; B1 (1, 1) and B4 (15, 1) every fused stage-2 step, B1 (0,
    0) in stage 1; B2 once an eval frame and no other kernel. Returns each
    run's launches."""
    import gc

    import numpy as np
    import torch

    from dreamwaltz_g_tpu_torch import convert_reference as CR
    from dreamwaltz_g_tpu_torch.configs import NeRFConfig, paths
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch
    from dreamwaltz_g_tpu_torch.ops import rasterize as R
    from dreamwaltz_g_tpu_torch.training import gs_trainer
    from dreamwaltz_g_tpu_torch.training.checkpoint import (
        load_pytree,
        resolve_ckpt_path,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree

    out = tmp / "outputs"
    n = SCENE_STEPS
    quiet = {k: 0 for k in kernel_fns}
    lines, runs = {}, {}
    # step 2.1's arguments without the LBS smoothing (10 s a construction,
    # held by cli_two_stage's 2.1 run)
    args = dict(args, **{"2.1": args["2.1"] + (
        "--render.lbs_weight_smooth", "false")})

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def recorder(seen):
        """A ``check`` for ``cli_run``: keeps the trainer, its background
        net's weights as built, the split step's flash forwards from the
        guidance's structure, and wraps its step to record each step's
        tile overflow."""
        def check(tr):
            seen["trainer"] = tr
            if tr.bg_net is not None:
                seen["bg_seed"] = {k: v.detach().clone() for k, v
                                   in tr.bg_net.state_dict().items()}
            seen["vae_flash"] = vae_flash_launches(
                tr.guidance_params, tr.guidance.latent_size)
            fn = tr.sds_step_fn
            seen["step_fn"] = fn.__qualname__.split(".")[0]

            def step(*a, **k):
                res = fn(*a, **k)
                seen.setdefault("overflow", []).append(
                    float(res[-1]["tile_overflow"]))
                return res

            tr.sds_step_fn = step
        return check

    def counted(fn, *a, **k):
        for f in kernel_fns.values():
            f.launches = 0
        res = fn(*a, **k)
        torch.cuda.synchronize()
        return res, {name: f.launches for name, f in kernel_fns.items()}

    overflows = []
    rasterize = R.rasterize_projected

    def rasterize_rec(*a, **k):
        o = rasterize(*a, **k)
        overflows.append(float(o.overflow))
        return o

    paths.DEMO_MOTIONS = str(tmp / "motions")
    write_demo_motion(tmp / "motions")

    # -- (a) the MLP background: the split step, resumed to the bit ---------
    mlp_exp = "scene/mlp_bg"
    mlp_argv = argv("2.1", *args["2.1"], n=n, name=mlp_exp) + [
        "--render.use_mlp_background", "true",
        "--log.save_interval", str(n - 1), "--log.max_keep_ckpts", "0"]
    seen = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = cli_run("mlp_bg", mlp_argv, n, kernel_fns, check=recorder(seen),
                    stage_ranges=SPLIT_STAGE_RANGES)
        tr = seen.pop("trainer")
        a.update(step_fn=seen["step_fn"],
                 tile_overflow=seen.pop("overflow"),
                 bg_moved={k: not torch.equal(v, seen["bg_seed"][k])
                           for k, v in tr.bg_net.state_dict().items()},
                 deterministic=True)
        split = dict(cli_launches_per_step(True), blend_train_fwd=2,
                     flash_attn_fwd=FLASH_PER_STEP[0] + seen["vae_flash"])
        tr = None
        free()
        ckpts = out / mlp_exp / "checkpoints"
        (ckpts / f"step_{n:08d}").rename(tmp / "mlp_bg_last_aside")
        _, r = cli_drive(kernel_fns, mlp_argv + ["--optim.resume", "true"])
    finally:
        torch.use_deterministic_algorithms(False)
    r["resumed_differs"] = _differs(
        load_pytree(ckpts / f"step_{n:08d}"),
        load_pytree(tmp / "mlp_bg_last_aside"), "checkpoint")
    r["background_tensors"] = len(_leaf_names(
        load_pytree(ckpts / f"step_{n:08d}")["background"]))
    lines["mlp_bg"], lines["mlp_bg_resumed"] = a, r
    runs["mlp_bg"], runs["mlp_bg_resumed"] = a["launches"], r["launches"]
    free()

    # -- (b) the Gaussian background with the placement ---------------------
    ply = write_scene_ply(tmp / "scene_bg.ply", SCENE_BG_GAUSSIANS)
    gs_exp = "scene/gs_bg"
    gs_argv = argv("2.1", *args["2.1"], n=n, name=gs_exp) + [
        "--render.use_gs_background", str(ply),
        "--render.avatar_scale", "0.9",
        "--render.avatar_transl", "[0.0, 0.0, 0.1]"]
    seen = {}
    b = cli_run("gs_bg", gs_argv, n, kernel_fns, check=recorder(seen))
    tr = seen.pop("trainer")
    b["tile_overflow"] = seen.pop("overflow")
    cfg = tr.cfg
    cam = tr.eval_camera(0.0)
    bg = torch.zeros((cfg.data.eval_h, cfg.data.eval_w, 3), device=dev)
    view = (tr.prompt.canonical_inputs, cam.extrinsic[0], cam.intrinsics[0],
            cam.tanfov[0], bg)
    plain = gs_trainer.make_avatar_render(
        tr.avatar_model, cfg.data.eval_h, cfg.data.eval_w,
        tile_size=cfg.render.tile_size, capacity=cfg.render.tile_capacity,
        chunk=cfg.render.chunk, placement=tr._placement(), device=dev)
    R.rasterize_projected = rasterize_rec
    try:
        with_bg, l_bg = counted(tr.eval_render, tr.state.avatar, *view)
        without, l_plain = counted(plain, tr.state.avatar, *view)
    finally:
        R.rasterize_projected = rasterize
    b.update(background_gaussians=int(
        tr._static_bg_gaussians().positions.shape[0]),
        placement=[float(tr._placement()[0]),
                   [float(x) for x in tr._placement()[1]]],
        eval_size=[cfg.data.eval_h, cfg.data.eval_w],
        render_overflow={"with_background": overflows[0],
                         "avatar_alone": overflows[1]},
        render_alpha_mean={"with_background": float(with_bg[1].mean()),
                           "avatar_alone": float(without[1].mean())},
        render_launches={"with_background": l_bg, "avatar_alone": l_plain})
    lines["gs_bg"] = b
    runs["gs_bg"] = b["launches"]
    tr = with_bg = without = plain = None
    free()

    # -- (c) composition: (b)'s avatar with (a)'s, each placed ----------------
    tr, c = cli_drive(kernel_fns, gs_argv + [
        "--log.eval_only", "true", "--optim.resume", "true",
        "--optim.ckpt_extra", str(out / mlp_exp),
        "--render.avatar_transl", "[[0.35, 0.0, 0.1], [-0.35, 0.0, 0.1]]",
        "--prompt.scene", "demo,talkshow",
        "--data.full_eval_size", str(SCENE_EVAL_FRAMES)])
    step_dir = out / gs_exp / "results" / f"step_{tr.train_step:06d}"
    c.update(extra_avatars=len(tr.extra_states),
             extra_differs=_differs(
                 avatar_tree(tr.extra_states[0], tr.extra_models[0]),
                 load_pytree(resolve_ckpt_path(out / mlp_exp),
                             map_location=dev)["params"], "extra"),
             pngs=len(list(step_dir.glob("*.png"))),
             size=[tr.cfg.data.test_h, tr.cfg.data.test_w],
             render_ms_per_frame=[
                 x and x / SCENE_EVAL_FRAMES
                 for x in c["spans_ms"]["evaluate.render"][0]])
    lines["composition"] = c
    runs["composition"] = c["launches"]
    tr = None
    free()

    # -- (d) the tiled grid: step 1.2 on a fitted grid, then the handoff ----
    grid = ["--nerf.backbone", "tiledgrid"]
    template = tmp / "grid_template"
    fit = fit_template(str(tmp / "human_templates" / "smplx"
                           / "SMPLX_NEUTRAL_2020.npz"),
                       template / "checkpoints" / "step_00000000", dev,
                       cfg=NeRFConfig(backbone="tiledgrid"))
    g1_exp, g2_exp = "scene/grid-1.2", "scene/grid-2.1"
    # unprofiled: a profile of a stage-1 grid step takes ~70 s to export
    # and read (its ~52k launches a level)
    d1 = cli_run("grid-1.2", argv("1.2", *args["1.2"], n=2, name=g1_exp)
                 + grid + ["--optim.ckpt", str(template)],
                 2, kernel_fns, prefetch=False)
    d1["template"] = fit
    free()
    carried, seen = {}, {}

    def check_tables(tr):
        stage1 = load_pytree(resolve_ckpt_path(out / g1_exp),
                             map_location=dev)["params"]["tables"]
        enc = tr.state.avatar.params.encoder
        carried.update(shape=list(enc.tables.shape),
                       levels=tr.avatar_model.enc_cfg.num_levels,
                       max_abs_diff=float((enc.tables.detach() - stage1)
                                          .abs().max()))
        recorder(seen)(tr)

    d2 = cli_run("grid-2.1", argv("2.1", *args["2.1"], n=GRID_STEPS,
                                  name=g2_exp)
                 + grid + ["--render.from_nerf", str(out / g1_exp)],
                 GRID_STEPS, kernel_fns, check=check_tables)
    tr = seen.pop("trainer")
    d2.update(carried=carried, tile_overflow=seen.pop("overflow"))
    lines["grid-1.2"], lines["grid-2.1"] = d1, d2
    runs["grid-1.2"], runs["grid-2.1"] = d1["launches"], d2["launches"]

    # -- (e) a reference checkpoint converted and rendered --------------------
    model = tr.avatar_model
    tr = None
    free()
    t0 = time.perf_counter()
    pth = write_reference_pth(tmp / "reference_step_015000.pth", model,
                              REFERENCE_POINTS)
    state = CR.convert_avatar_checkpoint(CR.load_torch_checkpoint(str(pth)),
                                         model, device=dev)
    convert_s = time.perf_counter() - t0
    at = state.params.positions[:REFERENCE_POINTS].mean(0).tolist()
    rc = make_camera_batch(2.5, 0.0, 85.0, 50.0, H, W, at_vector=(at,),
                           device=dev)
    render = gs_trainer.make_avatar_render(model, H, W, device=dev, **RASTER)
    (img, alpha, _), e_launches = counted(
        render, state, model.canonical_inputs, rc.extrinsic[0],
        rc.intrinsics[0], rc.tanfov[0], torch.ones((H, W, 3), device=dev))
    e = dict(points=REFERENCE_POINTS, capacity=state.capacity,
             pth_bytes=pth.stat().st_size, convert_s=convert_s,
             size=[H, W], launches=e_launches,
             alpha_mean=float(alpha.mean()),
             finite=bool(torch.isfinite(img).all()))
    lines["reference"] = e
    runs["reference"] = e_launches
    state = img = alpha = model = None
    free()

    for run, line in lines.items():
        emit(phase="cli_scene", run=run, **line, **card)
    fused = cli_launches_per_step(True)
    for run, per, k in (("mlp_bg", split, n), ("gs_bg", fused, n),
                        ("grid-1.2", cli_launches_per_step(False), 2),
                        ("grid-2.1", fused, GRID_STEPS)):
        line = lines[run]
        prof = line.get("profiled_step", {"launches": per})["launches"]
        for name, want in per.items():
            if line["launches"][name] != want * k or prof[name] != want:
                fail(f"cli_scene {run}: {name} launched "
                     f"{line['launches'][name]} times in {k} steps "
                     f"({prof[name]} in the profiled one), expected {want} "
                     "a step")
        if line["steps"] != k or len(line["loss"]) != k \
                or not all(math.isfinite(x) for x in line["loss"]):
            fail(f"cli_scene {run}: {line['steps']} steps, losses "
                 f"{line['loss']}")
    if r["launches"] != split or r["resumed_differs"] \
            or a["step_fn"] != "make_avatar_sds_step_split" \
            or not a["bg_moved"] or not all(a["bg_moved"].values()):
        fail(f"cli_scene mlp_bg: resumed {r}, background moved "
             f"{a['bg_moved']}, expected launches {split}")
    one = dict(quiet, blend_sorted=1)
    if b["render_launches"] != {"with_background": one,
                                "avatar_alone": one} \
            or b["background_gaussians"] != SCENE_BG_GAUSSIANS \
            or not b["render_alpha_mean"]["with_background"] \
            > b["render_alpha_mean"]["avatar_alone"]:
        fail(f"cli_scene gs_bg: {b}")
    want_c = dict(quiet, blend_sorted=SCENE_EVAL_FRAMES)
    if c["launches"] != want_c or c["extra_differs"] \
            or c["extra_avatars"] != 1 or c["pngs"] != SCENE_EVAL_FRAMES:
        fail(f"cli_scene composition: {c}, expected launches {want_c}")
    if carried.get("max_abs_diff") != 0.0 or carried["levels"] != 16:
        fail(f"cli_scene grid: the tables carried into stage 2 {carried}")
    if e["launches"] != one or not e["finite"] or e["alpha_mean"] <= 0.0:
        fail(f"cli_scene reference: {e}")
    return runs


def _leaf_names(tree, name="avatar"):
    if not isinstance(tree, dict):
        return [name]
    return [n for k, v in tree.items() for n in _leaf_names(v, f"{name}.{k}")]


# record_function ranges of make_avatar_sds_step and its callees -> stage
STAGE_RANGES = (("sds_step.render", "animate_project"),
                ("rasterize.bin", "bin"),
                ("rasterize.blend", "blend_fwd_b1"),
                ("sds_step.guidance", "sds_loss"),
                ("sds.encode_images", "vae_encode"),
                ("sds.latent_gradients", "controlnet_unet_cfg"),
                ("sds_step.backward", "backward"),
                ("sds_step.optimizer_stats", "optimizer_stats"))


# substrings of the hand-written kernels' names in a profiler trace
NAMED_KERNELS = ("blend_fwd", "blend_bwd", "flash_fwd", "flash_combine",
                 "flash_bwd", "flash_delta", "indexing_backward")


def stage_times(trace_path, stage_ranges=STAGE_RANGES, recompute_in=None):
    """Per-stage device and host ms of one profiled SDS step, from the
    profiler's Chrome trace. Each kernel, copy or fill on the card is
    charged to the innermost of the step's own ``record_function`` ranges
    whose host interval holds the runtime call that launched it (matched by
    correlation id). So kernels that autograd's device thread launches land
    in the backward's range, and a nested range's kernels leave its
    parent's: ``animate_project`` is the render range less ``bin`` and
    ``blend_fwd_b1``, ``sds_loss`` the guidance range less its two stages.
    Host ms is each range's whole span, nested ranges and the profiler's
    overhead included. With ``recompute_in``, a range nested inside a range
    of that name (a checkpointed forward recomputed by the backward) is
    charged to ``backward_recompute``. Returns (device ms by stage, host ms
    by range, device ms of the hand-written kernels whose name holds each
    of ``NAMED_KERNELS``)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = dict(stage_ranges)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in names]
    outer = [r for r in ranges if r["name"] == recompute_in]

    def stage(r):
        if r["name"] != recompute_in and any(
                o["ts"] <= r["ts"] and r["ts"] + r["dur"] <= o["ts"] + o["dur"]
                for o in outer):
            return "backward_recompute"
        return names[r["name"]]

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = {stage: 0.0 for _, stage in stage_ranges}
    device["outside_ranges"] = 0.0
    if recompute_in:
        device["backward_recompute"] = 0.0
    named = {pattern: 0.0 for pattern in NAMED_KERNELS}
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
        device[stage(inner) if inner else "outside_ranges"] += ms
        for pattern in NAMED_KERNELS:
            if pattern in e.get("name", ""):
                named[pattern] += ms
    host = {}
    for r in ranges:       # a range that recurs (a ray chunk's) sums
        host[r["name"]] = host.get(r["name"], 0.0) + r["dur"] / 1e3
    return device, host, named


def device_events(prof):
    """The profile's device work by name (kernels, copies, fills), without
    the device-side spans of the ``record_function`` ranges, which overlap
    the kernels inside them."""
    from torch.autograd import DeviceType

    ranges = {name for name, _ in STAGE_RANGES + NERF_STAGE_RANGES
              + DMTET_STAGE_RANGES + VANILLA_STAGE_RANGES
              + SPLIT_STAGE_RANGES + CLI_RANGES}
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
    from dreamwaltz_g_tpu_torch.ops.blend import (
        _untile,
        blend_sorted,
        blend_sorted_reference,
        pack_rows,
    )
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
    blend_build = blend_builds(logs)

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
        err_avatar, avatar_stats = compare_blend(
            "avatar_frame0", avatar_args,
            blend_build["blend_sorted_kernel"])
        scene_args, _ = blend_inputs(random_scene(dev), RASTER["tile_size"],
                                     RASTER["capacity"],
                                     RASTER["max_tiles_per_gaussian"])
        err_scene, _ = compare_blend(
            "random_200k_D16", scene_args,
            blend_build["blend_sorted_kernel"])
        # the reenact frame: Motion-X-ReEnact's camera (its y row flipped,
        # fy negated) on 720 x 1280, whose last tile row is half a tile
        re_cam = reenact_camera(0)
        obs0 = type(frames)(*[x[0] for x in frames])
        gs0 = animate(model, state, obs0)
        re_args, _ = blend_inputs(
            R.project_gaussians(
                gs0.positions, R.covariance3d(gs0.quats, gs0.scales),
                gs0.opacities, gs0.colors,
                torch.as_tensor(re_cam["extrinsic"][0], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(re_cam["intrinsics"][0], dtype=torch.float32,
                                device=dev), REENACT_H, REENACT_W,
                tanfov=torch.tensor(float(re_cam["tanfov"][0]), device=dev),
                alive=gs0.alive),
            RASTER["tile_size"], RASTER["capacity"],
            RASTER["max_tiles_per_gaussian"], REENACT_H, REENACT_W)
        err_reenact, _ = compare_blend(
            "avatar_reenact_720x1280", re_args,
            blend_build["blend_sorted_kernel"], REENACT_H, REENACT_W)
        del re_args, gs0

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
        # the kernel alone, and the wrapper's two torch ops around it
        alone_ms = {
            label: named_ms(kernel_device_ms(
                lambda: blend_sorted(*a, H, W, **bkw), 20)[1],
                "blend_sorted_kernel")
            for label, a in (("avatar", avatar_args),
                             ("random_200k", scene_args))}
        tiled0 = torch.zeros((avatar_args[1].numel(),
                              RASTER["tile_size"] ** 2, 8), device=dev)
        pack_ms = cuda_ms(lambda: pack_rows(*avatar_args[3:]), 20)
        untile_ms = cuda_ms(lambda: _untile(tiled0, 5, H, W,
                                            RASTER["tile_size"]), 20)
    stage_ms["blend"] = kernel_ms

    # bound of blend_sorted on the avatar frame: each input read once, the
    # output written once; the operations this frame's kept pairs and the
    # blocks' boxes need (``ops_unculled``: every reached pair)
    s_idx, seg_start, counts, means2d, conic, op, values = avatar_args
    n = means2d.shape[0]
    bytes_moved = (4 * int(counts.sum()) + 4 * 2 * seg_start.numel()
                   + 4 * n * (2 + 3 + 1 + values.shape[1])
                   + 4 * H * W * values.shape[1])
    ops, ops_ms = cull_ops_ms(avatar_stats, OPS_PER_BLENDED_PAIR)
    ops_unculled = (OPS_PER_PAIR * avatar_stats["pairs"]
                    + OPS_PER_BLENDED_PAIR * avatar_stats["blended"])
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit(phase="times", ms_per_frame=frame_ms,
         fps=1e3 / sorted(frame_ms)[1], stage_ms=stage_ms,
         blend_kernel_ms=kernel_ms, blend_plain_ms=plain_ms,
         blend_kernel_ms_random_200k=scene_kernel_ms,
         blend_kernel_alone_ms=alone_ms["avatar"],
         blend_kernel_alone_ms_random_200k=alone_ms["random_200k"],
         blend_pack_rows_ms=pack_ms, blend_untile_ms=untile_ms,
         blend_bytes=bytes_moved, blend_ops=ops,
         blend_ops_unculled=ops_unculled, blend_bytes_ms=bytes_ms,
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
         blend_kernel_ms_per_frame=sum(
             e.device_time_total for e in on_card
             if "blend_sorted_kernel" in e.key) / 1e3 / N_FRAMES
         if on_card else None,
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
        train_build = {k: v for k, v in blend_build.items()
                       if k != "blend_sorted_kernel"}
        errs_avatar = compare_train_blend("avatar_512", t_args, t_values,
                                          tiles_x, train_build)
        g_scene = random_scene(dev, TRAIN_H, TRAIN_W)
        s_args, s_values, _ = panel_args(g_scene, TRAIN_H, TRAIN_W,
                                         TRAIN_RASTER)
        errs_scene = compare_train_blend("random_200k_512", s_args, s_values,
                                         tiles_x, train_build)

    # -- flash attention against its plain version at the paths' shapes ----
    from dreamwaltz_g_tpu_torch.configs import GuideConfig
    from dreamwaltz_g_tpu_torch.guidance import flash as FL
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.guidance.sds import build_pixel_grad_hook
    from dreamwaltz_g_tpu_torch.guidance.time_prior import (
        TimePrioritizedScheduler,
    )
    from dreamwaltz_g_tpu_torch.training.trainer import guidance_dtype

    flash_err = compare_flash(dev)

    # -- the tiny SDS step: CPU plain versions vs card kernels -------------
    small_train(dev)

    # -- the text tower: its embeddings condition every SDS phase below ----
    embeds = clip_text(dev)

    # -- the training path: counts to 0, 3 + 10 steps, counts read ---------
    if TL.FLASH_ATTENTION != "auto":
        fail(f"FLASH_ATTENTION is {TL.FLASH_ATTENTION!r}, not its default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guidance, gparams = build_guidance(
        dev, guidance_dtype(GuideConfig().dtype))
    torch.cuda.synchronize()
    guidance_s = time.perf_counter() - t0
    guide_cfg = GuideConfig()
    tx = build_avatar_optimizer(RenderConfig(), MAX_STEPS)
    tstate = init_avatar_train_state(state, tx, model)
    # None at the config's defaults, as in the default trainer
    pgc = build_pixel_grad_hook(guide_cfg)
    step = make_avatar_sds_step(model, guidance, TRAIN_H, TRAIN_W, pgc=pgc,
                                device=dev, **TRAIN_RASTER)
    sched = TimePrioritizedScheduler(guide_cfg, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt = torch.bfloat16
    # the first prompt's embedding and the null prompt's, cast to the
    # guidance's type as the trainer casts them
    txt, unc = embeds[:1].to(dt), embeds[-1:].to(dt)
    cond = torch.as_tensor(
        openpose_canvas(model, obs0, tcams.extrinsic[0], tcams.intrinsics[0],
                        TRAIN_H, TRAIN_W), device=dev)[None].to(dt)
    bg_train = torch.zeros((TRAIN_H, TRAIN_W, 3), device=dev)
    step_in = (obs0, tcams.extrinsic[0], tcams.intrinsics[0],
               tcams.tanfov[0], bg_train, txt, unc)
    timesteps, scales = [], []

    def sds_step(tstate):
        """One step of the run: the scheduler's timestep and guidance scale
        for the 1-based iteration, as the trainer asks for them."""
        it = tstate.step + 1
        t = sched.get_timestep(1, it, MAX_STEPS)
        gs = sched.get_guidance_scale(it, MAX_STEPS)
        timesteps.append(int(t[0]))
        scales.append(gs)
        return step(tstate, gparams, *step_in,
                    torch.as_tensor(t, device=dev), cond_image=cond,
                    guidance_scale=gs, generator=gen)

    before = params_snapshot(state, model)
    train_fns = {"blend_sorted": blend_sorted,
                 "blend_train_fwd": BT.blend_train_fwd,
                 "blend_train_bwd": BT.blend_train_bwd,
                 "blend_tiles_eval": BT.blend_tiles_eval_panels,
                 "flash_attn_fwd": FL.flash_attn_fwd,
                 "flash_attn_bwd": FL.flash_attn_bwd}
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
        tstate, metrics = sds_step(tstate)
        losses.append(float(metrics["loss"]))
        overflows.append(float(metrics["tile_overflow"]))
        step_s.append(time.perf_counter() - t0)
    end_ev.record()
    torch.cuda.synchronize()
    train_ms = start_ev.elapsed_time(end_ev) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    train_launches = {name: fn.launches for name, fn in train_fns.items()}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    flash_per_step = expected_flash_launches(gparams, guidance.latent_size)
    if flash_per_step != FLASH_PER_STEP:
        fail(f"the SD1.5-size stack's structure gives {flash_per_step} flash "
             f"launches a step, not {FLASH_PER_STEP}")
    want = {"blend_train_fwd": n_steps, "blend_train_bwd": n_steps,
            "blend_sorted": 0, "blend_tiles_eval": 0,
            "flash_attn_fwd": flash_per_step[0] * n_steps,
            "flash_attn_bwd": flash_per_step[1] * n_steps}
    for name, n in want.items():
        if train_launches[name] != n:
            fail(f"{name} launched {train_launches[name]} times in "
                 f"{n_steps} steps, expected {n}")
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
         peak_mem_gib=peak_gib, flash_attention=TL.FLASH_ATTENTION,
         flash_launches_per_step=list(flash_per_step),
         timesteps=timesteps, guidance_scales=scales,
         pixel_grad_hook=None if pgc is None else "set",
         cond_coverage=float((cond.float().amax(-1) > 0).float().mean()),
         **card)
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
    flash_rows = flash_times(dev, logs["flash_attn"])

    # the same run with einsum attention ("off"), the (B, H, N, N) scores
    # in device memory: its step time and its peak memory beside flash's
    TL.FLASH_ATTENTION = "off"
    n_fwd = FL.flash_attn_fwd.launches
    torch.cuda.reset_peak_memory_stats()
    for i in range(OFF_WARMUP + OFF_STEPS):
        if i == OFF_WARMUP:
            torch.cuda.synchronize()
            start_ev.record()
        tstate, metrics = sds_step(tstate)
    end_ev.record()
    torch.cuda.synchronize()
    TL.FLASH_ATTENTION = "auto"
    off_ms = start_ev.elapsed_time(end_ev) / OFF_STEPS
    off_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if FL.flash_attn_fwd.launches != n_fwd:
        fail('flash launched under FLASH_ATTENTION = "off"')
    if not math.isfinite(float(metrics["loss"])):
        fail("non-finite SDS loss with einsum attention")
    emit(phase="train_times", sds_step_ms=train_ms,
         sds_it_per_s=1e3 / train_ms, flash_attention="auto",
         sds_step_ms_flash_off=off_ms, sds_it_per_s_flash_off=1e3 / off_ms,
         flash_off_steps=[OFF_WARMUP, OFF_STEPS],
         peak_mem_gib=peak_gib, peak_mem_gib_flash_off=off_peak_gib,
         kernel_ms=k_ms, kernel_alone_ms=errs_avatar[4], plain_ms=p_ms,
         bounds=bounds, flash=flash_rows,
         tile_overflow_frame=t_overflow, **card)
    # the einsum path holds the (2, 8, 4096, 4096) scores (0.5 GiB in bf16,
    # 1 GiB as the float32 softmax) at the step's peak; flash must not
    if not peak_gib < off_peak_gib:
        fail(f"peak memory with flash {peak_gib} GiB is not below the "
             f"einsum path's {off_peak_gib} GiB")

    # -- busy share, stage breakdown and top kernels over one SDS step, -----
    # before densification (the dead slots lie at the origin) and after
    # (the buffer is full)
    def profile_step(tstate):
        """One profiled SDS step: (the new state, the phase's fields)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tstate, metrics = sds_step(tstate)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        on_card = device_events(prof)
        busy_ms = sum(e.device_time_total for e in on_card) / 1e3
        top = sorted(on_card, key=lambda e: -e.device_time_total)[:12]
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        trace = kernels.BUILD_DIR / "sds_step_trace.json"
        prof.export_chrome_trace(str(trace))
        stage_dev, stage_host, named = stage_times(trace)
        return tstate, dict(
            steps=1, wall_ms=wall_ms, loss=float(metrics["loss"]),
            device_busy_ms=busy_ms if on_card else None,
            device_busy_share=busy_ms / wall_ms if on_card else None,
            kernel_launches=sum(e.count for e in on_card),
            stage_device_ms=stage_dev, stage_host_ms=stage_host,
            blend_fwd_b1_kernel_ms=named["blend_fwd"],
            backward_blend_train_bwd_kernel_ms=named["blend_bwd"],
            flash_fwd_kernels_ms=named["flash_fwd"] + named["flash_combine"],
            flash_bwd_kernels_ms=named["flash_bwd"] + named["flash_delta"],
            index_backward_kernels_ms=named["indexing_backward"],
            alive=int(tstate.avatar.alive.sum()),
            top_kernels=[[e.key[:80], e.device_time_total / 1e3, e.count]
                         for e in top], **card)

    tstate, line = profile_step(tstate)
    emit(phase="train_profile", **line)

    # -- densification on the full avatar, then the step with a full buffer --
    tstate = train_densify(tstate, model, sds_step, gen)
    tstate, line = profile_step(tstate)
    emit(phase="train_profile_densified", **line)

    # -- stage 1: the tiny NeRF step (CPU vs card), then the full-width ----
    # NeRF SDS step through the same bf16 guidance, and its profile
    small_nerf_train(dev)
    nerf_flash = nerf_train(dev, card, guidance, gparams, model, embeds,
                            train_fns)

    # -- the float32-guidance step: the same avatar, step, scheduler and
    # raster settings with the UNet, ControlNet and VAE in float32 (the JAX
    # package's guide.dtype = "fp32"); every flash call then takes float32
    guidance = gparams = step = None
    torch.cuda.empty_cache()
    guidance, gparams = build_guidance(
        dev, guidance_dtype(GuideConfig(dtype="fp32").dtype))
    step = make_avatar_sds_step(model, guidance, TRAIN_H, TRAIN_W, pgc=pgc,
                                device=dev, **TRAIN_RASTER)
    txt, unc, cond = (x.float() for x in (txt, unc, cond))
    step_in = step_in[:5] + (txt, unc)
    fwd_fn, bwd_fn = FL.flash_attn_fwd, FL.flash_attn_bwd
    launch_fn, types = FL._launch, []

    def typed_launch(fn_name, dev_, *args):
        types.append(args[0].dtype)    # q's type, at each kernel launch
        return launch_fn(fn_name, dev_, *args)

    FL._launch = typed_launch
    try:
        fwd_fn.launches = bwd_fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        f32_losses = []
        for i in range(F32_WARMUP + F32_STEPS):
            if i == F32_WARMUP:
                torch.cuda.synchronize()
                start_ev.record()
            tstate, metrics = sds_step(tstate)
            f32_losses.append(float(metrics["loss"]))
        end_ev.record()
        torch.cuda.synchronize()
        f32_ms = start_ev.elapsed_time(end_ev) / F32_STEPS
        f32_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        f32_launches = [fwd_fn.launches, bwd_fn.launches]
        f32_types = sorted({str(t) for t in types})
        if len(types) != sum(f32_launches):
            fail(f"float32 step: {len(types)} kernel launches for "
                 f"{f32_launches} counted")
        TL.FLASH_ATTENTION = "off"
        for i in range(F32_OFF_WARMUP + F32_OFF_STEPS):
            if i == F32_OFF_WARMUP:
                torch.cuda.synchronize()
                start_ev.record()
            tstate, metrics = sds_step(tstate)
            f32_losses.append(float(metrics["loss"]))
        end_ev.record()
        torch.cuda.synchronize()
        TL.FLASH_ATTENTION = "auto"
        f32_off_ms = start_ev.elapsed_time(end_ev) / F32_OFF_STEPS
        off_launches = [fwd_fn.launches, bwd_fn.launches]
        tstate, line = profile_step(tstate)
        f32_losses.append(line["loss"])
    finally:
        FL._launch = launch_fn
        TL.FLASH_ATTENTION = "auto"
    n_f32 = F32_WARMUP + F32_STEPS
    emit(phase="train_f32", guidance_dtype="float32",
         steps=[F32_WARMUP, F32_STEPS], off_steps=[F32_OFF_WARMUP,
                                                    F32_OFF_STEPS],
         sds_step_ms=f32_ms, sds_step_ms_flash_off=f32_off_ms,
         launches=f32_launches, flash_call_types=f32_types,
         loss=f32_losses, peak_mem_gib=f32_peak,
         profile={k: line[k] for k in (
             "wall_ms", "device_busy_ms", "device_busy_share",
             "kernel_launches", "stage_device_ms", "flash_fwd_kernels_ms",
             "flash_bwd_kernels_ms", "top_kernels")}, **card)
    if f32_launches != [FLASH_PER_STEP[0] * n_f32, FLASH_PER_STEP[1] * n_f32]:
        fail(f"float32 step: flash launched {f32_launches} times in {n_f32} "
             f"steps, expected {FLASH_PER_STEP} a step")
    if off_launches != f32_launches:
        fail('float32 step: flash launched under FLASH_ATTENTION = "off"')
    if f32_types != ["torch.float32"]:
        fail(f"float32 step: flash took {f32_types}")
    if not all(math.isfinite(x) for x in f32_losses):
        fail("non-finite SDS loss with float32 guidance")

    # -- the two-stage run through the port's CLI --------------------------
    guidance = gparams = step = tstate = None
    torch.cuda.empty_cache()
    cli_runs, inference_runs, mode_runs, geometry_runs, scene_runs = \
        cli_two_stage(dev, card, train_fns, frame_ms)
    cli = {name: sum(run[name] for run in list(cli_runs.values())
                     + list(inference_runs.values())
                     + list(mode_runs.values())
                     + list(geometry_runs.values())
                     + list(scene_runs.values()))
           for name in train_fns}

    def entry(name, source, replaces, launches, err, ms, plain, bound,
              library=None, **more):
        # kernel_ms: the kernels alone (profiler), for every entry below
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "library_ms": library, **more}

    # a flash entry's ms, plain_ms, bound_ms and library_ms are those of the
    # shape that does most of a step's work in that kernel: (2, 4096, 8, 40)
    # forward, (1, 4096, 1, 512) backward; every shape stands in by_shape
    flash_src = "dreamwaltz_g_tpu_torch/csrc/flash_attn.cu"
    flash_replaces = "dreamwaltz_g_tpu/guidance/layers.py:153"
    f_fwd, _, f_bwd = flash_rows[:3]

    train_src = "dreamwaltz_g_tpu_torch/csrc/blend_train.cu"
    print(json.dumps({"kernels": [
        entry("blend_sorted", "dreamwaltz_g_tpu_torch/csrc/blend_sorted.cu",
              "dreamwaltz_g_tpu/ops/pallas_blend.py:326",
              launches["blend_sorted"] + cli["blend_sorted"],
              max(err_avatar, err_scene, err_reenact),
              kernel_ms, plain_ms,
              {"bound_ms": bound_ms,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"},
              kernel_ms=alone_ms["avatar"],
              launches_by_path={"render": launches["blend_sorted"],
                                "cli": cli["blend_sorted"],
                                "cli_by_run": {
                                    k: v["blend_sorted"]
                                    for k, v in inference_runs.items()},
                                "cli_geometry": {
                                    k: v["blend_sorted"]
                                    for k, v in geometry_runs.items()},
                                "cli_scene": {
                                    k: v["blend_sorted"]
                                    for k, v in scene_runs.items()}}),
        entry("blend_train_fwd", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:579",
              train_launches["blend_train_fwd"] + cli["blend_train_fwd"],
              max(errs_avatar[0], errs_scene[0]), k_ms["blend_train_fwd"],
              p_ms["blend_train_fwd"], bounds["blend_train_fwd"],
              kernel_ms=errs_avatar[4]["blend_train_fwd"],
              launches_by_path={"train": train_launches["blend_train_fwd"],
                                "cli": cli["blend_train_fwd"],
                                "cli_modes": {
                                    k: v["blend_train_fwd"]
                                    for k, v in mode_runs.items()},
                                "cli_geometry": {
                                    k: v["blend_train_fwd"]
                                    for k, v in geometry_runs.items()},
                                "cli_scene": {
                                    k: v["blend_train_fwd"]
                                    for k, v in scene_runs.items()}}),
        entry("blend_train_bwd", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:579",
              train_launches["blend_train_bwd"] + cli["blend_train_bwd"],
              max(errs_avatar[1], errs_scene[1]), k_ms["blend_train_bwd"],
              p_ms["blend_train_bwd"], bounds["blend_train_bwd"],
              kernel_ms=errs_avatar[4]["blend_train_bwd"],
              launches_by_path={"train": train_launches["blend_train_bwd"],
                                "cli": cli["blend_train_bwd"],
                                "cli_modes": {
                                    k: v["blend_train_bwd"]
                                    for k, v in mode_runs.items()},
                                "cli_geometry": {
                                    k: v["blend_train_bwd"]
                                    for k, v in geometry_runs.items()},
                                "cli_scene": {
                                    k: v["blend_train_bwd"]
                                    for k, v in scene_runs.items()}}),
        entry("blend_tiles_eval", train_src,
              "dreamwaltz_g_tpu/ops/pallas_blend.py:126",
              train_launches["blend_tiles_eval"],
              max(errs_avatar[2], errs_scene[2]), k_ms["blend_tiles_eval"],
              p_ms["blend_tiles_eval"], bounds["blend_tiles_eval"],
              kernel_ms=errs_avatar[4]["blend_tiles_eval"]),
        entry("flash_attn_fwd", flash_src, flash_replaces,
              train_launches["flash_attn_fwd"] + nerf_flash[0]
              + cli["flash_attn_fwd"],
              flash_err["fwd"],
              f_fwd["fwd_ms"], f_fwd["fwd_plain_ms"], f_fwd["fwd_bound"],
              library=f_fwd["library"]["fwd_ms"], shape=f_fwd["shape"],
              kernel_ms=f_fwd["fwd_kernel_ms"],
              launches_by_path={"train": train_launches["flash_attn_fwd"],
                                "nerf_train": nerf_flash[0],
                                "cli": cli["flash_attn_fwd"],
                                "cli_modes": {
                                    k: v["flash_attn_fwd"]
                                    for k, v in mode_runs.items()},
                                "cli_geometry": {
                                    k: v["flash_attn_fwd"]
                                    for k, v in geometry_runs.items()},
                                "cli_scene": {
                                    k: v["flash_attn_fwd"]
                                    for k, v in scene_runs.items()}},
              by_shape=[{"shape": r["shape"], "type": r["type"],
                         "kernel": r["build"]["kernel"]
                         + (" + " + r["build"]["combine"]["kernel"]
                            if "combine" in r["build"] else ""),
                         "ms": r["fwd_ms"], "plain_ms": r["fwd_plain_ms"],
                         "kernel_ms": r["fwd_kernel_ms"],
                         "kernel_launch_median_ms":
                             r["fwd_kernel_launch_median_ms"],
                         "einsum_ms": r["fwd_einsum_ms"],
                         "bound_ms": r["fwd_bound"]["bound_ms"],
                         "library_ms": r["library"]["fwd_ms"]}
                        for r in flash_rows]),
        entry("flash_attn_bwd", flash_src, flash_replaces,
              train_launches["flash_attn_bwd"] + nerf_flash[1]
              + cli["flash_attn_bwd"],
              flash_err["bwd"],
              f_bwd["bwd_ms"], f_bwd["bwd_plain_ms"], f_bwd["bwd_bound"],
              library=f_bwd["library"]["bwd_ms"], shape=f_bwd["shape"],
              kernel_ms=f_bwd["bwd_kernel_ms"],
              launches_by_path={"train": train_launches["flash_attn_bwd"],
                                "nerf_train": nerf_flash[1],
                                "cli": cli["flash_attn_bwd"],
                                "cli_geometry": {
                                    k: v["flash_attn_bwd"]
                                    for k, v in geometry_runs.items()},
                                "cli_scene": {
                                    k: v["flash_attn_bwd"]
                                    for k, v in scene_runs.items()}},
              by_shape=[{"shape": r["shape"], "type": r["type"],
                         "kernel": " + ".join(x["kernel"]
                                              for x in r["bwd_build"]),
                         "ms": r["bwd_ms"], "plain_ms": r["bwd_plain_ms"],
                         "kernel_ms": r["bwd_kernel_ms"],
                         "kernel_launch_median_ms":
                             r["bwd_kernel_launch_median_ms"],
                         "bound_ms": r["bwd_bound"]["bound_ms"],
                         "library_ms": r["library"]["bwd_ms"]}
                        for r in flash_rows if "bwd_ms" in r]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

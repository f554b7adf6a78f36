"""Stage-1 backbone quality: the hash grid (2^19 tables, bf16) against the
triplane, on the NeRF pretrain objective.

The twin of the JAX package's ``scripts/compare_backbones.py``. SDS needs
real Stable Diffusion weights; the pretrain objective (depth and mask MSE
against renders of the SMPL-X body, ``training/nerf_trainer.py:
make_pretrain_step``) is a real convergence target that trains the same
field and marcher and needs no licensed asset (a synthetic body). Both
backbones train the same budget on the same camera stream, then are scored
(``score_field``) on
* the held-out mask / depth MSE over 20 fixed eval views,
* the geometry of the point cloud that the stage-1 -> stage-2 export makes
  (96^3, the configuration's ``export_min_neighbors``): cloud -> mesh RMS
  distance (accuracy) and mesh -> cloud RMS distance (coverage).

Prints one JSON line a backbone and, for both, a verdict line.

Usage:
    python -m dreamwaltz_g_tpu_torch.scripts.compare_backbones \\
        [--iters N] [--res H] [--cpu] [--backbone hash|triplane|both] \\
        [--out rows.jsonl] [--state-file state.pt [--resume]]
    python -m dreamwaltz_g_tpu_torch.scripts.compare_backbones \\
        --verdict-from hash.jsonl triplane.jsonl

``--state-file`` saves the run's state (``torch.save``: the field, its
optimizer state, the occupancy grid, the generator, the step) every
``--chunk`` iterations and at the end; ``--resume`` continues from it;
``rescore_backbone_state`` scores it again.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

# the held-out views (azimuth, elevation), apart from the training draws
EVAL_VIEWS = [(a, e) for a in range(0, 360, 72)
              for e in (15.0, 45.0, 75.0, -15.0)]
EXPORT_RESOLUTION = 96
EXPORT_MAX_POINTS = 20_000
PRETRAIN_STEPS = 96          # samples a ray of the pretrain step
OCCUPANCY_INTERVAL = 16
SPECS = {"hash": "hash_2^19_bf16", "triplane": "triplane"}


def backbone_config(name: str):
    """The field configuration of a backbone ('hash' or 'triplane')."""
    from ..configs import NeRFConfig

    if name == "hash":
        return NeRFConfig(backbone="tiledgrid", grid_dtype="bf16")
    return NeRFConfig(backbone="triplane")


def synthetic_body(device):
    """The synthetic body's posed vertices (V, 3) and faces (F, 3)."""
    import torch

    from ..human.smplx_model import (
        default_params,
        make_synthetic_model,
        smplx_forward,
    )

    smpl = make_synthetic_model(num_vertices=240, num_joints=6, num_betas=3,
                                num_expr=2, device=device)
    with torch.no_grad():
        verts = smplx_forward(smpl, default_params(smpl, 1)).vertices[0]
    return verts, torch.as_tensor(smpl.faces, device=verts.device).long()


def cameras(azimuths, elevations, H, W, device):
    """Cameras at radius 2 and a 50 degree field of view."""
    from ..data.camera import make_camera_batch

    n = len(azimuths)
    return make_camera_batch([2.0] * n, list(azimuths), list(elevations),
                             [50.0] * n, H, W, device=device)


def ground_truth(verts, faces, cams, H, W):
    """Each camera's metric depth (0 off the body) and mask, (B, H, W)."""
    import torch

    from ..ops.raycast import rasterize_mesh

    depths, masks = [], []
    with torch.no_grad():
        for i in range(cams.c2w.shape[0]):
            r = rasterize_mesh(verts, faces, cams.extrinsic[i],
                               cams.intrinsics[i], H, W)
            depths.append(torch.where(r.mask, r.depth, 0.0))
            masks.append(r.mask)
    return torch.stack(depths), torch.stack(masks)


def eval_views(verts, faces, H, W, device) -> dict:
    """The 20 held-out views: cameras (``c2w``, ``intr``) and their
    ground-truth ``depth`` and ``mask``."""
    cams = cameras([a for a, _ in EVAL_VIEWS], [e for _, e in EVAL_VIEWS],
                   H, W, device)
    depth, mask = ground_truth(verts, faces, cams, H, W)
    return {"c2w": cams.c2w, "intr": cams.intrinsics, "depth": depth,
            "mask": mask}


def score_field(nerf, grid, views: dict, verts, faces, jitters=None,
                generator=None, num_steps: int = PRETRAIN_STEPS,
                compact_steps: int = 0) -> dict:
    """The field's scores, unrounded: the pretrain's mask and depth MSE
    averaged over ``views`` (``eval_views``' layout; each view's
    stratification ``jitters[j]`` (H W, num_steps), else drawn from
    ``generator``), and its exported cloud (96^3, the field's
    ``density_thresh`` and ``export_min_neighbors``, at most 20k points)
    against the mesh: ``cloud_to_mesh_rms`` (each point to its nearest
    triangle), ``mesh_to_cloud_rms`` (each vertex to its nearest point),
    NaN for an empty cloud, and ``n_cloud_points``."""
    import torch

    from ..nerf.export import export_point_cloud
    from ..training.nerf_trainer import pretrain_losses

    H, W = views["mask"].shape[1:]
    mask_mse, depth_mse = [], []
    with torch.no_grad():
        for j in range(views["mask"].shape[0]):
            jitter = None if jitters is None else jitters[j]
            if jitter is None:
                jitter = torch.rand((H * W, num_steps), generator=generator,
                                    device=nerf.device)
            m, d = pretrain_losses(
                nerf, grid, views["c2w"][j], views["intr"][j],
                views["depth"][j], views["mask"][j], jitter,
                num_steps=num_steps, compact_steps=compact_steps)
            mask_mse.append(float(m))
            depth_mse.append(float(d))
    cfg = nerf.cfg
    pc = export_point_cloud(nerf, resolution=EXPORT_RESOLUTION,
                            density_thresh=cfg.density_thresh,
                            max_points=EXPORT_MAX_POINTS,
                            min_neighbors=cfg.export_min_neighbors)
    return dict(eval_mask_mse=float(np.mean(mask_mse)),
                eval_depth_mse=float(np.mean(depth_mse)),
                **cloud_scores(pc.points, verts, faces))


def cloud_scores(points, verts, faces) -> dict:
    """Accuracy and coverage of a cloud (N, 3) against the mesh."""
    import torch

    from ..ops.mesh import find_nearest_triangles, knn

    cloud = torch.as_tensor(points, device=verts.device)
    acc = cov = math.nan
    if cloud.shape[0] > 0:
        near = find_nearest_triangles(cloud, verts, faces)
        acc = float(torch.sqrt(torch.mean(near.sq_dists)))
        d2, _ = knn(verts, cloud, 1)
        cov = float(torch.sqrt(torch.mean(d2)))
    return {"cloud_to_mesh_rms": acc, "mesh_to_cloud_rms": cov,
            "n_cloud_points": int(cloud.shape[0])}


def build_field(name: str, iters: int, device):
    """A backbone's fresh field (no background), its train state and its
    64^3 occupancy grid."""
    import torch

    from ..nerf.network import build_nerf
    from ..nerf.renderer import init_occupancy
    from ..training.nerf_trainer import init_train_state
    from ..training.optim import build_nerf_optimizer

    ncfg = backbone_config(name)
    nerf = build_nerf(ncfg, with_background=False, device=device,
                      generator=torch.Generator(device).manual_seed(1))
    tstate = init_train_state(nerf, build_nerf_optimizer(ncfg, iters))
    return nerf, tstate, init_occupancy(64, device=device)


def save_state(path, name, step, train_s, tstate, grid, gen) -> None:
    """The run's state as one ``torch.save`` file, replaced atomically."""
    import torch

    from ..training.trainer import _opt_tree

    tmp = f"{path}.tmp"
    torch.save({"backbone": name, "step": step, "train_seconds": train_s,
                "params": tstate.model.state_dict(),
                "opt_state": _opt_tree(tstate.opt_state),
                "grid": grid._asdict(), "generator": gen.get_state()}, tmp)
    os.replace(tmp, path)


def load_state(path, device):
    """A state file of ``save_state`` (tensors on ``device``)."""
    import torch

    return torch.load(path, map_location=device, weights_only=True)


def run(name: str, args, verts, faces, views, device) -> dict:
    """Train one backbone ``args.iters`` pretrain steps and score it."""
    import torch

    from ..nerf.renderer import OccupancyGrid, update_occupancy
    from ..training.nerf_trainer import NeRFTrainState, make_pretrain_step
    from ..training.trainer import _load_opt_tree

    H = W = args.res
    nerf, tstate, grid = build_field(name, args.iters, device)
    ncfg = nerf.cfg
    step = make_pretrain_step(nerf, H, W, num_steps=PRETRAIN_STEPS,
                              compact_steps=0, device=device)
    rng = np.random.default_rng(0)
    azims = rng.uniform(0, 360, args.iters).astype(np.float32)
    elevs = rng.uniform(-30, 80, args.iters).astype(np.float32)
    gen = torch.Generator(device).manual_seed(2)
    start, train_s = 0, 0.0
    if args.resume and args.state_file and os.path.exists(args.state_file):
        saved = load_state(args.state_file, device)
        with torch.no_grad():
            nerf.load_state_dict(saved["params"])
        _load_opt_tree(tstate.opt_state, saved["opt_state"])
        grid = OccupancyGrid(**saved["grid"])
        gen.set_state(saved["generator"].cpu())
        start, train_s = int(saved["step"]), float(saved["train_seconds"])
        tstate = NeRFTrainState(nerf, tstate.opt_state, start)
        print(json.dumps({"resumed_at_step": start, "backbone": name}),
              flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    for i in range(start, args.iters):
        cams = cameras([azims[i]], [elevs[i]], H, W, device)
        depth, mask = ground_truth(verts, faces, cams, H, W)
        sync()
        t0 = time.perf_counter()
        if i % OCCUPANCY_INTERVAL == 0:
            grid = update_occupancy(grid, nerf, generator=gen,
                                    density_thresh=ncfg.density_thresh)
        tstate, _ = step(tstate, grid, cams.c2w[0], cams.intrinsics[0],
                         depth[0], mask[0], generator=gen)
        sync()
        train_s += time.perf_counter() - t0
        if args.state_file and ((i + 1) % args.chunk == 0
                                or i + 1 == args.iters):
            save_state(args.state_file, name, i + 1, train_s, tstate, grid,
                       gen)
    scores = score_field(nerf, grid, views, verts, faces,
                         generator=torch.Generator(device).manual_seed(7))
    row = {"backbone": SPECS[name], "iters": args.iters, "res": H,
           "eval_mask_mse": round(scores["eval_mask_mse"], 6),
           "eval_depth_mse": round(scores["eval_depth_mse"], 6),
           "cloud_to_mesh_rms": round(scores["cloud_to_mesh_rms"], 5),
           "mesh_to_cloud_rms": round(scores["mesh_to_cloud_rms"], 5),
           "n_cloud_points": scores["n_cloud_points"],
           "train_seconds": round(train_s, 1)}
    print(json.dumps(row), flush=True)
    return row


def _verdict(h, t):
    return {
        "verdict": "triplane_quality_vs_hash",
        "mask_mse_ratio": round(t["eval_mask_mse"]
                                / max(h["eval_mask_mse"], 1e-12), 3),
        "depth_mse_ratio": round(t["eval_depth_mse"]
                                 / max(h["eval_depth_mse"], 1e-12), 3),
        "cloud_to_mesh_ratio": round(t["cloud_to_mesh_rms"]
                                     / max(h["cloud_to_mesh_rms"], 1e-12), 3),
        "mesh_to_cloud_ratio": round(t["mesh_to_cloud_rms"]
                                     / max(h["mesh_to_cloud_rms"], 1e-12), 3),
        "speedup": round(h["train_seconds"] / max(t["train_seconds"], 1e-9),
                         2),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=60,
                    help="iterations between --state-file saves")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON rows here too")
    ap.add_argument("--backbone", choices=["hash", "triplane", "both"],
                    default="both")
    ap.add_argument("--state-file", default=None,
                    help="torch.save file of the run's state, saved every "
                    "--chunk iterations and at the end")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --state-file")
    ap.add_argument("--verdict-from", nargs=2, metavar="JSONL", default=None,
                    help="skip training; compute the verdict from two row "
                    "files written by earlier --backbone runs (hash first)")
    args = ap.parse_args(argv)

    if args.verdict_from:
        rows = []
        for path in args.verdict_from:
            with open(path) as f:
                rows += [json.loads(ln) for ln in f if ln.strip()]
        rows = [r for r in rows if "backbone" in r]
        h = next(r for r in rows if r["backbone"].startswith("hash"))
        t = next(r for r in rows if r["backbone"] == "triplane")
        verdict = _verdict(h, t)
        print(json.dumps(verdict), flush=True)
        return [verdict]

    from .._device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    verts, faces = synthetic_body(device)
    views = eval_views(verts, faces, args.res, args.res, device)
    wanted = ["hash", "triplane"] if args.backbone == "both" \
        else [args.backbone]
    rows = [run(k, args, verts, faces, views, device) for k in wanted]
    if len(rows) == 2:
        rows.append(_verdict(rows[0], rows[1]))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()

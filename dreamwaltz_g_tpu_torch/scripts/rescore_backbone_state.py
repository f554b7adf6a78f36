"""Score again the field of a ``compare_backbones`` state file through the
stage-1 -> stage-2 export (96^3, at most 20k points), once for each
``--min-neighbors`` of the isolated-cell filter
(``nerf/export.py:filter_isolated_cells``), against the same synthetic
body. The held-out mask / depth MSE do not depend on the export and stay
those of the run's row.

The twin of the JAX package's ``scripts/rescore_backbone_state.py``; the
state file is the port's (``torch.save``, written by
``compare_backbones --state-file``).

Usage:
    python -m dreamwaltz_g_tpu_torch.scripts.rescore_backbone_state \\
        state.pt --backbone triplane [--min-neighbors 0 2] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("state_file")
    ap.add_argument("--backbone", choices=["hash", "triplane"],
                    default="triplane")
    ap.add_argument("--iters", type=int, default=600,
                    help="the run's --iters (the file carries every shape; "
                    "kept for the JAX tool's command lines)")
    ap.add_argument("--min-neighbors", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..nerf.export import export_point_cloud
    from .compare_backbones import (
        EXPORT_MAX_POINTS,
        EXPORT_RESOLUTION,
        build_field,
        cloud_scores,
        load_state,
        synthetic_body,
    )

    device = resolve_device("cpu" if args.cpu else "cuda")
    verts, faces = synthetic_body(device)
    nerf, _, _ = build_field(args.backbone, args.iters, device)
    with torch.no_grad():
        nerf.load_state_dict(load_state(args.state_file, device)["params"])
    rows = []
    for mn in args.min_neighbors:
        pc = export_point_cloud(nerf, resolution=EXPORT_RESOLUTION,
                                density_thresh=nerf.cfg.density_thresh,
                                max_points=EXPORT_MAX_POINTS,
                                min_neighbors=mn)
        s = cloud_scores(pc.points, verts, faces)
        row = {"state_file": os.path.basename(args.state_file),
               "backbone": args.backbone, "min_neighbors": mn,
               "cloud_to_mesh_rms": round(s["cloud_to_mesh_rms"], 5),
               "mesh_to_cloud_rms": round(s["mesh_to_cloud_rms"], 5),
               "n_cloud_points": s["n_cloud_points"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

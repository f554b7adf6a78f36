"""Point cloud container and PLY IO.

Port of ``dreamwaltz_g_tpu/utils/point_cloud.py``: ``BasicPointCloud``,
``save_ply`` / ``load_ply``, and the trained-3DGS layout's
``load_gaussian_ply`` / ``save_gaussian_ply`` (the Gaussian background's
input): binary little-endian PLY in numpy, the same bytes as the JAX
package writes.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import NamedTuple, Optional

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray             # (N, 3)
    colors: Optional[np.ndarray] = None   # (N, 3) float [0, 1]
    normals: Optional[np.ndarray] = None  # (N, 3)


def save_ply(path: str, pc: BasicPointCloud) -> str:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    n = pc.points.shape[0]
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [np.asarray(pc.points, np.float32)]
    if pc.normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols.append(np.asarray(pc.normals, np.float32))
    if pc.colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append((np.clip(pc.colors, 0, 1) * 255).astype(np.uint8))

    dtype = np.dtype([(name, fmt) for name, fmt in props])
    rec = np.empty(n, dtype=dtype)
    i = 0
    for arr in cols:
        for c in range(arr.shape[1]):
            rec[props[i][0]] = arr[:, c]
            i += 1

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    type_names = {"f4": "float", "u1": "uchar"}
    header += [f"property {type_names[f]} {name}" for name, f in props]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
    return path


def _read_ply_records(path: str):
    with open(path, "rb") as f:
        # header
        props = []
        n = 0
        fmt = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property") and n > 0:
                _, t, name = line.split()
                props.append((name, {"float": "f4", "float32": "f4",
                                     "uchar": "u1", "uint8": "u1",
                                     "double": "f8"}[t]))
            elif line == "end_header":
                break
        assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
        rec = np.frombuffer(
            f.read(), dtype=np.dtype(props), count=n)
    return rec, [p[0] for p in props]


def load_ply(path: str) -> BasicPointCloud:
    rec, names = _read_ply_records(path)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    normals = None
    colors = None
    if "nx" in names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
    if "red" in names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                          -1).astype(np.float32) / 255.0
    return BasicPointCloud(points=pts, colors=colors, normals=normals)


def load_gaussian_ply(path: str, max_sh_degree: int = 3):
    """Read a trained-3DGS PLY (x/y/z, f_dc_*, f_rest_*, opacity, scale_*,
    rot_*) into raw parameter arrays (the
    ``--render.use_gs_background`` input).

    Returns a dict: positions (N,3), sh_dc (N,3), sh_rest (N,K,3) or None,
    opacity_logit (N,), log_scales (N,3), quats (N,4) — all in the PLY's
    raw (pre-activation) parameterization."""
    rec, names = _read_ply_records(path)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    n = pts.shape[0]
    sh_dc = np.stack([rec[f"f_dc_{i}"] for i in range(3)],
                     -1).astype(np.float32)
    rest_names = sorted((m for m in names if m.startswith("f_rest_")),
                        key=lambda m: int(m.split("_")[-1]))
    sh_rest = None
    if rest_names:
        flat = np.stack([rec[m] for m in rest_names], -1).astype(np.float32)
        k = flat.shape[1] // 3
        # 3DGS layout: channel-major (3, K) per point
        sh_rest = flat.reshape(n, 3, k).transpose(0, 2, 1)
    opacity = rec["opacity"].astype(np.float32)
    log_scales = np.stack([rec[f"scale_{i}"] for i in range(3)],
                          -1).astype(np.float32)
    quats = np.stack([rec[f"rot_{i}"] for i in range(4)],
                     -1).astype(np.float32)
    return {"positions": pts, "sh_dc": sh_dc, "sh_rest": sh_rest,
            "opacity_logit": opacity, "log_scales": log_scales,
            "quats": quats}


def save_gaussian_ply(path: str, positions, sh_dc, sh_rest, opacity_logit,
                      log_scales, quats) -> str:
    """Write the standard trained-3DGS PLY layout (field order x/y/z nx/ny/nz
    f_dc_* f_rest_* opacity scale_* rot_*)."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    cols = [("x", positions[:, 0]), ("y", positions[:, 1]),
            ("z", positions[:, 2]),
            ("nx", np.zeros(n, np.float32)), ("ny", np.zeros(n, np.float32)),
            ("nz", np.zeros(n, np.float32))]
    sh_dc = np.asarray(sh_dc, np.float32)
    cols += [(f"f_dc_{i}", sh_dc[:, i]) for i in range(3)]
    if sh_rest is not None and np.asarray(sh_rest).size:
        r = np.asarray(sh_rest, np.float32)          # (N, K, 3)
        flat = r.transpose(0, 2, 1).reshape(n, -1)   # channel-major
        cols += [(f"f_rest_{i}", flat[:, i]) for i in range(flat.shape[1])]
    cols.append(("opacity", np.asarray(opacity_logit,
                                       np.float32).reshape(n)))
    ls = np.asarray(log_scales, np.float32)
    cols += [(f"scale_{i}", ls[:, i]) for i in range(3)]
    q = np.asarray(quats, np.float32)
    cols += [(f"rot_{i}", q[:, i]) for i in range(4)]

    rec = np.empty(n, dtype=np.dtype([(name, "f4") for name, _ in cols]))
    for name, arr in cols:
        rec[name] = arr
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
    return path

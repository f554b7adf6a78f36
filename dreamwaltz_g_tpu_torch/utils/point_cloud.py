"""Point cloud container and PLY IO.

Port of ``BasicPointCloud``, ``save_ply`` and ``load_ply`` from
``dreamwaltz_g_tpu/utils/point_cloud.py``: binary little-endian PLY in
numpy, the same bytes as the JAX package writes. The trained-3DGS PLY
reader / writer (``load_gaussian_ply``, ``save_gaussian_ply``) is not
ported yet.
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

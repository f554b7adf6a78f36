"""SMPL-X keypoints in the OpenPose / ControlNet 128-point format.

Port of ``dreamwaltz_g_tpu/human/keypoints.py``: body 18 (coco18) + left
hand 21 + right hand 21 + 51 face landmarks + 17 contour points, built from
the SMPL-X forward's outputs in the smplx package's 144-joint layout
(55 skeleton joints, 21 surface vertices, 51 + 17 face landmarks from the
npz's landmark tables). Missing landmark tables give NaN rows, which the
drawing treats as absent keypoints.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .smplx_model import SMPLXModelData, SMPLXOutput

# Standard SMPL-X surface-landmark vertex ids (the smplx package's
# vertex_ids table; stable across SMPL-X releases).
SMPLX_VERTEX_IDS = {
    "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
    "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
    "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
    "lring": 5169, "lpinky": 5286,
    "rthumb": 8079, "rindex": 7669, "rmiddle": 7794,
    "rring": 7905, "rpinky": 8022,
}

# order matters: must match smplx's VertexJointSelector output layout
_EXTRA_VERTEX_ORDER = (
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
)

# coco18 permutation over the 144-joint layout
SMPLX_TO_OPENPOSE_COCO18_BODY = np.array([
    55, 12,          # nose, neck
    17, 19, 21,      # right shoulder/elbow/wrist
    16, 18, 20,      # left shoulder/elbow/wrist
    2, 5, 8,         # right hip/knee/ankle
    1, 4, 7,         # left hip/knee/ankle
    56, 57, 58, 59,  # right-eye, left-eye, right-ear, left-ear
], np.int32)

SMPLX_TO_OPENPOSE_LHAND = np.array([
    20,
    37, 38, 39, 66,
    25, 26, 27, 67,
    28, 29, 30, 68,
    34, 35, 36, 69,
    31, 32, 33, 70,
], np.int32)

SMPLX_TO_OPENPOSE_RHAND = np.array([
    21,
    52, 53, 54, 71,
    40, 41, 42, 72,
    43, 44, 45, 73,
    49, 50, 51, 74,
    46, 47, 48, 75,
], np.int32)

SMPLX_TO_OPENPOSE_FACE = np.arange(76, 76 + 51 + 17, dtype=np.int32)

SMPLX_TO_OPENPOSE_COCO18 = np.concatenate([
    SMPLX_TO_OPENPOSE_COCO18_BODY,
    SMPLX_TO_OPENPOSE_LHAND,
    SMPLX_TO_OPENPOSE_RHAND,
    SMPLX_TO_OPENPOSE_FACE,
])  # (128,)

NUM_OPENPOSE_KEYPOINTS = 128
NUM_BODY_KP, NUM_HAND_KP, NUM_FACE_KP = 18, 21, 68

# keypoint-group index sets within the 128
FACE_KP_INDICES = np.array(
    [0, 14, 15, 16, 17] + list(range(18 + 2 * 21, 128)), np.int32)
HAND_KP_INDICES = np.arange(18, 18 + 2 * 21, dtype=np.int32)
BODY_KP_INDICES = np.array(
    [i for i in range(128)
     if i not in set(FACE_KP_INDICES.tolist())
     and i not in set(HAND_KP_INDICES.tolist())], np.int32)

# head-yaw-dependent contour: see smplx find_dynamic_lmk_idx_and_bcoords;
# the chain from the root to the neck joint (SMPL-X joint 12)
NECK_KIN_CHAIN = (12, 9, 6, 3, 0)



class LandmarkData(NamedTuple):
    """Face-landmark regressors from the SMPL-X npz (optional)."""

    lmk_faces_idx: np.ndarray           # (51,) triangle ids
    lmk_bary_coords: np.ndarray         # (51, 3)
    dynamic_lmk_faces_idx: np.ndarray   # (79, 17)
    dynamic_lmk_bary_coords: np.ndarray  # (79, 17, 3)


def load_landmark_data(path: str) -> Optional[LandmarkData]:
    """The landmark tables of a SMPLX_*.npz, or None without them."""
    with np.load(path, allow_pickle=True) as data:
        if "lmk_faces_idx" not in data:
            return None
        dyn_f = data.get("dynamic_lmk_faces_idx")
        dyn_b = data.get("dynamic_lmk_bary_coords")
        return LandmarkData(
            lmk_faces_idx=np.asarray(data["lmk_faces_idx"], np.int64),
            lmk_bary_coords=np.asarray(data["lmk_bary_coords"], np.float32),
            dynamic_lmk_faces_idx=None if dyn_f is None
            else np.asarray(dyn_f, np.int64),
            dynamic_lmk_bary_coords=None if dyn_b is None
            else np.asarray(dyn_b, np.float32),
        )


def _dynamic_contour_index(A: torch.Tensor) -> torch.Tensor:
    """Head-yaw bucket in [0, 78] from the neck's global rotation: the
    rounded asin(R[0, 2]) in degrees, folded so 0..39 are right turns and
    40..78 left turns, clamped at 39."""
    R = A[:, NECK_KIN_CHAIN[0], :3, :3]
    y_rot = torch.arcsin(torch.clamp(R[:, 0, 2], -1.0, 1.0))
    deg = torch.round(torch.rad2deg(y_rot)).to(torch.int64)
    mag = torch.clamp(deg.abs(), 0, 39)
    return torch.where(deg < 0, 39 + mag, 39 - mag)


def full_joint_set(
    model: SMPLXModelData,
    output: SMPLXOutput,
    landmarks: Optional[LandmarkData] = None,
) -> torch.Tensor:
    """(B, 144, 3) joints in the smplx layout (55 skeleton + 21 vertex
    landmarks + 51 + 17 face landmarks); NaN rows where a table is
    missing."""
    B = output.vertices.shape[0]
    dev = output.vertices.device
    joints = output.joints  # (B, 55, 3)
    nan = float("nan")

    V = model.num_vertices
    if V > max(SMPLX_VERTEX_IDS.values()):
        vids = torch.as_tensor([SMPLX_VERTEX_IDS[k]
                                for k in _EXTRA_VERTEX_ORDER], device=dev)
        extra = output.vertices[:, vids]  # (B, 21, 3)
    else:  # synthetic test model: no surface landmarks
        extra = torch.full((B, len(_EXTRA_VERTEX_ORDER), 3), nan, device=dev)

    if landmarks is not None:
        faces = torch.as_tensor(model.faces, device=dev)
        lf = faces[torch.as_tensor(landmarks.lmk_faces_idx, device=dev)]
        lb = torch.as_tensor(landmarks.lmk_bary_coords, device=dev)
        static_lmk = torch.einsum("lk,blkc->blc", lb, output.vertices[:, lf])
        if landmarks.dynamic_lmk_faces_idx is not None:
            bucket = _dynamic_contour_index(output.A)           # (B,)
            dlf = torch.as_tensor(landmarks.dynamic_lmk_faces_idx,
                                  device=dev)[bucket]          # (B, 17)
            dlb = torch.as_tensor(landmarks.dynamic_lmk_bary_coords,
                                  device=dev)[bucket]          # (B, 17, 3)
            tri = output.vertices[torch.arange(B, device=dev)[:, None, None],
                                  faces[dlf]]
            contour = torch.einsum("blk,blkc->blc", dlb, tri)
        else:
            contour = torch.full((B, 17, 3), nan, device=dev)
        # the coco18 face block is [51 landmarks, 17 contour]
        face = torch.cat([static_lmk, contour], dim=1)
    else:
        face = torch.full((B, 68, 3), nan, device=dev)

    return torch.cat([joints, extra, face], dim=1)


def openpose_keypoints(
    model: SMPLXModelData,
    output: SMPLXOutput,
    landmarks: Optional[LandmarkData] = None,
) -> torch.Tensor:
    """(B, 128, 3) world-space keypoints in ControlNet-OpenPose order."""
    joints144 = full_joint_set(model, output, landmarks)
    # a body with fewer than 55 joints (the synthetic one) has a shorter
    # set; its indices clamp to the last row, as the JAX package's gather
    # clamps them
    idx = torch.as_tensor(SMPLX_TO_OPENPOSE_COCO18, device=joints144.device)
    return joints144[:, torch.clamp(idx, max=joints144.shape[1] - 1)]


def project_keypoints(
    keypoints: torch.Tensor,
    extrinsic: torch.Tensor,
    intrinsics: torch.Tensor,
) -> torch.Tensor:
    """World (N, K, 3) -> pixel (N, K, 2); points behind the camera are
    NaN."""
    cam = keypoints @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    z = cam[..., 2]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    z_safe = torch.where(z > 1e-8, z, torch.ones_like(z))
    u = fx * cam[..., 0] / z_safe + cx
    v = fy * cam[..., 1] / z_safe + cy
    pts = torch.stack([u, v], -1)
    return torch.where((z > 1e-8)[..., None], pts,
                       torch.full_like(pts, float("nan")))

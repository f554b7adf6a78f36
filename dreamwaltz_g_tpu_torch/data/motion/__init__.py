"""Motion sequence loading, preprocessing, and multi-person placement.

A copy of ``dreamwaltz_g_tpu/data/motion/__init__.py`` (plain numpy).

(reference: data/human/__init__.py:16-171 — DATASET_CARDS registry,
``load_smpl_sequences`` scene-string dispatch, ``preprocess_smpl_sequences``
frame slicing / betas+transl normalization / pelvis centering / TalkSHOW PCA
hand decode, and the multi-person translation patterns.)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .loaders import (
    AIST,
    AMASS,
    Demo,
    Hybrik,
    MotionX,
    MotionXReEnact,
    PW3D,
    TalkShow,
    Tram,
)

DATASET_CARDS = {
    "demo": Demo,
    "3dpw": PW3D,
    "amass": AMASS,
    "aist": AIST,
    "hybrik": Hybrik,
    "motionx": MotionX,
    "motionx_reenact": MotionXReEnact,
    "talkshow": TalkShow,
    "tram": Tram,
}

# datasets that also return predefined camera tracks
_WITH_CAMERAS = ("motionx_reenact", "tram")

# multi-person placement grid (reference: data/human/__init__.py:41-49)
_TRANSL_PATTERNS = {
    2: [[-1, 0, 0], [+1, 0, 0]],
    3: [[0, 0, +1], [-1, 0, 0], [+1, 0, 0]],
    4: [[+1, 0, +1], [+1, 0, -1], [-1, 0, +1], [-1, 0, -1]],
    5: [[+1, 0, +1], [+1, 0, -1], [0, 0, 0], [-1, 0, +1], [-1, 0, -1]],
}


def get_transl_pattern(num_person: int, spacing: float = 0.8) -> Optional[np.ndarray]:
    if num_person <= 1:
        return None
    return np.asarray(_TRANSL_PATTERNS[num_person], np.float32) * spacing


def expand_humans(smpl_seqs: Dict[str, np.ndarray], num_person: int,
                  spacing: float = 0.8) -> Dict[str, np.ndarray]:
    """Tile a single-person sequence to N persons on the placement grid
    (reference: expand_humans, data/human/__init__.py:38-49)."""
    out = {k: np.broadcast_to(v, (num_person,) + v.shape[1:]).copy()
           for k, v in smpl_seqs.items()}
    pattern = get_transl_pattern(num_person, spacing)
    if pattern is not None:
        F = out["body_pose"].shape[1]
        out["transl"] = np.broadcast_to(
            pattern[:, None, :], (num_person, F, 3)).copy()
    return out


def preprocess_smpl_sequences(
    smpl_seqs: Dict[str, np.ndarray],
    dataset: str,
    frame_range: Optional[Tuple[int, int]] = None,
    frame_interval: Optional[int] = None,
    num_person: Optional[int] = None,
    person_indices=None,
    pop_betas: bool = False,
    pop_transl: bool = False,
    centralize_pelvis: bool = True,
    pop_global_orient: bool = False,
    normalize_transl: bool = False,
    num_betas: Optional[int] = None,
    pelvis_position: Optional[np.ndarray] = None,
    hand_components: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """(reference: preprocess_smpl_sequences, data/human/__init__.py:85-171)

    Args:
        pelvis_position: (3,) canonical pelvis location for centering.
        hand_components: (L_comp, R_comp) PCA bases from the SMPL-X npz for
            decoding TalkSHOW's 12-dim hand coefficients.
    """
    seqs = dict(smpl_seqs)

    if num_person is not None or person_indices is not None:
        if person_indices is None:
            person_indices = list(range(num_person))
        seqs = {k: v[person_indices] for k, v in seqs.items()}

    if frame_range is not None or frame_interval is not None:
        if frame_range is None:
            frame_range = (0, seqs["body_pose"].shape[1])
        step = frame_interval or 1
        sel = range(frame_range[0], frame_range[1], step)
        seqs = {k: (v[:, list(sel)] if v.ndim >= 3 else v)
                for k, v in seqs.items()}

    if "betas" in seqs:
        if pop_betas:
            seqs.pop("betas")
        elif num_betas is not None:
            b = seqs["betas"]
            if b.shape[-1] > num_betas:
                seqs["betas"] = b[..., :num_betas]
            elif b.shape[-1] < num_betas:
                pad = [(0, 0)] * (b.ndim - 1) + [(0, num_betas - b.shape[-1])]
                seqs["betas"] = np.pad(b, pad)

    if "global_orient" in seqs and pop_global_orient:
        seqs.pop("global_orient")

    if "transl" in seqs:
        if pop_transl:
            seqs.pop("transl")
        elif normalize_transl:
            seqs["transl"] = seqs["transl"] - np.mean(
                seqs["transl"], axis=0, keepdims=True)

    if centralize_pelvis and pelvis_position is not None:
        offset = np.asarray(pelvis_position, np.float32)
        if "transl" in seqs:
            seqs["transl"] = seqs["transl"] - offset[None, None]
        else:
            P, F = seqs["body_pose"].shape[:2]
            seqs["transl"] = np.broadcast_to(-offset, (P, F, 3)).copy()

    # TalkSHOW 12-dim PCA hands -> 45-dim axis angle
    if dataset == "talkshow" and "left_hand_pose" in seqs \
            and seqs["left_hand_pose"].shape[-1] != 45:
        assert hand_components is not None, \
            "TalkSHOW needs the SMPL-X npz hand PCA components"
        lc, rc = hand_components
        n = seqs["left_hand_pose"].shape[-1]
        seqs["left_hand_pose"] = np.einsum(
            "pti,ij->ptj", seqs["left_hand_pose"], np.asarray(lc)[:n])
        seqs["right_hand_pose"] = np.einsum(
            "pti,ij->ptj", seqs["right_hand_pose"], np.asarray(rc)[:n])

    return {k: np.asarray(v, np.float32) for k, v in seqs.items()}


def parse_scene(scene: str):
    """'3dpw,dance,200-275-5' -> (dataset, name, frame_range, interval)
    (reference: load_smpl_sequences, data/human/__init__.py:52-67)."""
    dataset, filename, *frame_args = scene.split(",")
    frame_range, frame_interval = None, None
    if frame_args:
        assert len(frame_args) == 1, f"invalid scene format: {scene}"
        nums = tuple(map(int, frame_args[0].split("-")))
        if len(nums) == 2:
            frame_range = nums
        elif len(nums) == 3:
            frame_range = nums[:2]
            frame_interval = nums[2]
        else:
            raise ValueError(f"invalid scene format: {scene}")
    return dataset, filename, frame_range, frame_interval


def load_smpl_sequences(
    scene: str,
    model_type: str = "smplx",
    camera_sequences: Optional[dict] = None,
    _dataset=None,
    **preprocess_kwargs,
):
    """Scene-string entry point. Returns (seqs, num_person, num_frame)."""
    dataset, filename, frame_range, frame_interval = parse_scene(scene)
    if frame_range is not None:
        preprocess_kwargs["frame_range"] = frame_range
    if frame_interval is not None:
        assert preprocess_kwargs.get("frame_interval") is None, \
            "frame interval specified twice"
        preprocess_kwargs["frame_interval"] = frame_interval

    loader = _dataset if _dataset is not None else DATASET_CARDS[dataset]()
    if dataset in _WITH_CAMERAS:
        seqs, cam_seqs = loader.get_smpl_params(filename, model_type=model_type)
        if camera_sequences is not None:
            camera_sequences.update(cam_seqs)
    else:
        seqs = loader.get_smpl_params(filename, model_type=model_type)

    seqs = preprocess_smpl_sequences(seqs, dataset=dataset, **preprocess_kwargs)
    num_person, num_frame = seqs["body_pose"].shape[:2]
    return seqs, num_person, num_frame

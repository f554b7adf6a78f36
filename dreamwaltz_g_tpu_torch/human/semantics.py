"""SMPL-X semantic part tables: body-part -> vertex / triangle lookups.

Port of ``dreamwaltz_g_tpu/human/semantics.py`` (numpy only): the SMPL-X
vertex-segmentation json (24 SMPL labels + eyes), the FLAME masks through
``FLAME_vertex_ids.npy`` (the avatar's 'face' part is the FLAME face; the
json's 'head' minus the eyeballs without them), the MANO vertex ids, and
the derived labels (composite groups, 'skin', wrist rings = forearm and
hand dilated 3x along the mesh adjacency). Face tables use
all-vertices-in-part membership except the wrist rings (any vertex).

Assets resolve under ``configs.paths.HUMAN_TEMPLATES``, read at call time;
every loader returns nothing when its file is absent, and
``get_semantic_parts`` then returns None.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..configs import paths
from .smplx_model import SMPLXModelData

# part-name aliases -> fused-label keys (trainer-facing names)
PART_ALIASES: Dict[str, Tuple[str, ...]] = {
    "hands": ("hands",),
    "left_hand": ("hand_left",),
    "right_hand": ("hand_right",),
    "face": ("face",),
    "head": ("face", "scalp", "neck"),
    "arms": ("upper arms", "forearms"),
    "feet": ("feet",),
    "wrists": ("wrists",),
}


def load_vertex_segmentation(root: Optional[str] = None) -> Optional[dict]:
    root = Path(root or paths.HUMAN_TEMPLATES)
    for cand in (root / "smplx" / "smplx_vert_segmentation.json",
                 root / "smplx_vert_segmentation.json"):
        if cand.is_file():
            with open(cand) as f:
                return json.load(f)
    return None


def load_flame_labels(root: Optional[str] = None) -> Dict[str, list]:
    """FLAME masks -> SMPL-X vertex ids."""
    root = Path(root or paths.HUMAN_TEMPLATES)
    vids_path = None
    for cand in (root / "smplx" / "FLAME_vertex_ids.npy",
                 root / "FLAME_vertex_ids.npy"):
        if cand.is_file():
            vids_path = cand
            break
    masks_path = None
    for cand in (root / "flame" / "FLAME_masks.pkl",
                 root / "FLAME_masks.pkl"):
        if cand.is_file():
            masks_path = cand
            break
    if vids_path is None or masks_path is None:
        return {}
    vids = np.load(vids_path)
    with open(masks_path, "rb") as f:
        masks = pickle.load(f, encoding="latin1")
    return {k: np.asarray(vids)[np.asarray(v, np.int64)].tolist()
            for k, v in masks.items()}


def load_mano_labels(root: Optional[str] = None) -> Dict[str, list]:
    """MANO hand vertex ids."""
    root = Path(root or paths.HUMAN_TEMPLATES)
    for cand in (root / "smplx" / "MANO_vertex_ids.pkl",
                 root / "MANO_vertex_ids.pkl"):
        if cand.is_file():
            with open(cand, "rb") as f:
                d = pickle.load(f, encoding="latin1")
            return {"left_hand": np.asarray(d["left_hand"]).tolist(),
                    "right_hand": np.asarray(d["right_hand"]).tolist()}
    return {}


def faces_of_vertices(faces: np.ndarray, vertex_ids: Iterable[int],
                      all_in: bool = True) -> np.ndarray:
    """Triangles whose vertices are (all/any) inside the part."""
    vertex_ids = np.asarray(sorted(set(int(v) for v in vertex_ids)), np.int64)
    mask = np.zeros(int(faces.max()) + 1, bool)
    mask[vertex_ids] = True
    hit = mask[faces]
    keep = hit.all(-1) if all_in else hit.any(-1)
    return np.nonzero(keep)[0]


def vertex_adjacency(faces: np.ndarray, num_vertices: int) -> List[np.ndarray]:
    """Per-vertex connected-vertex lists."""
    pairs = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [0, 2]]], axis=0)
    pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    order = np.argsort(pairs[:, 0], kind="stable")
    pairs = pairs[order]
    starts = np.searchsorted(pairs[:, 0], np.arange(num_vertices))
    ends = np.searchsorted(pairs[:, 0], np.arange(num_vertices) + 1)
    return [np.unique(pairs[s:e, 1]) for s, e in zip(starts, ends)]


def _dilate(vset: set, adjacency: Sequence[np.ndarray], rings: int) -> set:
    out = set(vset)
    for _ in range(rings):
        extra: set = set()
        for v in out:
            extra.update(int(x) for x in adjacency[v])
        out |= extra
    return out


def fuse_labels(
    segmentation: dict,
    faces: np.ndarray,
    num_vertices: int,
    flame: Optional[Dict[str, list]] = None,
    mano: Optional[Dict[str, list]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The reference's fused label tables
    (convert_to_new_segmentation, smpl_model.py:444-510). Returns
    (label -> vertex ids, label -> face ids)."""
    seg = {k: list(v) for k, v in segmentation.items()}
    flame = flame or {}
    mano = mano or {}

    res: Dict[str, Union[list, set]] = {}
    # FLAME-sourced labels (only when the FLAME assets are present)
    if "scalp" in flame:
        res["scalp"] = flame["scalp"]
    if "face" in flame:
        res["face"] = flame["face"]
    elif "head" in seg:
        # json fallback: 'head' minus eyeballs approximates the FLAME face
        res["face"] = sorted(set(seg["head"]) - set(seg.get("eyeballs", [])))
    if "eye_region" in flame:
        res["eye region"] = flame["eye_region"]
    if "eyeballs" in seg:
        res["eyes"] = seg["eyeballs"]
    if "neck" in seg:
        res["neck"] = seg["neck"]

    def cat(*keys):
        out: list = []
        for k in keys:
            out.extend(seg.get(k, []))
        return out

    res["spine"] = cat("spine", "spine1", "spine2")
    res["shoulders"] = cat("leftShoulder", "rightShoulder")
    res["torso"] = cat("spine", "spine1", "spine2", "leftShoulder",
                       "rightShoulder")
    res["hand_left"] = cat("leftHand", "leftHandIndex1")
    res["hand_right"] = cat("rightHand", "rightHandIndex1")
    res["hand_left_index1"] = cat("leftHandIndex1")
    res["hand_right_index1"] = cat("rightHandIndex1")
    res["hands"] = res["hand_left"] + res["hand_right"]
    res["upper arms"] = cat("leftArm", "rightArm")
    res["forearms"] = cat("leftForeArm", "rightForeArm")
    res["forearm_left"] = cat("leftForeArm")
    res["forearm_right"] = cat("rightForeArm")
    res["hips"] = cat("hips")
    res["lower legs"] = cat("leftLeg", "rightLeg")
    res["upper legs"] = cat("leftUpLeg", "rightUpLeg")
    res["feet"] = cat("leftFoot", "leftToeBase", "rightFoot", "rightToeBase")
    res["skin"] = sorted(set(range(num_vertices))
                         - set(seg.get("eyeballs", [])))
    # MANO alternative hand tables
    if "left_hand" in mano:
        res["hand_left_MANO"] = mano["left_hand"]
        res["hand_right_MANO"] = mano["right_hand"]
        res["hands_MANO"] = mano["left_hand"] + mano["right_hand"]

    # derived wrist rings: forearm ∩ hand, dilated 3x along adjacency
    #
    adjacency = vertex_adjacency(faces, num_vertices)
    wl = set(res["forearm_left"]) & set(res["hand_left"])
    wr = set(res["forearm_right"]) & set(res["hand_right"])
    wl = _dilate(wl, adjacency, 3)
    wr = _dilate(wr, adjacency, 3)
    res["wrist_left"] = wl
    res["wrist_right"] = wr
    res["wrists"] = wl | wr

    label_to_vertices: Dict[str, np.ndarray] = {}
    label_to_faces: Dict[str, np.ndarray] = {}
    for k, v in res.items():
        vids = np.asarray(sorted(set(int(x) for x in v)), np.int64)
        if vids.size == 0:
            continue
        label_to_vertices[k] = vids
        strict = k not in ("wrist_left", "wrist_right")
        label_to_faces[k] = faces_of_vertices(faces, vids, all_in=strict)
    return label_to_vertices, label_to_faces


class SMPLSemantics:
    """Fused label tables with the reference's call protocol."""

    def __init__(self, faces: np.ndarray, num_vertices: int,
                 segmentation: dict,
                 flame: Optional[Dict[str, list]] = None,
                 mano: Optional[Dict[str, list]] = None):
        self.label_to_vertices, self.label_to_faces = fuse_labels(
            segmentation, np.asarray(faces), num_vertices, flame, mano)
        self.labels = sorted(self.label_to_vertices.keys())

    @classmethod
    def from_assets(cls, model: SMPLXModelData,
                    root: Optional[str] = None) -> Optional["SMPLSemantics"]:
        seg = load_vertex_segmentation(root)
        if seg is None:
            return None
        return cls(np.asarray(model.faces), model.num_vertices, seg,
                   flame=load_flame_labels(root), mano=load_mano_labels(root))

    def __call__(self, select_parts: Union[str, List[str]],
                 ) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(select_parts, str):
            select_parts = [select_parts]
        vids: set = set()
        fids: set = set()
        for p in select_parts:
            vids.update(self.label_to_vertices[p].tolist())
            fids.update(self.label_to_faces[p].tolist())
        return (np.asarray(sorted(vids), np.int64),
                np.asarray(sorted(fids), np.int64))


def get_semantic_parts(
    model: SMPLXModelData,
    part: str,
    segmentation: Optional[dict] = None,
    root: Optional[str] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """part name -> (vertex ids, face ids), or None when the segmentation
    json is unavailable."""
    if segmentation is not None:
        sem = SMPLSemantics(np.asarray(model.faces), model.num_vertices,
                            segmentation,
                            flame=load_flame_labels(root),
                            mano=load_mano_labels(root))
    else:
        sem = SMPLSemantics.from_assets(model, root)
    if sem is None:
        return None
    keys = PART_ALIASES.get(part, (part,))
    keys = [k for k in keys if k in sem.label_to_vertices]
    if not keys:
        return None
    vids, fids = sem(list(keys))
    if vids.size == 0:
        return None
    return vids, fids

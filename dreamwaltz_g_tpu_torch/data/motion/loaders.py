"""Motion dataset loaders: SMPL(-X) pose sequences from public mocap sets.

A copy of ``dreamwaltz_g_tpu/data/motion/loaders.py`` (plain numpy, host
side; the port keeps its own). Each loader exposes
``get_smpl_params(name) -> dict`` of ``(P, F, D)`` arrays in SMPL-X naming
(``global_orient``/``body_pose``/``left_hand_pose``/...), P = persons,
F = frames. The reenact/tram loaders additionally return a camera-sequence
dict (predefined tracks for video reenactment). The roots come from
``configs.paths``, read when a loader is built.

Format knowledge mirrors the reference's loaders (reference:
data/human/{motionx,aist,talkshow,pw3d,amass,demo,motionx_reenact,tram}.py),
on plain numpy (axis-angle conversion by a numpy Rodrigues instead of
pytorch3d).
"""
from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import tarfile
import zipfile
from collections import defaultdict
from glob import glob
from typing import Dict, Optional, Tuple

import numpy as np

from ...configs import paths


def _rotmat_to_axis_angle(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) axis-angle (host-side numpy Rodrigues)."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(tr)
    axis = np.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(norm > 1e-8, axis / np.maximum(norm, 1e-12),
                    np.asarray([1.0, 0.0, 0.0]))
    return axis * angle[..., None]


def _fps_subsample(n_frames: int, fps: float, stand_fps: float = 25.0):
    step = int(np.ceil(fps / stand_fps))
    return list(range(0, n_frames, max(step, 1)))


class Demo:
    """npy bundles shipped under assets/motions (reference: demo.py:10-24).

    Layout per frame (265,): jaw(3) eyes(6) global_orient(3) body(63)
    lhand(45) rhand(45) expression(100).
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.DEMO_MOTIONS

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        assert model_type == "smplx"
        arr = np.load(osp.join(self.root, f"{filename}.npy"))
        return {
            "jaw_pose": arr[None, :, 0:3],
            "global_orient": arr[None, :, 9:12],
            "body_pose": arr[None, :, 12:75],
            "left_hand_pose": arr[None, :, 75:120],
            "right_hand_pose": arr[None, :, 120:165],
            "expression": arr[None, :, 165:265],
        }


class MotionX:
    """Motion-X 322-dim SMPL-X sequences from motionx_smplx.zip
    (reference: motionx.py:15-68). Layout: orient(3) body(63) lhand(45)
    rhand(45) jaw(3) flame(150) transl(3) betas(10)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.MOTIONX_ROOT
        self._archive = None
        self._index = None

    def _ensure(self):
        if self._archive is None:
            self._archive = zipfile.ZipFile(
                osp.join(self.root, "motionx_smplx.zip"), "r")
            index = defaultdict(dict)
            for fp in self._archive.namelist():
                if fp.endswith(".npy"):
                    parts = fp.split("/")
                    # motion_data/smplx_322/{dataset}/{subset}/{file}.npy
                    if len(parts) == 5:
                        index[parts[2]][f"{parts[3]}/{osp.splitext(parts[4])[0]}"] = fp
            self._index = index

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        assert model_type == "smplx"
        self._ensure()
        dataset, filedir = filename.split("/", maxsplit=1)
        motion = np.load(self._archive.open(self._index[dataset][filedir]))
        return {
            "global_orient": motion[None, :, 0:3],
            "body_pose": motion[None, :, 3:66],
            "left_hand_pose": motion[None, :, 66:111],
            "right_hand_pose": motion[None, :, 111:156],
            "jaw_pose": motion[None, :, 156:159],
            "transl": motion[None, :, 309:312],
            "betas": motion[None, :, 312:],
        }


class AIST:
    """AIST++ SMPL dance motions from 20210308_motions.zip
    (reference: aist.py:8-62). 60fps -> 25fps resample; SMPL 23-joint body
    trimmed to the 21 SMPL-X body joints."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.AIST_ROOT
        self._archive = None
        self._index = None

    def _ensure(self):
        if self._archive is None:
            self._archive = zipfile.ZipFile(
                osp.join(self.root, "20210308_motions.zip"), "r")
            self._index = {
                osp.splitext(fp.split("/")[-1])[0]: fp
                for fp in self._archive.namelist() if fp.endswith(".pkl")
            }

    def get_smpl_params(self, filename: str, model_type: str = "smplx",
                        fps: float = 60, stand_fps: float = 25) -> Dict:
        self._ensure()
        dat = pickle.load(self._archive.open(self._index[filename], "r"))
        poses = dat["smpl_poses"][None]               # (1, F, 72)
        transl = dat["smpl_trans"][None] / dat["smpl_scaling"]
        sel = _fps_subsample(poses.shape[1], fps, stand_fps)
        global_orient = poses[:, sel, :3]
        body_pose = poses[:, sel, 3:]
        transl = transl[:, sel]
        if model_type in ("smplx", "smplh"):
            body_pose = body_pose[:, :, : 21 * 3]
        return {
            "global_orient": global_orient,
            "body_pose": body_pose,
            "transl": transl,
        }


# standing vs sitting reference poses per TalkSHOW speaker
# (reference: talkshow.py:70-106 — sitting speakers get bent hips/knees)
_TALKSHOW_SITTING = ("oliver", "seth", "chemistry")


class TalkShow:
    """TalkSHOW speech-gesture SMPL-X sequences from {speaker}_pkl_tar.tar.gz
    (reference: talkshow.py:14-150). Hands are 12-dim PCA; decoded with the
    model's hand components in preprocess (data/human/__init__.py:149-157)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.TALKSHOW_ROOT
        self._archives = None
        self._files = None

    def _ensure(self):
        if self._archives is not None:
            return
        self._archives, self._files = {}, {}
        for speaker in ("oliver", "seth", "chemistry", "conan"):
            tar_path = osp.join(self.root, f"{speaker}_pkl_tar.tar.gz")
            if not osp.isfile(tar_path):
                continue
            archive = tarfile.open(tar_path, "r:gz")
            self._archives[speaker] = archive
            self._files[speaker] = sorted(
                m.name for m in archive.getmembers() if m.name.endswith(".pkl"))

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        assert model_type == "smplx"
        self._ensure()
        speaker, idx = filename.split("/", 1)
        filepath = self._files[speaker][int(idx)] if idx.isdigit() else next(
            f for f in self._files[speaker] if idx in f)
        dat = pickle.load(self._archives[speaker].extractfile(filepath),
                          encoding="latin1")
        go = np.asarray(dat["global_orient"])
        if go.ndim == 3:
            go = go[:, 0, :]
        # pin root + transl to the first frame (speaker stays in place)
        go = np.broadcast_to(go[0:1], go.shape).copy()
        transl = np.asarray(dat["transl"])
        transl = np.broadcast_to(transl[0:1], transl.shape).copy()
        F = go.shape[0]
        return {
            "global_orient": go[None],
            "body_pose": np.asarray(dat["body_pose_axis"]).reshape(F, -1)[None],
            "jaw_pose": np.asarray(dat["jaw_pose"])[None],
            "leye_pose": np.asarray(dat["leye_pose"])[None],
            "reye_pose": np.asarray(dat["reye_pose"])[None],
            "expression": np.asarray(dat["expression"])[None],
            "betas": np.asarray(dat["betas"]).reshape(1, -1),
            "transl": transl[None],
            # PCA coefficients; decoded against the model's hand components
            "left_hand_pose": np.asarray(dat["left_hand_pose"])[None],
            "right_hand_pose": np.asarray(dat["right_hand_pose"])[None],
        }


_PW3D_ABBREV = {
    "dance": "courtyard_dancing_00",
    "basketball": "courtyard_basketball_00",
    "capoeira": "courtyard_capoeira_00",
    "warmwelcome": "courtyard_warmWelcome_00",
    "selfies": "courtyard_captureSelfies_00",
    "arguing": "courtyard_arguing_00",
    "jumpbench": "courtyard_jumpBench_01",
}


class PW3D:
    """3DPW multi-person sequences from sequenceFiles.zip
    (reference: pw3d.py:22-120)."""

    def __init__(self, root: Optional[str] = None):
        self.root = osp.join(root or paths.PW3D_ROOT, "3DPW")
        self._archive = None
        self._index = None

    def _ensure(self):
        if self._archive is None:
            self._archive = zipfile.ZipFile(
                osp.join(self.root, "sequenceFiles.zip"), "r")
            self._index = {
                osp.splitext(fp.split("/")[-1])[0]: fp
                for fp in self._archive.namelist()
                if fp.endswith(".pkl") and "__MACOSX" not in fp
            }

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        self._ensure()
        filename = _PW3D_ABBREV.get(filename, filename)
        dat = pickle.load(self._archive.open(self._index[filename], "r"),
                          encoding="latin1")
        poses = np.stack(dat["poses_60Hz"])          # (P, F, 72)
        transl = np.stack(dat["trans_60Hz"])         # (P, F, 3)
        sel = _fps_subsample(poses.shape[1], 60.0)
        poses, transl = poses[:, sel], transl[:, sel]
        body_pose = poses[:, :, 3:]
        if model_type in ("smplx", "smplh"):
            body_pose = body_pose[:, :, : 21 * 3]
        return {
            "global_orient": poses[:, :, :3],
            "body_pose": body_pose,
            "transl": transl,
        }


class AMASS:
    """AMASS npz mocap files in a flat directory (reference: amass.py:8-60)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.AMASS_ROOT

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        bdata = np.load(osp.join(self.root, f"{filename}.npz"), allow_pickle=True)
        fps = float(bdata["mocap_framerate"]) if "mocap_framerate" in bdata else 100.0
        poses = np.asarray(bdata["poses"])
        transl = np.asarray(bdata["trans"])
        sel = _fps_subsample(poses.shape[0], fps)
        poses, transl = poses[sel], transl[sel]
        out = {
            # AMASS roots are z-up world captures; the reference zeroes the
            # root orientation (amass.py:50) and we keep that behavior
            "global_orient": np.zeros_like(poses[None, :, :3]),
            "body_pose": poses[None, :, 3:66],
            "transl": transl[None],
        }
        if poses.shape[-1] >= 156:  # SMPL-X/H layout with hands
            out["left_hand_pose"] = poses[None, :, 66:111]
            out["right_hand_pose"] = poses[None, :, 111:156]
        return out


class Hybrik:
    """HybrIK video estimates (.pk with rotmat poses), single- AND
    multi-person (reference: hybrik.py:11-120 — per-frame person lists,
    frames filtered to the modal person count, betas averaged over frames,
    root orientation zeroed)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get("HYBRIK_ROOT", "./datasets/hybrik/")

    @staticmethod
    def get_video_info(transl):
        """(num_frame, modal num_person) (reference: hybrik.py:23-28)."""
        counts = [np.asarray(t).reshape(-1, 3).shape[0] for t in transl]
        num_person = int(np.bincount(counts).argmax())
        return len(transl), num_person

    def get_smpl_params(self, filename: str, model_type: str = "smplx") -> Dict:
        matches = glob(osp.join(self.root, "**", f"{filename}.pk"),
                       recursive=True)
        with open(matches[0], "rb") as f:
            bdata = pickle.load(f)
        thetas = bdata["pred_thetas"]
        transl = bdata["transl"]
        betas_raw = bdata.get("pred_betas")

        if isinstance(thetas, (list, tuple)) or \
                (isinstance(thetas, np.ndarray) and thetas.dtype == object):
            # MP layout: per-frame lists of per-person arrays; keep only
            # frames with the modal person count (hybrik.py:41-50)
            _, P = self.get_video_info(transl)
            poses_f, transl_f, betas_f = [], [], []
            for i in range(len(thetas)):
                th = np.asarray(thetas[i]).reshape(-1, 24, 3, 3)
                tr = np.asarray(transl[i]).reshape(-1, 3)
                if th.shape[0] != P or tr.shape[0] != P:
                    continue
                poses_f.append(th)
                transl_f.append(tr)
                if betas_raw is not None:
                    betas_f.append(np.asarray(betas_raw[i]).reshape(P, -1))
            rotmat = np.stack(poses_f, 1)            # (P, F', 24, 3, 3)
            transl_a = np.stack(transl_f, 1)         # (P, F', 3)
            betas = np.stack(betas_f, 1).mean(1) if betas_f else None
        else:
            thetas = np.asarray(thetas)              # (F, 24*9)
            F = thetas.shape[0]
            rotmat = thetas.reshape(1, F, 24, 3, 3)
            transl_a = np.asarray(transl).reshape(1, F, 3)
            betas = np.asarray(betas_raw).reshape(F, -1).mean(
                0, keepdims=True) if betas_raw is not None else None

        P, F = rotmat.shape[:2]
        aa = _rotmat_to_axis_angle(rotmat.reshape(-1, 24, 3, 3)) \
            .reshape(P, F, 24, 3)
        n_joints = 21 if model_type in ("smplx", "smplh") else 23
        body = aa[:, :, 1:1 + n_joints].reshape(P, F, -1)
        out = {
            # root orientation zeroed like the reference (hybrik.py:67-68)
            "global_orient": np.zeros_like(aa[:, :, 0]),
            "body_pose": body,
            "transl": transl_a,
        }
        if betas is not None:
            out["betas"] = betas                     # (P, n_betas)
        return out


def _parse_reenact_camera(camera_params: dict) -> dict:
    """Motion-X-ReEnact camera json -> our camera dict (y-flip extrinsic,
    negative-fy intrinsics — reference: motionx_reenact.py:46-94)."""
    F = camera_params["cam_R"].shape[0]
    extrinsic = np.tile(np.eye(4)[None], (F, 1, 1))
    extrinsic[:, :3, :3] = camera_params["cam_R"]
    extrinsic[:, :3, 3] = camera_params["cam_T"]
    extrinsic[:, 1, :] *= -1  # flip y axis into our y-up convention

    intr = camera_params["intrins"]                 # (F, 4): fx fy cx cy
    fx, fy, cx, cy = intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3]
    intrinsics = np.zeros((F, 3, 3))
    intrinsics[:, 0, 0] = fx
    intrinsics[:, 1, 1] = -fy
    intrinsics[:, 0, 2] = cx
    intrinsics[:, 1, 2] = cy
    intrinsics[:, 2, 2] = 1.0

    tanfov_y = cy / fy
    tanfov_x = cx / fx
    return {
        "extrinsic": extrinsic,
        "intrinsics": intrinsics,
        "image_width": int(cx[0] * 2),
        "image_height": int(cy[0] * 2),
        "tanfov": tanfov_y,
        "tanfov_x": tanfov_x,
        "fov": np.rad2deg(2 * np.arctan(tanfov_y)),
        "world_scale": camera_params.get("world_scale", 1.0),
    }


class MotionXReEnact:
    """Motion-X-ReEnact: motion + camera + inpainted background video
    (reference: motionx_reenact.py:17-160)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.MOTIONX_REENACT_ROOT
        self._archive = None
        self._index = None

    def _ensure(self):
        if self._archive is None:
            self._archive = zipfile.ZipFile(
                osp.join(self.root, "Motion-X-ReEnact.zip"), "r")
            index = {"video": {}, "inpainting": {}, "motion": {}}
            for fp in self._archive.namelist():
                key = osp.splitext(fp.split("/")[-1])[0]
                if fp.endswith(".mp4"):
                    kind = "inpainting" if "inpaint" in fp else "video"
                    index[kind][key.replace("_inpainting", "")] = fp
                elif fp.endswith(".json"):
                    index["motion"][key] = fp
            self._index = index

    def get_smpl_params(self, filename: str, model_type: str = "smplx",
                        ) -> Tuple[Dict, Dict]:
        assert model_type == "smplx"
        self._ensure()
        raw = json.load(self._archive.open(self._index["motion"][filename], "r"))
        smplx_params = defaultdict(list)
        camera_params = defaultdict(list)
        for anno in raw["annotations"]:
            for k, v in anno["smplx_params"].items():
                smplx_params[k].append(v)
            for k, v in anno["cam_params"].items():
                camera_params[k].append(v)
        sp = {k: np.asarray(v) for k, v in smplx_params.items()}
        cp = {k: np.asarray(v) for k, v in camera_params.items()}
        if "world_scale" in cp:
            cp["world_scale"] = cp["world_scale"].reshape(-1)[0]
        seqs = {
            "global_orient": sp["root_orient"][None],
            "body_pose": sp["pose_body"][None],
            "left_hand_pose": sp["pose_hand"][None, :, :45],
            "right_hand_pose": sp["pose_hand"][None, :, 45:],
            "jaw_pose": sp["pose_jaw"][None],
            "transl": sp["trans"][None],
            "betas": sp["betas"][None],
        }
        return seqs, _parse_reenact_camera(cp)

    def extract_video(self, filename: str, save_path: str,
                      video_type: str = "inpainting") -> str:
        """Write the (inpainted) background video to disk for the
        VideoBackground (reference: motionx_reenact.py:155-160)."""
        self._ensure()
        os.makedirs(osp.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "wb") as f:
            f.write(self._archive.read(self._index[video_type][filename]))
        return save_path


class Tram:
    """TRAM in-the-wild video estimates: SMPL rotmats + per-frame cameras
    (reference: tram.py:8-133)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or paths.TRAM_ROOT

    def get_smpl_params(self, filename: str, model_type: str = "smplx",
                        ) -> Tuple[Dict, Dict]:
        assert model_type == "smplx"
        smpl = np.load(osp.join(self.root, filename, "animation/hps_track_0.npy"),
                       allow_pickle=True).item()
        camera = np.load(osp.join(self.root, filename, "camera/camera.npy"),
                         allow_pickle=True).item()

        rotmat = np.asarray(smpl["pred_rotmat"])     # (F, 24, 3, 3)
        F = rotmat.shape[0]
        aa = _rotmat_to_axis_angle(rotmat)
        seqs = {
            "global_orient": aa[None, :, 0],
            "body_pose": aa[:, 1:22].reshape(F, -1)[None],
            "betas": np.asarray(smpl["pred_shape"])[None],
            "transl": np.asarray(smpl["pred_trans"]).reshape(F, 3)[None],
        }

        Fc = camera["pred_cam_R"].shape[0]
        extrinsic = np.tile(np.eye(4)[None], (Fc, 1, 1))
        extrinsic[:, 1, :] *= -1
        f = float(camera["img_focal"])
        cx, cy = int(camera["img_center"][0]), int(camera["img_center"][1])
        intrinsics = np.zeros((Fc, 3, 3))
        intrinsics[:, 0, 0] = f
        intrinsics[:, 1, 1] = f
        intrinsics[:, 0, 2] = cx
        intrinsics[:, 1, 2] = cy
        intrinsics[:, 2, 2] = 1.0
        cam_seqs = {
            "extrinsic": extrinsic,
            "intrinsics": intrinsics,
            "image_width": cx * 2,
            "image_height": cy * 2,
            "tanfov": np.full(Fc, cy / f),
            "tanfov_x": np.full(Fc, cx / f),
            "fov": np.full(Fc, np.degrees(2 * np.arctan(cy / f))),
        }
        return seqs, cam_seqs

"""The port's motion scenes (``data/motion/``, the motion branch of
``human/prompt.py``) against the JAX package, on the CPU.

Each of the nine loaders reads files the test writes in its dataset's own
layout (zip, tar.gz, pickle, npy, npz, json + mp4), made from a seed with
numpy; the port's and the JAX package's arrays (and camera tracks) are
equal. ``preprocess_smpl_sequences`` (frame ranges and intervals, person
selection, betas, translation, pelvis centring, the TalkSHOW PCA hand
decode), ``parse_scene``, ``expand_humans`` and ``load_smpl_sequences`` are
equal too. ``SMPLPrompt`` on a motion scene draws the JAX prompt's frames:
its SMPL-X vertices within 1e-5 (float32 forward kinematics on values of
order 1), its numpy generator in the JAX state, the camera track's frames
within 1e-6.
"""
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import PromptConfig as JPromptConfig
from dreamwaltz_g_tpu.data import motion as JM
from dreamwaltz_g_tpu.data.motion import loaders as JL
from dreamwaltz_g_tpu.human import prompt as JPr
from dreamwaltz_g_tpu.human import smplx_model as JX
from dreamwaltz_g_tpu_torch.configs import PromptConfig
from dreamwaltz_g_tpu_torch.data import motion as TM
from dreamwaltz_g_tpu_torch.data.motion import loaders as TL
from dreamwaltz_g_tpu_torch.human import prompt as TPr
from dreamwaltz_g_tpu_torch.human import smplx_model as TX

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- files in each loader's layout ------------------------------------------

def _demo(root, F=12):
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "talkshow.npy"),
            (_rng(1).random((F, 265)) * 0.6 - 0.3).astype(np.float32))
    return "talkshow"


def _motionx(root, F=9):
    os.makedirs(root, exist_ok=True)
    buf = io.BytesIO()
    np.save(buf, _rng(2).random((F, 322)).astype(np.float32))
    with zipfile.ZipFile(os.path.join(root, "motionx_smplx.zip"), "w") as z:
        z.writestr("motion_data/smplx_322/idea400/subset_0001/Clip_1.npy",
                   buf.getvalue())
        z.writestr("motion_data/readme.txt", "not a motion")
    return "idea400/subset_0001/Clip_1"


def _aist(root, F=30):
    os.makedirs(root, exist_ok=True)
    r = _rng(3)
    dat = {"smpl_poses": r.random((F, 72)), "smpl_trans": r.random((F, 3)),
           "smpl_scaling": np.asarray([1.5])}
    with zipfile.ZipFile(os.path.join(root, "20210308_motions.zip"),
                         "w") as z:
        z.writestr("motions/gBR_sBM_cAll_d04_mBR0_ch01.pkl",
                   pickle.dumps(dat))
    return "gBR_sBM_cAll_d04_mBR0_ch01"


def _talkshow(root, F=7):
    os.makedirs(root, exist_ok=True)
    r = _rng(4)
    dat = {"global_orient": r.random((F, 1, 3)),
           "body_pose_axis": r.random((F, 21, 3)),
           "jaw_pose": r.random((F, 3)), "leye_pose": r.random((F, 3)),
           "reye_pose": r.random((F, 3)), "expression": r.random((F, 50)),
           "betas": r.random((300,)), "transl": r.random((F, 3)),
           "left_hand_pose": r.random((F, 12)),
           "right_hand_pose": r.random((F, 12))}
    data = pickle.dumps(dat, protocol=2)
    with tarfile.open(os.path.join(root, "seth_pkl_tar.tar.gz"),
                      "w:gz") as t:
        for name in ("seth/a_0.pkl", "seth/b_1.pkl"):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return "seth/1"


def _pw3d(root, F=24):
    d = os.path.join(root, "3DPW")
    os.makedirs(d, exist_ok=True)
    r = _rng(5)
    dat = {"poses_60Hz": [r.random((F, 72)) for _ in range(2)],
           "trans_60Hz": [r.random((F, 3)) for _ in range(2)]}
    with zipfile.ZipFile(os.path.join(d, "sequenceFiles.zip"), "w") as z:
        z.writestr("sequenceFiles/test/courtyard_dancing_00.pkl",
                   pickle.dumps(dat))
        z.writestr("__MACOSX/sequenceFiles/test/courtyard_dancing_00.pkl",
                   b"junk")
    return "dance"


def _amass(root, F=40):
    os.makedirs(root, exist_ok=True)
    r = _rng(6)
    np.savez(os.path.join(root, "walk.npz"), poses=r.random((F, 156)),
             trans=r.random((F, 3)), mocap_framerate=np.asarray(120.0))
    return "walk"


def _rotmats(r, shape):
    aa = r.normal(size=shape + (3,)) * 0.5
    th = np.linalg.norm(aa, axis=-1, keepdims=True)[..., None]
    k = aa / np.linalg.norm(aa, axis=-1, keepdims=True)
    K = np.zeros(shape + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _hybrik(root, F=6, multi=False):
    d = os.path.join(root, "clips")
    os.makedirs(d, exist_ok=True)
    r = _rng(7)
    if multi:
        counts = [2, 2, 1, 2, 2, 3]
        dat = {"pred_thetas": [_rotmats(r, (n, 24)).reshape(n, -1)
                               for n in counts],
               "transl": [r.random((n, 3)) for n in counts],
               "pred_betas": [r.random((n, 10)) for n in counts]}
    else:
        dat = {"pred_thetas": _rotmats(r, (F, 24)).reshape(F, -1),
               "transl": r.random((F, 3)), "pred_betas": r.random((F, 10))}
    name = "multi" if multi else "single"
    with open(os.path.join(d, f"{name}.pk"), "wb") as f:
        pickle.dump(dat, f)
    return name


def reenact_json(F=5, width=1280, height=720, seed=8):
    """A Motion-X-ReEnact motion json: per-frame SMPL-X parameters and an
    OpenCV camera looking at the body from +z."""
    r = _rng(seed)
    ann = []
    for _ in range(F):
        ann.append({
            "smplx_params": {
                "root_orient": (r.normal(size=3) * 0.1).tolist(),
                "pose_body": (r.normal(size=63) * 0.2).tolist(),
                "pose_hand": (r.normal(size=90) * 0.2).tolist(),
                "pose_jaw": (r.normal(size=3) * 0.1).tolist(),
                "trans": (r.normal(size=3) * 0.05).tolist(),
                "betas": (r.normal(size=10) * 0.5).tolist()},
            "cam_params": {
                "cam_R": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                          [0.0, 0.0, -1.0]],
                "cam_T": [0.0, 0.3, 3.0],
                "intrins": [900.0, 900.0, width / 2, height / 2],
                "world_scale": [1.0]}})
    return {"annotations": ann}


def _reenact(root, F=5):
    os.makedirs(root, exist_ok=True)
    with zipfile.ZipFile(os.path.join(root, "Motion-X-ReEnact.zip"),
                         "w") as z:
        z.writestr("motion/seq01.json", json.dumps(reenact_json(F)))
        z.writestr("video/seq01.mp4", b"source video bytes")
        z.writestr("inpainting/seq01_inpainting.mp4", b"inpainted bytes")
    return "seq01"


def _tram(root, F=4):
    r = _rng(9)
    d = os.path.join(root, "clip7")
    os.makedirs(os.path.join(d, "animation"))
    os.makedirs(os.path.join(d, "camera"))
    np.save(os.path.join(d, "animation", "hps_track_0.npy"),
            {"pred_rotmat": _rotmats(r, (F, 24)),
             "pred_shape": r.random((F, 10)),
             "pred_trans": r.random((F, 1, 3))}, allow_pickle=True)
    np.save(os.path.join(d, "camera", "camera.npy"),
            {"pred_cam_R": _rotmats(r, (F,)), "img_focal": 1100.0,
             "img_center": np.asarray([640.0, 360.0])}, allow_pickle=True)
    return "clip7"


LOADERS = {
    "Demo": _demo, "MotionX": _motionx, "AIST": _aist,
    "TalkShow": _talkshow, "PW3D": _pw3d, "AMASS": _amass,
    "Hybrik": _hybrik, "MotionXReEnact": _reenact, "Tram": _tram,
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_matches_jax(tmp_path, name):
    filename = LOADERS[name](str(tmp_path))
    got = getattr(TL, name)(str(tmp_path)).get_smpl_params(filename)
    want = getattr(JL, name)(str(tmp_path)).get_smpl_params(filename)
    _equal(got, want)


def test_hybrik_multi_person_matches_jax(tmp_path):
    filename = _hybrik(str(tmp_path), multi=True)
    got = TL.Hybrik(str(tmp_path)).get_smpl_params(filename)
    _equal(got, JL.Hybrik(str(tmp_path)).get_smpl_params(filename))
    assert got["body_pose"].shape[:2] == (2, 4)


def test_reenact_camera_and_video(tmp_path):
    """The reenact camera: a flipped y row and a negative fy, a 1280 x 720
    frame from cx, cy; the inpainted video extracted byte for byte."""
    filename = _reenact(str(tmp_path))
    _, cam = TL.MotionXReEnact(str(tmp_path)).get_smpl_params(filename)
    assert (cam["image_width"], cam["image_height"]) == (1280, 720)
    assert np.all(cam["intrinsics"][:, 1, 1] < 0)
    np.testing.assert_array_equal(cam["extrinsic"][0, 1, :3], [0, 1, 0])
    out = TL.MotionXReEnact(str(tmp_path)).extract_video(
        filename, str(tmp_path / "bg" / "seq01.mp4"))
    assert open(out, "rb").read() == b"inpainted bytes"


def _seqs(P=2, F=10, betas=10, seed=11):
    r = _rng(seed)
    return {"global_orient": r.random((P, F, 3)),
            "body_pose": r.random((P, F, 63)),
            "left_hand_pose": r.random((P, F, 12)),
            "right_hand_pose": r.random((P, F, 12)),
            "transl": r.random((P, F, 3)),
            "betas": r.random((P, betas))}


PREPROCESS = {
    "defaults": dict(),
    "frames": dict(frame_range=(2, 9), frame_interval=2),
    "interval": dict(frame_interval=3),
    "person": dict(num_person=1),
    "indices": dict(person_indices=[1]),
    "pop": dict(pop_betas=True, pop_transl=True, pop_global_orient=True),
    "betas_pad": dict(num_betas=16),
    "betas_cut": dict(num_betas=4),
    "normalize": dict(normalize_transl=True),
    "pelvis": dict(pelvis_position=np.asarray([0.1, -0.3, 0.05])),
    "pelvis_no_transl": dict(pop_transl=True,
                             pelvis_position=np.asarray([0.1, -0.3, 0.05])),
    "talkshow": dict(dataset="talkshow"),
}


@pytest.mark.parametrize("case", sorted(PREPROCESS))
def test_preprocess_matches_jax(case):
    kw = dict(PREPROCESS[case])
    dataset = kw.pop("dataset", "amass")
    comps = _rng(12).random((2, 45, 45)).astype(np.float32)
    kw["hand_components"] = (comps[0], comps[1])
    got = TM.preprocess_smpl_sequences(_seqs(), dataset, **kw)
    want = JM.preprocess_smpl_sequences(_seqs(), dataset, **kw)
    _equal(got, want)
    assert all(v.dtype == np.float32 for v in got.values())
    if dataset == "talkshow":
        assert got["left_hand_pose"].shape[-1] == 45


@pytest.mark.parametrize("scene", ["3dpw,dance", "3dpw,dance,200-275",
                                   "3dpw,dance,200-275-5", "demo,aist",
                                   "3dpw,dance,1-2-3-4"])
def test_parse_scene_matches_jax(scene):
    try:
        want = JM.parse_scene(scene)
    except ValueError:
        with pytest.raises(ValueError):
            TM.parse_scene(scene)
        return
    assert TM.parse_scene(scene) == want


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_expand_humans_matches_jax(n):
    seqs = {k: v[:1] for k, v in _seqs().items()}
    _equal(TM.expand_humans(seqs, n), JM.expand_humans(seqs, n))


@pytest.mark.parametrize("scene", ["demo,talkshow,2-10-2", "aist,{}",
                                   "motionx_reenact,{}", "tram,{}"])
def test_load_smpl_sequences_matches_jax(tmp_path, monkeypatch, scene):
    """Through the scene string: the loader named by the dataset, the
    frame arguments, the preprocessing, and the camera track of the
    reenact / TRAM datasets."""
    from dreamwaltz_g_tpu.configs import paths as jpaths
    from dreamwaltz_g_tpu_torch.configs import paths as tpaths

    dataset = scene.split(",")[0]
    root = str(tmp_path)
    filename = {"demo": _demo, "aist": _aist, "motionx_reenact": _reenact,
                "tram": _tram}[dataset](root)
    var = {"demo": "DEMO_MOTIONS", "aist": "AIST_ROOT",
           "motionx_reenact": "MOTIONX_REENACT_ROOT",
           "tram": "TRAM_ROOT"}[dataset]
    for mod in (jpaths, tpaths):
        monkeypatch.setattr(mod, var, root)
    scene = scene.format(filename)
    kw = dict(num_betas=10, pelvis_position=np.asarray([0.0, 0.2, 0.0]))
    cams_t, cams_j = {}, {}
    got = TM.load_smpl_sequences(scene, camera_sequences=cams_t, **kw)
    want = JM.load_smpl_sequences(scene, camera_sequences=cams_j, **kw)
    _equal(got, want)
    _equal(cams_t, cams_j)
    assert bool(cams_t) == (dataset in ("motionx_reenact", "tram"))


def _bodies():
    kw = dict(num_vertices=300, num_joints=55, num_betas=10, num_expr=10,
              seed=0)
    return JX.make_synthetic_model(**kw), \
        TX.make_synthetic_model(device="cpu", **kw)


@pytest.mark.parametrize("scene,extra", [
    ("demo,talkshow", {}),
    ("demo,talkshow,1-11-3", {"observed_betas": "(0.5, -0.5)"}),
    ("motionx_reenact,{}", {"num_person": 1}),
    ("hybrik,{}", {"pop_betas": False})])
def test_smpl_prompt_motion_matches_jax(tmp_path, monkeypatch, scene,
                                        extra):
    """Frames by index (cycled past the end) and random frames from the
    prompt's numpy generator, on the JAX prompt's vertices."""
    from dreamwaltz_g_tpu.configs import paths as jpaths
    from dreamwaltz_g_tpu_torch.configs import paths as tpaths

    dataset = scene.split(",")[0]
    make, var = {"demo": (_demo, "DEMO_MOTIONS"),
                 "motionx_reenact": (_reenact, "MOTIONX_REENACT_ROOT"),
                 "hybrik": (_hybrik, None)}[dataset]
    filename = make(str(tmp_path))
    scene = scene.format(filename)
    if var is not None:
        for mod in (jpaths, tpaths):
            monkeypatch.setattr(mod, var, str(tmp_path))
    if dataset == "hybrik":
        monkeypatch.setenv("HYBRIK_ROOT", str(tmp_path))
    jbody, tbody = _bodies()
    jpr = JPr.SMPLPrompt(JPromptConfig(scene=scene, **extra), jbody, seed=4)
    tpr = TPr.SMPLPrompt(PromptConfig(scene=scene, **extra), tbody, seed=4)
    assert (tpr.num_person, tpr.num_frame) == (jpr.num_person,
                                               jpr.num_frame)
    _equal(tpr.sequences, jpr.sequences)
    for frame_idx in (0, 1, tpr.num_frame + 2, None, None):
        jp, jo = jpr(frame_idx=frame_idx, batch_idx=3)
        tp, to = tpr(frame_idx=frame_idx, batch_idx=3)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
        np.testing.assert_allclose(to.vertices.numpy(),
                                   np.asarray(jo.vertices), atol=TOL)
    assert tpr._rng.bit_generator.state == jpr._rng.bit_generator.state
    for i in (0, 3, 7):
        jc = jpr.get_camera_params_from_sequences(i)
        tc = tpr.get_camera_params_from_sequences(i)
        if jc is None:
            assert tc is None
            continue
        assert {k: v for k, v in tc.items() if not torch.is_tensor(v)} \
            == {k: v for k, v in jc.items() if not hasattr(v, "shape")}
        for k in ("extrinsic", "intrinsics"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-6)


def test_hand_components_match_jax(tmp_path):
    r = _rng(13)
    path = tmp_path / "SMPLX_NEUTRAL.npz"
    np.savez(path, hands_componentsl=r.random((45, 45)),
             hands_componentsr=r.random((45, 45)))
    _equal(TPr.load_hand_components(str(path), 12),
           JPr.load_hand_components(str(path), 12))
    np.savez(tmp_path / "bare.npz", v_template=np.zeros((3, 3)))
    assert TPr.load_hand_components(str(tmp_path / "bare.npz")) is None

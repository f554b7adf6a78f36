"""The trainer's per-step host providers in the port against the JAX
package, on the CPU: the view-dependent prompt, the camera samplers, the
OpenPose keypoints, the ray casts and mesh rasterizer, the occlusion cull
and the pose canvas, ``SMPLPrompt``'s pose draws and the semantic parts.

Tolerances:
* text indices, sampler draws (the numpy ``Generator`` draws in the JAX
  order), part names and semantic tables equal;
* camera matrices and keypoints within 1e-5 (absolute, on values of order
  1), projected keypoints within 1e-3 px; ray-cast hit distances within
  1e-5 and hit ids equal; the rasterized depth within 1e-4 and its
  coverage equal;
* the OpenPose canvases differ on at most 0.1% of their pixels: the
  drawing rounds each keypoint to a pixel, so a keypoint within rounding
  of a pixel edge could move a limb by one pixel; none does on these
  inputs, where the canvases are equal;
* SMPL-X outputs of ``SMPLPrompt`` within 1e-5, the JAX pose draws handed
  to the port (the canonical-R angles and the random normals recovered
  from the JAX pose).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import DataConfig as JDataConfig
from dreamwaltz_g_tpu.configs import PromptConfig as JPromptConfig
from dreamwaltz_g_tpu.data import sampler as JSa
from dreamwaltz_g_tpu.guidance import text_aug as JT
from dreamwaltz_g_tpu.human import condition as JCo
from dreamwaltz_g_tpu.human import keypoints as JK
from dreamwaltz_g_tpu.human import prompt as JPr
from dreamwaltz_g_tpu.human import semantics as JSe
from dreamwaltz_g_tpu.human import smplx_model as JX
from dreamwaltz_g_tpu.ops import raycast as JR
from dreamwaltz_g_tpu_torch.configs import DataConfig, PromptConfig
from dreamwaltz_g_tpu_torch.data import sampler as TSa
from dreamwaltz_g_tpu_torch.guidance import text_aug as TT
from dreamwaltz_g_tpu_torch.human import condition as TCo
from dreamwaltz_g_tpu_torch.human import keypoints as TK
from dreamwaltz_g_tpu_torch.human import poses as TPo
from dreamwaltz_g_tpu_torch.human import prompt as TPr
from dreamwaltz_g_tpu_torch.human import semantics as TSe
from dreamwaltz_g_tpu_torch.human import smplx_model as TX
from dreamwaltz_g_tpu_torch.ops import raycast as TR

TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _bodies(num_vertices=10_475, num_joints=55):
    kw = dict(num_vertices=num_vertices, num_joints=num_joints,
              num_betas=10, num_expr=10, seed=0)
    return JX.make_synthetic_model(**kw), \
        TX.make_synthetic_model(device="cpu", **kw)


def _landmarks(faces, dynamic=True):
    rng = np.random.default_rng(7)
    F = len(faces)
    return JK.LandmarkData(
        lmk_faces_idx=rng.choice(F, 51), lmk_bary_coords=rng.dirichlet(
            np.ones(3), 51).astype(np.float32),
        dynamic_lmk_faces_idx=rng.choice(F, (79, 17)) if dynamic else None,
        dynamic_lmk_bary_coords=rng.dirichlet(np.ones(3), (79, 17)).astype(
            np.float32) if dynamic else None)


def _posed(jbody, tbody, seed=1):
    rng = np.random.default_rng(seed)
    jp = JX.default_params(jbody, 1)
    jp = jp._replace(body_pose=jnp.asarray(
        rng.normal(size=(1, 63)) * 0.3, jnp.float32),
        global_orient=jnp.asarray([[0.1, 0.6, -0.2]], jnp.float32))
    tp = TX.SMPLXParams(*[_t(x) for x in jp])
    return JX.smplx_forward(jbody, jp), TX.smplx_forward(tbody, tp)


@pytest.mark.parametrize("mode", ["prefix", "suffix", "dreamwaltz",
                                  "dreamwaltz-g"])
def test_text_augmentation_matches_jax(mode):
    j = JT.TextAugmentation("a ninja", mode=mode, angle_front=70,
                            angle_overhead=40)
    t = TT.TextAugmentation("a ninja", mode=mode, angle_front=70,
                            angle_overhead=40)
    assert t.texts == j.texts and t.part2index == j.part2index
    az = np.linspace(-30, 400, 97)
    el = np.linspace(0, 180, 97)
    for part in (None, "face", "hand_left", "body"):
        np.testing.assert_array_equal(t(az, el, part), j(az, el, part))


def _camera_close(t, j):
    for name in ("extrinsic", "c2w", "intrinsics", "projection", "tanfov",
                 "radius", "azimuth", "elevation"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("offsets", [False, True])
def test_camera_samplers_match_jax(offsets):
    jbody, tbody = _bodies()
    fields = dict(face_prob=0.3, hand_prob=0.2, head_prob=0.1,
                  foot_prob=0.1, arm_prob=0.1, vertical_jitter="(0.1, 0.3)")
    jcfg = JDataConfig(**{**fields, "vertical_jitter": (0.1, 0.3)})
    tcfg = DataConfig(**{**fields, "vertical_jitter": (0.1, 0.3)})
    jcam = JSa.RandomCamera4Avatar(jcfg, 64, 64, seed=11)
    tcam = TSa.RandomCamera4Avatar(tcfg, 64, 64, seed=11, device="cpu")
    if offsets:
        jout = JX.smplx_forward(jbody, JX.default_params(jbody, 1))
        tout = TX.smplx_forward(tbody, TX.default_params(tbody, 1))
        jkp = np.asarray(JK.openpose_keypoints(jbody, jout))
        tkp = TK.openpose_keypoints(tbody, tout).numpy()
        np.testing.assert_allclose(tkp, jkp, atol=TOL)
        jcam.setup_camera_offset(jkp)
        tcam.setup_camera_offset(tkp)
    for i in range(20):
        jcam.training_ratio = tcam.training_ratio = i / 20
        (jc, jpart), (tc, tpart) = jcam(1), tcam(1)
        assert tpart == jpart
        _camera_close(tc, jc)
    jcyc = JSa.CyclicalCamera4Avatar(jcfg, 32, 32)
    tcyc = TSa.CyclicalCamera4Avatar(tcfg, 32, 32, device="cpu")
    for p in (0.0, 0.3, 0.95):
        _camera_close(tcyc(p), jcyc(p))


@pytest.mark.parametrize("landmarks", [None, "static", "dynamic"])
def test_openpose_keypoints_match_jax(landmarks):
    jbody, tbody = _bodies()
    lm = None if landmarks is None else _landmarks(
        np.asarray(jbody.faces), landmarks == "dynamic")
    jout, tout = _posed(jbody, tbody)
    jkp = np.asarray(JK.openpose_keypoints(jbody, jout, lm))
    tkp = TK.openpose_keypoints(tbody, tout, lm).numpy()
    np.testing.assert_array_equal(np.isnan(tkp), np.isnan(jkp))
    np.testing.assert_allclose(tkp, jkp, atol=TOL)
    extr = np.asarray([[1, 0, 0, 0.1], [0, 1, 0, -0.6], [0, 0, 1, 3.0],
                       [0, 0, 0, 1]], np.float32)
    intr = np.asarray([[400, 0, 256], [0, -400, 256], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        TK.project_keypoints(_t(tkp), _t(extr), _t(intr)).numpy(),
        np.asarray(JK.project_keypoints(jnp.asarray(jkp), extr, intr)),
        atol=1e-3)


def test_raycast_and_rasterizer_match_jax():
    jbody, tbody = _bodies(num_vertices=400, num_joints=8)
    v = np.asarray(jbody.v_template, np.float32)
    faces = np.asarray(jbody.faces)
    rng = np.random.default_rng(3)
    o = (rng.normal(size=(300, 3)) * [2, 0.5, 2]
         + [0, 0.7, 0]).astype(np.float32)
    d = (np.asarray([0, 0.7, 0]) - o + rng.normal(size=(300, 3)) * 0.1
         ).astype(np.float32)
    sizes = (len(faces) // 2, len(faces) - len(faces) // 2)
    for gs in (None, sizes):
        jt, jp = JR.cast_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v),
                              jnp.asarray(faces), geometry_sizes=gs,
                              ray_chunk=128)
        tt, tp = TR.cast_rays(_t(o), _t(d), _t(v), faces, geometry_sizes=gs,
                              ray_chunk=128)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        hit = np.isfinite(np.asarray(jt))
        assert hit.sum() > 50
        np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
        np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                                   atol=TOL)
    extr = np.asarray([[1, 0, 0, 0], [0, 1, 0, -0.7], [0, 0, 1, 2.0],
                       [0, 0, 0, 1]], np.float32)
    intr = np.asarray([[60, 0, 24], [0, -60, 24], [0, 0, 1]], np.float32)
    jr = JR.rasterize_mesh(jnp.asarray(v), jnp.asarray(faces), extr, intr,
                           48, 40, capacity=128, chunk=32)
    tr = TR.rasterize_mesh(_t(v), faces, _t(extr), _t(intr), 48, 40,
                           capacity=128, chunk=32)
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    m = np.asarray(jr.mask)
    assert m.sum() > 100
    np.testing.assert_allclose(tr.depth.numpy()[m], np.asarray(jr.depth)[m],
                               atol=1e-4)
    np.testing.assert_allclose(tr.normal.numpy(), np.asarray(jr.normal),
                               atol=1e-4)


@pytest.mark.parametrize("azimuth", [0.0, 100.0, 250.0])
def test_occlusion_cull_and_pose_canvas_match_jax(azimuth):
    from dreamwaltz_g_tpu.data.camera import make_camera_batch as jmake
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch

    jbody, tbody = _bodies()
    lm = _landmarks(np.asarray(jbody.faces))
    jout, tout = _posed(jbody, tbody, seed=4)
    jcam = jmake(2.2, azimuth, 85.0, 50.0, 512, 512,
                 at_vector=((0.0, 0.7, 0.0),))
    tcam = make_camera_batch(2.2, azimuth, 85.0, 50.0, 512, 512,
                             at_vector=((0.0, 0.7, 0.0),), device="cpu")
    jr = JCo.ConditionRenderer(jbody, landmarks=lm, draw_face_landmarks=True)
    tr = TCo.ConditionRenderer(tbody, landmarks=lm, draw_face_landmarks=True)
    jkp3 = JK.openpose_keypoints(jbody, jout, lm)
    tkp3 = TK.openpose_keypoints(tbody, tout, lm)
    campos = tcam.c2w[0, :3, 3]
    jverts, jfaces = jr._stacked_mesh(jout)
    tverts, tfaces = tr._stacked_mesh(tout)
    jocc, jd = JCo.occlusion_cull(jnp.asarray(campos.numpy()), jkp3, jverts,
                                  jfaces)
    tocc, td = TCo.occlusion_cull(campos, tkp3, tverts, tfaces)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)
    jk = jr.pose_keypoints(jout, jcam.extrinsic[0], jcam.intrinsics[0],
                           512, 512)
    tk = tr.pose_keypoints(tout, tcam.extrinsic[0], tcam.intrinsics[0],
                           512, 512)
    np.testing.assert_array_equal(np.isnan(tk), np.isnan(jk))
    np.testing.assert_allclose(tk, jk, atol=1e-3 / 512)
    jimg = jr.render_pose_batch([jout], jcam.extrinsic, jcam.intrinsics,
                                512, 512)[0]
    timg = tr.render_pose_batch([tout], tcam.extrinsic, tcam.intrinsics,
                                512, 512)[0]
    assert timg.shape == (512, 512, 3) and timg.max() > 0
    differ = np.any(timg != jimg, axis=-1).mean()
    assert differ <= 1e-3, differ
    np.testing.assert_array_equal(
        tr.render_pose(tout, tcam.extrinsic[0], tcam.intrinsics[0], 512, 512),
        timg)
    np.testing.assert_array_equal(
        TCo.conditions_to_batch([timg, jimg], device="cpu").numpy(),
        np.asarray(JCo.conditions_to_batch([timg, jimg])))


def _pcfg(cls, scene):
    return cls(scene=scene, canonical_mixup_prob=0.5)


def _draws_from(jp: JX.SMPLXParams) -> dict:
    """The port's pose draws recovered from a JAX pose: canonical-R's two
    uniform draws, or the random sampler's normals."""
    body = np.asarray(jp.body_pose).reshape(-1, 21, 3)
    q, adj = np.pi / 4, np.pi / 30
    sh, hip = -body[0, TPo.L_SHOULDER, 2], body[0, TPo.L_HIP, 2]
    return {"uniform": _t([(sh + q) / (2 * q), (hip - adj) / (q - adj)]),
            "body": _t(np.asarray(jp.body_pose) / 0.3),
            "left_hand": _t(np.asarray(jp.left_hand_pose) / 0.3),
            "right_hand": _t(np.asarray(jp.right_hand_pose) / 0.3),
            "expr": _t(np.asarray(jp.expression) / 1.5)}


@pytest.mark.parametrize("scene", ["canonical", "canonical-R",
                                   "canonical-choice", "canonical-loop2",
                                   "random", "random-body,hand,expr"])
def test_smpl_prompt_matches_jax(scene):
    jbody, tbody = _bodies(num_vertices=300, num_joints=55)
    jpr = JPr.SMPLPrompt(_pcfg(JPromptConfig, scene), jbody, seed=3)
    tpr = TPr.SMPLPrompt(_pcfg(PromptConfig, scene), tbody, seed=3)
    for name in ("vertices", "joints"):
        np.testing.assert_allclose(
            getattr(tpr.canonical_outputs, name).numpy(),
            np.asarray(getattr(jpr.canonical_outputs, name)), atol=TOL)
    for i in range(4):
        jpr.training_ratio = tpr.training_ratio = i / 4
        jp, jo = jpr(batch_idx=i)
        tp, to = tpr(batch_idx=i, draws=_draws_from(jp))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
        np.testing.assert_allclose(to.vertices.numpy(),
                                   np.asarray(jo.vertices), atol=TOL)
    assert tpr._rng.bit_generator.state == jpr._rng.bit_generator.state


def test_prompt_refuses_unported_scenes(tmp_path, monkeypatch):
    """No scene refuses now: 'vposer' builds as a random scene (its poses
    are held to the JAX package's in ``tests/test_torch_vposer.py``); a
    motion scene goes to its loader, which raises for a file that is not
    there."""
    from dreamwaltz_g_tpu_torch.configs import paths

    _, tbody = _bodies(num_vertices=300, num_joints=55)
    assert TPr.SMPLPrompt(_pcfg(PromptConfig, "vposer"),
                          tbody).scene_type == "random"
    monkeypatch.setattr(paths, "DEMO_MOTIONS", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        TPr.SMPLPrompt(_pcfg(PromptConfig, "demo,talkshow"), tbody)


@pytest.mark.parametrize("part", ["hands", "face", "head", "arms", "wrists",
                                  "left_hand", "feet", "nothing"])
def test_semantic_parts_match_jax(tmp_path, part):
    jbody, tbody = _bodies(num_vertices=600, num_joints=55)
    faces = np.asarray(jbody.faces)
    order = np.random.default_rng(5).permutation(len(faces))

    def verts(ids):
        return sorted(set(faces[ids].reshape(-1).tolist()))

    seg = {"leftHand": verts(order[:60]), "rightHand": verts(order[60:120]),
           "leftHandIndex1": verts(order[120:130]),
           "leftForeArm": verts(order[100:200]),
           "rightForeArm": verts(order[40:80]),
           "head": verts(order[200:300]), "eyeballs": verts(order[290:300]),
           "neck": verts(order[300:320]), "leftArm": verts(order[320:340]),
           "leftFoot": verts(order[340:360])}
    want = JSe.get_semantic_parts(jbody, part, segmentation=seg,
                                  root=str(tmp_path))
    got = TSe.get_semantic_parts(tbody, part, segmentation=seg,
                                 root=str(tmp_path))
    if want is None:
        assert got is None
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    (tmp_path / "smplx").mkdir()
    (tmp_path / "smplx" / "smplx_vert_segmentation.json").write_text(
        json.dumps(seg))
    from_file = TSe.get_semantic_parts(tbody, part, root=str(tmp_path))
    assert (from_file is None) == (want is None)
    if want is not None:
        for a, b in zip(from_file, want):
            np.testing.assert_array_equal(a, b)
    assert TSe.get_semantic_parts(tbody, part,
                                  root=str(tmp_path / "none")) is None

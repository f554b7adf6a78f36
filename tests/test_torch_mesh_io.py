"""The last single-card functions of the port against the JAX package, on
the CPU: ``human/glbs.skin_points_by_joint_weights`` (after
``tests/test_smplx.py``'s vertex-weight case: the shaped, pose-offset
template skinned through ``J_pose_rigid`` is the SMPL-X forward's
vertices), ``ops/mesh.triangle_frames`` within 1e-6, and
``utils/mesh_io``: the OBJ round trip with its texture, the vertex
normals, the tangents, the vertex-colour bake, the face selection and
``render_mesh``, each against the JAX module on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.human import glbs as jglbs
from dreamwaltz_g_tpu.human import smplx_model as jsmplx
from dreamwaltz_g_tpu.ops import mesh as jmesh
from dreamwaltz_g_tpu.utils import mesh_io as jio
from dreamwaltz_g_tpu_torch.human import glbs as tglbs
from dreamwaltz_g_tpu_torch.human import smplx_model as tsmplx
from dreamwaltz_g_tpu_torch.ops import mesh as tmesh
from dreamwaltz_g_tpu_torch.utils import mesh_io as tio
from tests.test_mesh_export import _sphere_mesh
import tests.torch_threads  # noqa: F401  (per-worker threads)

# float32 through the SMPL-X chain (as tests/test_torch_geometry.py)
ATOL_SMPLX = 2e-5


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.mark.parametrize("num_joints", [6, 55])
def test_skin_points_by_joint_weights_matches_jax(num_joints):
    jm = jsmplx.make_synthetic_model(200, num_joints, 10, 10, seed=4)
    tm = tsmplx.make_synthetic_model(200, num_joints, 10, 10, seed=4,
                                     device="cpu")
    rng = np.random.default_rng(5)
    jp = jsmplx.default_params(jm, 1)
    fields = {n: (rng.normal(size=getattr(jp, n).shape) * 0.3)
              .astype(np.float32) for n in jp._fields}
    jp = jsmplx.SMPLXParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = tsmplx.SMPLXParams(**{k: _t(v) for k, v in fields.items()})
    to = tsmplx.smplx_forward(tm, tp)
    tg = tglbs.glbs_transforms(tm, tp)
    pts = to.v_shaped[0] + to.pose_offsets[0]
    got = tglbs.skin_points_by_joint_weights(tg, pts, tm.lbs_weights,
                                             transl=tp.transl[0])
    # the port's own identity: the vertex weights give the forward's
    np.testing.assert_allclose(got.numpy(), to.vertices[0].numpy(),
                               atol=ATOL_SMPLX)
    jg = jglbs.glbs_transforms(jm, jp)
    want = jglbs.skin_points_by_joint_weights(
        jg, jnp.asarray(pts.numpy()), jm.lbs_weights,
        transl=jp.transl[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_SMPLX)
    # arbitrary points and weights, no translation
    q = rng.normal(size=(64, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(num_joints), size=64).astype(np.float32)
    np.testing.assert_allclose(
        tglbs.skin_points_by_joint_weights(tg, _t(q), _t(w)).numpy(),
        np.asarray(jglbs.skin_points_by_joint_weights(
            jg, jnp.asarray(q), jnp.asarray(w))), atol=ATOL_SMPLX)


def test_triangle_frames_match_jax():
    rng = np.random.default_rng(0)
    v, f = _sphere_mesh(8)
    v = (v * rng.uniform(0.5, 1.5, size=(1, 3))).astype(np.float32)
    # a degenerate triangle: its clamped norms keep the frame finite
    f = np.concatenate([f, [[0, 0, 1]]]).astype(np.int32)
    R, sizes = tmesh.triangle_frames(_t(v), f)
    jR, jsizes = jmesh.triangle_frames(jnp.asarray(v), jnp.asarray(f))
    assert R.shape == (len(f), 3, 3) and sizes.shape == (len(f), 3)
    assert torch.isfinite(R).all() and torch.isfinite(sizes).all()
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(sizes.numpy(), np.asarray(jsizes), atol=1e-6)
    # the frames of the proper triangles (the sphere's poles have
    # degenerate ones too) are orthonormal
    proper = (sizes[:, :2] > 1e-4).all(-1)
    assert proper.sum() > len(f) // 2
    RtR = R[proper].transpose(1, 2) @ R[proper]
    np.testing.assert_allclose(RtR.numpy(), np.broadcast_to(
        np.eye(3), RtR.shape), atol=1e-5)


def test_obj_round_trip_matches_jax(tmp_path):
    v, f = _sphere_mesh(6)
    albedo = np.random.default_rng(1).uniform(size=(32, 32, 3)) \
        .astype(np.float32)
    paths = {}
    for name, mod in (("port", tio), ("jax", jio)):
        m = mod.Mesh(v=v, f=f).auto_normal().auto_uv().compute_tangents()
        m.set_albedo(albedo)
        paths[name] = m.write(str(tmp_path / name / "m.obj"))
        if name == "port":
            port_mesh = m
        else:
            jax_mesh = m
    for a, b in ((port_mesh.vn, jax_mesh.vn), (port_mesh.vt, jax_mesh.vt),
                 (port_mesh.tangents, jax_mesh.tangents)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(port_mesh.ft, jax_mesh.ft)
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    m2, j2 = tio.Mesh.load_obj(paths["port"]), jio.Mesh.load_obj(paths["jax"])
    for k in ("v", "f", "vt", "ft", "vn", "fn", "albedo"):
        np.testing.assert_array_equal(getattr(m2, k), getattr(j2, k))
    np.testing.assert_allclose(m2.v, v, atol=1e-5)
    np.testing.assert_allclose(m2.albedo, albedo, atol=1 / 255)
    sized = tio.Mesh(v=v * 3.0 + 1.0, f=f).auto_size()
    jsized = jio.Mesh(v=v * 3.0 + 1.0, f=f).auto_size()
    np.testing.assert_array_equal(sized.v, jsized.v)


def test_normals_bake_and_face_selection_match_jax():
    v, f = _sphere_mesh(10)
    np.testing.assert_array_equal(tio.compute_vertex_normals(v, f),
                                  jio.compute_vertex_normals(v, f))
    x = np.random.default_rng(2).normal(size=(7, 3))
    np.testing.assert_array_equal(tio.safe_normalize(x),
                                  jio.safe_normalize(x))
    sel = [0, 1, 2, 4, 5, 9, 13]
    np.testing.assert_array_equal(
        tio.convert_vertex_indices_to_face_indices(sel, f),
        jio.convert_vertex_indices_to_face_indices(sel, f))
    v6, f6 = _sphere_mesh(6)
    cols = np.random.default_rng(3).uniform(size=(len(v6), 3))
    tex = tio.vertex_colors_to_albedo_image(tio.Mesh(v=v6, f=f6), cols, 64)
    jtex = jio.vertex_colors_to_albedo_image(jio.Mesh(v=v6, f=f6), cols, 64)
    np.testing.assert_allclose(tex, jtex, atol=1e-6)


@pytest.mark.parametrize("textured", [True, False])
def test_render_mesh_matches_jax(textured):
    from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch

    v, f = _sphere_mesh(10)
    meshes = []
    for mod in (tio, jio):
        m = mod.Mesh(v=v, f=f).auto_normal().auto_uv()
        if textured:
            m.set_albedo(np.random.default_rng(4).uniform(
                size=(32, 32, 3)).astype(np.float32))
        meshes.append(m)
    jc = jcamera(3.0, 20.0, 70.0, 50.0, 40, 48)
    tc = make_camera_batch(3.0, 20.0, 70.0, 50.0, 40, 48, device="cpu")
    np.testing.assert_allclose(tc.extrinsic.numpy(), np.asarray(jc.extrinsic),
                               atol=1e-6)
    got = tio.render_mesh(meshes[0], tc.extrinsic[0].numpy(),
                          tc.intrinsics[0].numpy(), 40, 48,
                          bg_color=(0.1, 0.2, 0.3), device="cpu")
    want = jio.render_mesh(meshes[1], np.asarray(jc.extrinsic[0]),
                           np.asarray(jc.intrinsics[0]), 40, 48,
                           bg_color=(0.1, 0.2, 0.3))
    rgb, alpha, depth = got
    assert rgb.shape == (40, 48, 3) and alpha.shape == depth.shape == (40, 48)
    assert 0.05 < alpha.mean() < 0.95
    # a ray grazing a triangle edge may hit its neighbour instead: the
    # hits agree on all but a few pixels, and the values where both hit
    same = alpha == want[1]
    assert (~same).sum() <= 2
    np.testing.assert_allclose(depth[same], want[2][same], atol=1e-4)
    np.testing.assert_allclose(rgb[same], want[0][same], atol=2e-3)


def test_render_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    v, f = _sphere_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.render_mesh(tio.Mesh(v=v, f=f), np.eye(4), np.eye(3), 4, 4)

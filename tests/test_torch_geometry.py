"""Parity of the PyTorch port's geometry against the JAX package: rotation
algebra, the synthetic SMPL-X body, SMPL-X forward, GLBS, nearest-triangle
queries and cameras. Inputs come from seeded numpy draws and go through
both; float32 results agree within the stated tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data import camera as jcam
from dreamwaltz_g_tpu.human import glbs as jglbs
from dreamwaltz_g_tpu.human import smplx_model as jsmplx
from dreamwaltz_g_tpu.ops import mesh as jmesh
from dreamwaltz_g_tpu.utils import transforms as jtf
from dreamwaltz_g_tpu_torch.data import camera as tcam
from dreamwaltz_g_tpu_torch.human import glbs as tglbs
from dreamwaltz_g_tpu_torch.human import smplx_model as tsmplx
from dreamwaltz_g_tpu_torch.ops import mesh as tmesh
from dreamwaltz_g_tpu_torch.utils import transforms as ttf

# float32 rounding of a few chained products: 1e-6 for unit-scale rotation
# algebra, 1e-5 for the SMPL-X chain (55 composed transforms at most)
ATOL_ROT = 1e-6
ATOL_SMPLX = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(j, t, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("fn", ["quat_to_matrix", "quat_normalize",
                                "matrix_to_quat", "axis_angle_to_matrix",
                                "quat_multiply", "quat_flip_axis_rotate",
                                "safe_normalize", "look_at_rotation"])
def test_transforms_match_jax(fn):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    aa = (rng.normal(size=(64, 3)) * 1.5).astype(np.float32)
    aa[:4] = 0.0                      # the zero-angle Taylor branch
    R = np.asarray(jtf.axis_angle_to_matrix(jnp.asarray(aa)))
    args = {
        "quat_to_matrix": (q,), "quat_normalize": (q,),
        "matrix_to_quat": (R,), "axis_angle_to_matrix": (aa,),
        "quat_multiply": (q, q[::-1].copy()),
        "quat_flip_axis_rotate": (R, q),
        "safe_normalize": (aa,),
        "look_at_rotation": (aa, np.tile([0.0, 1.0, 0.0], (64, 1))),
    }[fn]
    j = getattr(jtf, fn)(*[jnp.asarray(a, jnp.float32) for a in args])
    t = getattr(ttf, fn)(*[_t(a) for a in args])
    _close(j, t, ATOL_ROT)


def test_rigid_transform_algebra_matches_jax():
    rng = np.random.default_rng(2)
    J, N = 6, 40
    R = np.asarray(jtf.axis_angle_to_matrix(
        jnp.asarray(rng.normal(size=(J, 3)), jnp.float32)))
    tr = rng.normal(size=(J, 3)).astype(np.float32)
    g = rng.normal(size=(3,)).astype(np.float32)
    w = rng.uniform(size=(N, J)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    idx = rng.integers(0, J, size=N)

    ja = jtf.RigidTransform(jnp.asarray(R), jnp.asarray(tr)).compose(
        jtf.RigidTransform.from_trans(jnp.asarray(g)))
    ta = ttf.RigidTransform(_t(R), _t(tr)).compose(
        ttf.RigidTransform.from_trans(_t(g)))
    _close(ja.rot, ta.rot, ATOL_ROT)
    _close(ja.trans, ta.trans, ATOL_ROT)
    _close(ja.inverse().trans, ta.inverse().trans, ATOL_ROT)
    _close(ja.transform_points(jnp.asarray(pts), weights=jnp.asarray(w)),
           ta.transform_points(_t(pts), weights=_t(w)), ATOL_ROT * 10)
    _close(ja.transform_points(jnp.asarray(pts), indices=jnp.asarray(idx)),
           ta.transform_points(_t(pts), indices=torch.as_tensor(idx)),
           ATOL_ROT * 10)
    for mode in ("quaternion", "matrix"):
        _close(ja.transform_quaternions(jnp.asarray(q), weights=jnp.asarray(w),
                                        rotation_mode=mode),
               ta.transform_quaternions(_t(q), weights=_t(w),
                                        rotation_mode=mode), 1e-5)


@pytest.mark.parametrize("sizes", [(120, 6, 3, 2), (300, 55, 10, 10)])
def test_synthetic_model_bitwise(sizes):
    V, J, nb, ne = sizes
    jm = jsmplx.make_synthetic_model(V, J, nb, ne, seed=3)
    tm = tsmplx.make_synthetic_model(V, J, nb, ne, seed=3, device="cpu")
    for name in ("v_template", "shapedirs", "expr_dirs", "posedirs",
                 "J_regressor", "lbs_weights", "pose_mean"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name).numpy())
    np.testing.assert_array_equal(jm.parents, tm.parents)
    np.testing.assert_array_equal(jm.faces, tm.faces)


def _random_params(jmodel, tmodel, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    jp = jsmplx.default_params(jmodel, 1)
    fields = {}
    for name in jp._fields:
        shape = getattr(jp, name).shape
        fields[name] = (rng.normal(size=shape) * scale).astype(np.float32)
    jp = jsmplx.SMPLXParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = tsmplx.SMPLXParams(**{k: _t(v) for k, v in fields.items()})
    return jp, tp


@pytest.mark.parametrize("num_joints", [6, 55])
def test_smplx_forward_and_glbs_match_jax(num_joints):
    jm = jsmplx.make_synthetic_model(200, num_joints, 10, 10, seed=4)
    tm = tsmplx.make_synthetic_model(200, num_joints, 10, 10, seed=4,
                                     device="cpu")
    jp, tp = _random_params(jm, tm, seed=5)
    jo = jsmplx.smplx_forward(jm, jp)
    to = tsmplx.smplx_forward(tm, tp)
    for name in ("vertices", "joints", "A", "full_pose", "pose_offsets"):
        _close(getattr(jo, name), getattr(to, name), ATOL_SMPLX)

    _close(jglbs.joint_template(jm), tglbs.joint_template(tm), ATOL_SMPLX)
    eb = np.full((10,), 0.2, np.float32)
    jg = jglbs.glbs_transforms(jm, jp, extra_betas=jnp.asarray(eb))
    tg = tglbs.glbs_transforms(tm, tp, extra_betas=_t(eb))
    for name in jg._fields:
        _close(getattr(jg, name).rot, getattr(tg, name).rot, ATOL_SMPLX)
        _close(getattr(jg, name).trans, getattr(tg, name).trans, ATOL_SMPLX)


def test_nearest_triangles_match_jax():
    jm = jsmplx.make_synthetic_model(150, 6, 3, 2, seed=6)
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(300, 3)) * 0.2 + [0, 0.7, 0]).astype(np.float32)
    verts = np.asarray(jm.v_template)
    jn = jmesh.find_nearest_triangles(jnp.asarray(pts), jnp.asarray(verts),
                                      jnp.asarray(jm.faces), point_chunk=128)
    tn = tmesh.find_nearest_triangles(_t(pts), _t(verts),
                                      torch.as_tensor(jm.faces),
                                      point_chunk=128)
    np.testing.assert_array_equal(np.asarray(jn.triangle_indices),
                                  tn.triangle_indices.numpy())
    np.testing.assert_array_equal(np.asarray(jn.vertex_indices),
                                  tn.vertex_indices.numpy())
    _close(jn.sq_dists, tn.sq_dists, 1e-6)
    _close(jn.barycentric, tn.barycentric, 1e-4)
    lw = jmesh.interpolate_vertex_attributes(jn, jnp.asarray(jm.faces),
                                             jm.lbs_weights)
    tw = tmesh.interpolate_vertex_attributes(
        tn, torch.as_tensor(jm.faces), _t(jm.lbs_weights))
    _close(lw, tw, 1e-4)

    jd, ji = jmesh.knn(jnp.asarray(pts), jnp.asarray(pts), 5, chunk=64)
    td, ti = tmesh.knn(_t(pts), _t(pts), 5, chunk=64)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    _close(jd, td, 1e-6)


def test_camera_batch_matches_jax():
    args = ([2.5, 2.0, 3.0], [30.0, 0.0, 200.0], [80.0, 90.0, 60.0],
            [50.0, 40.0, 60.0], 48, 64)
    kw = dict(at_vector=((0.0, 0.7, 0.0),))
    jc = jcam.make_camera_batch(*args, **kw)
    tc = tcam.make_camera_batch(*args, **kw, device="cpu")
    for name in ("extrinsic", "c2w", "intrinsics", "projection", "tanfov"):
        _close(getattr(jc, name), getattr(tc, name), 1e-5, rtol=1e-6)

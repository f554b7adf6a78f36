"""The stage-1 -> stage-2 handoff in the port against the JAX package, on
the CPU: the point-cloud export (``nerf/export.py``), the PLY IO, the mesh
seeding (``gaussian/seed.py``), the LBS-weight smoothing, and the torch
checkpoints with the trainer's resume.

Tolerances:
* the export's density grid within 1e-5 relative; its dense mask equal to
  the JAX mask wherever |sigma - thresh| > 1e-4 thresh (a cell within
  rounding of the threshold may flip between the packages); where both
  keep the same cells, the points equal to the bit and the colors within
  1e-5, and the subsample (``default_rng(0).choice``) the same points;
* the isolated-cell filter, the bbox removal and the PLY bytes equal;
* seeding: positions and scales within 1e-6, colors within 1e-6;
* the smoothed LBS weights within 1e-5 (KNN ties could order equal
  distances differently; the random cloud has none);
* a resumed run equal to an uninterrupted one to the bit (one CPU thread:
  the plain blend's scatter-adds are unordered across threads).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.gaussian import seed as JS
from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model as jsmpl
from dreamwaltz_g_tpu.nerf import export as JE
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.ops import mesh as JM
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.utils import point_cloud as JP
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.gaussian import seed as TS
from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model
from dreamwaltz_g_tpu_torch.nerf import export as TE
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.ops import mesh as TM
from dreamwaltz_g_tpu_torch.system import avatar as TA
from dreamwaltz_g_tpu_torch.training import checkpoint as CK
from dreamwaltz_g_tpu_torch.utils import point_cloud as TP

FIELD = dict(triplane_resolution=16, triplane_dim=8, bound=1.0)
RES = 24


def _t(a):
    return torch.as_tensor(np.array(a))


def _field_pair():
    """A JAX field with contrast and the port's twin carrying its weights."""
    jmodel = JN.build_nerf(JNeRFConfig(**FIELD), with_background=True)
    params = jmodel.init(jax.random.PRNGKey(3))
    params = params._replace(encoder=params.encoder._replace(
        planes=params.encoder.planes * 6.0))
    tmodel = TN.build_nerf(NeRFConfig(**FIELD), device="cpu")
    convert.nerf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


def _grid_sigma(jmodel, params, tmodel):
    xs = (np.arange(RES, dtype=np.float32) + 0.5) / RES * 2 - 1
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    js, _ = jmodel.density(params, jnp.asarray(g))
    with torch.no_grad():
        ts, _ = tmodel.density(_t(g))
    return np.asarray(js).reshape((RES,) * 3), ts.numpy().reshape((RES,) * 3)


@pytest.mark.parametrize("min_neighbors", [0, 2])
@pytest.mark.parametrize("max_points", [None, 40])
def test_export_matches_jax(min_neighbors, max_points):
    jmodel, params, tmodel = _field_pair()
    js, ts = _grid_sigma(jmodel, params, tmodel)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    thresh = float(np.quantile(js, 0.8))
    near = np.abs(js - thresh) <= 1e-4 * thresh
    jmask = JE.filter_isolated_cells(js > thresh, min_neighbors)
    tmask = TE.filter_isolated_cells(torch.as_tensor(ts > thresh),
                                     min_neighbors).numpy()
    assert (jmask != tmask)[~near].sum() == 0
    jpc = JE.export_point_cloud(jmodel, params, resolution=RES,
                                density_thresh=thresh, max_points=max_points,
                                min_neighbors=min_neighbors)
    stats = {}
    tpc = TE.export_point_cloud(tmodel, resolution=RES, density_thresh=thresh,
                                max_points=max_points,
                                min_neighbors=min_neighbors, stats=stats)
    assert stats["dense_cells"] == int((ts > thresh).sum())
    assert stats["kept_cells"] == int(tmask.sum())
    assert tpc.points.shape == jpc.points.shape
    if (jmask == tmask).all():
        np.testing.assert_array_equal(tpc.points, jpc.points)
        np.testing.assert_allclose(tpc.colors, jpc.colors, atol=1e-5)


def test_export_bbox_and_exclusion_match_jax():
    jmodel, params, tmodel = _field_pair()
    js, _ = _grid_sigma(jmodel, params, tmodel)
    thresh = float(np.quantile(js, 0.7))
    box = (np.asarray([-0.5, -0.5, -0.5]), np.asarray([0.2, 0.5, 0.5]))
    jpc = JE.export_point_cloud(jmodel, params, resolution=RES,
                                density_thresh=thresh, bbox_min=box[0],
                                bbox_max=box[1])
    tpc = TE.export_point_cloud(tmodel, resolution=RES, density_thresh=thresh,
                                bbox_min=box[0], bbox_max=box[1])
    np.testing.assert_array_equal(tpc.points, jpc.points)
    rng = np.random.default_rng(0)
    pc = TP.BasicPointCloud(
        points=rng.uniform(-1, 1, (500, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (500, 3)).astype(np.float32),
        normals=rng.normal(size=(500, 3)).astype(np.float32))
    jpc = JP.BasicPointCloud(*pc)
    for bboxes in (((-0.5, -0.5, -0.5), (0.5, 0.0, 0.5)),
                   [((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                    ((-1.0, -1.0, -1.0), (-0.2, 0.3, -0.1))]):
        got = TE.remove_points_inside_bboxes(pc, bboxes)
        want = JE.remove_points_inside_bboxes(jpc, bboxes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_neighbors", [1, 3, 8])
def test_filter_isolated_cells_matches_jax(min_neighbors):
    mask = np.random.default_rng(min_neighbors).random((9, 7, 11)) < 0.3
    want = JE.filter_isolated_cells(mask, min_neighbors)
    np.testing.assert_array_equal(
        TE.filter_isolated_cells(torch.as_tensor(mask),
                                 min_neighbors).numpy(), want)


@pytest.mark.parametrize("parts", ["points", "colors", "all"])
def test_ply_round_trip_read_by_jax(tmp_path, parts):
    rng = np.random.default_rng(1)
    pc = TP.BasicPointCloud(
        points=rng.normal(size=(50, 3)).astype(np.float32),
        colors=None if parts == "points"
        else rng.uniform(0, 1, (50, 3)).astype(np.float32),
        normals=rng.normal(size=(50, 3)).astype(np.float32)
        if parts == "all" else None)
    path = TP.save_ply(str(tmp_path / "t.ply"), pc)
    JP.save_ply(str(tmp_path / "j.ply"), JP.BasicPointCloud(*pc))
    assert open(path, "rb").read() == open(tmp_path / "j.ply", "rb").read()
    for got in (TP.load_ply(path), JP.load_ply(path)):
        np.testing.assert_array_equal(got.points, pc.points)
        for a, b in ((got.colors, pc.colors), (got.normals, pc.normals)):
            if b is None:
                assert a is None
            elif a is got.colors:
                np.testing.assert_allclose(a, b, atol=1 / 255 + 1e-6)
            else:
                np.testing.assert_array_equal(a, b)


def _body():
    jbody = jsmpl(num_vertices=120, num_joints=6, seed=0)
    tbody = make_synthetic_model(num_vertices=120, num_joints=6, seed=0,
                                 device="cpu")
    return jbody, tbody


def test_seeding_matches_jax():
    jbody, tbody = _body()
    v = np.asarray(jbody.v_template, np.float32)
    faces = np.asarray(jbody.faces)
    key = jax.random.PRNGKey(5)
    jpts = JS.seed_positions("mesh_surface", key, jnp.asarray(v),
                             jnp.asarray(faces), 64)
    k1, k2 = jax.random.split(key)
    tri = v[faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                         tri[:, 2] - tri[:, 0]), axis=-1)
    fidx = jax.random.categorical(
        k1, jnp.log(jnp.maximum(jnp.asarray(area), 1e-20))[None],
        shape=(1, 64))[0]
    u = jax.random.uniform(k2, (64, 2))
    tpts = TS.seed_positions("mesh_surface", None, tbody.v_template, faces,
                             64, fidx=_t(fidx), u=_t(u))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-6)
    np.testing.assert_array_equal(
        TS.seed_positions("mesh_vertex", None, tbody.v_template, faces, 0,
                          n_per_vertex=3).numpy(),
        np.asarray(JS.seed_positions("mesh_vertex", key, jnp.asarray(v),
                                     jnp.asarray(faces), 0, 3)))
    with pytest.raises(NotImplementedError):
        TS.seed_positions("mesh_triangle", None, tbody.v_template, faces, 4)
    pts = np.asarray(jpts)
    jc = JS.seed_colors("rand", key, jnp.asarray(pts))
    np.testing.assert_array_equal(
        TS.seed_colors("rand", None, _t(pts), draws=_t(jc)).numpy(),
        np.asarray(jc))
    for kind in ("constant", "ones", "normal"):
        np.testing.assert_allclose(
            TS.seed_colors(kind, None, _t(pts), tbody.v_template,
                           faces).numpy(),
            np.asarray(JS.seed_colors(kind, key, jnp.asarray(pts),
                                      jnp.asarray(v), jnp.asarray(faces))),
            atol=1e-6)
    np.testing.assert_allclose(
        TS.seed_scales_radius(_t(pts), tbody.v_template, 1.5).numpy(),
        np.asarray(JS.seed_scales_radius(jnp.asarray(pts), jnp.asarray(v),
                                         1.5)), atol=1e-6)


@pytest.mark.parametrize("smooth_N", [1, 25])
def test_lbs_smoothing_matches_jax(smooth_N):
    jbody, tbody = _body()
    rng = np.random.default_rng(2)
    cloud = (rng.normal(size=(200, 3)) * 0.15
             + np.asarray([0, 0.7, 0])).astype(np.float32)
    v = np.asarray(jbody.v_template, np.float32)
    faces = np.asarray(jbody.faces)
    jn = JM.find_nearest_triangles(jnp.asarray(cloud), jnp.asarray(v),
                                   jnp.asarray(faces))
    tn = TM.find_nearest_triangles(_t(cloud), tbody.v_template,
                                   torch.as_tensor(faces))
    np.testing.assert_array_equal(tn.triangle_indices.numpy(),
                                  np.asarray(jn.triangle_indices))
    want = JA.initialize_lbs_weights(jbody, jn, jnp.asarray(cloud),
                                     smooth=True, smooth_K=8,
                                     smooth_N=smooth_N)
    got = TA.initialize_lbs_weights(tbody, tn, _t(cloud), smooth=True,
                                    smooth_K=8, smooth_N=smooth_N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert TA.knn_chunk(1_000_000) == 89 and TA.knn_chunk(1000) == 4096
    d_small, i_small = TM.knn(_t(cloud), _t(cloud), 9, chunk=7)
    d_big, i_big = TM.knn(_t(cloud), _t(cloud), 9)
    assert torch.equal(i_small, i_big) and torch.equal(d_small, d_big)


def test_checkpointer_round_trip_and_discovery(tmp_path):
    ck = CK.Checkpointer(tmp_path / "exp" / "checkpoints", max_keep=2)
    tree = {"params": {"a": torch.arange(6.0).reshape(2, 3)},
            "opt_state": {"count": 3, "mu": [torch.ones(2)]},
            "step": 7, "rng": {"numpy": np.random.default_rng(0)
                               .bit_generator.state}}
    for step in (1, 5, 7):
        ck.save(step, tree)
    assert ck.all_steps() == [5, 7] and ck.latest_step() == 7
    got, step = ck.restore()
    assert step == 7 and torch.equal(got["params"]["a"], tree["params"]["a"])
    assert got["opt_state"]["count"] == 3
    assert got["rng"]["numpy"] == tree["rng"]["numpy"]
    step_dir = tmp_path / "exp" / "checkpoints" / "step_00000007"
    for form in (step_dir, tmp_path / "exp" / "checkpoints",
                 tmp_path / "exp"):
        assert CK.resolve_ckpt_path(form) == step_dir
    assert CK.resolve_ckpt_path(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        CK.Checkpointer(tmp_path / "empty").restore()


def _resume_args(tmp_path, name, iters, save_interval):
    return ["--stage", "gs", "--log.debug", "true", "--log.platform", "cpu",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--optim.iters", str(iters),
            "--log.save_interval", str(save_interval),
            "--log.max_keep_ckpts", "0",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--data.train_w", "16", "--data.train_h", "16",
            "--render.n_gaussians", "96",
            "--render.use_densifier", "true",
            "--render.densify_from_iter", "1",
            "--render.densification_interval", "1",
            "--render.densify_grad_threshold", "0",
            "--prompt.scene", "canonical-R",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0"]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two steps in one run, against one step, a checkpoint, a fresh
    trainer restoring it (``--optim.resume``) and one more step: the
    avatar, Adam's moments and counts, the alive mask and every generator
    equal to the bit. Densification runs at both steps (it rewrites slots
    and zeroes their moments in place), and the canonical-R scene and the
    split draw from the generators."""
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = main(_resume_args(tmp_path, "whole", 2, 0))
        first = main(_resume_args(tmp_path, "split", 2, 1))
        assert first.checkpointer.all_steps() == [1, 2]
        # the second run of the split experiment restores step 1
        (tmp_path / "split" / "checkpoints" / "step_00000002").rename(
            tmp_path / "step_2_aside")
        resumed = main(_resume_args(tmp_path, "split", 2, 0)
                       + ["--optim.resume", "true"])
    finally:
        torch.set_num_threads(threads)
    assert resumed.train_step == whole.train_step == 2
    assert resumed.losses == whole.losses[1:]

    def flat(tree, name=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{name}.{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{name}[{i}]")
        else:
            yield name, tree

    for tr in (whole, resumed):
        tr.tree = {"avatar": avatar_tree(tr.state.avatar, tr.avatar_model),
                   "adam": tr.state.opt_state.adam.state_dict()["state"],
                   "count": tr.state.opt_state.count,
                   "rng": tr._rng_tree()}
    got, want = dict(flat(resumed.tree)), dict(flat(whole.tree))
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def test_jax_field_and_avatar_carried_into_the_port_cli(tmp_path):
    """A JAX field written as a port checkpoint
    (``convert.nerf_checkpoint_from_numpy``) seeds the port's stage 2
    through ``--render.from_nerf``: its planes arrive verbatim. A JAX
    avatar written the same way (``avatar_checkpoint_from_numpy``)
    warm-starts a sub-stage through ``--optim.ckpt``: every tensor
    arrives."""
    from dreamwaltz_g_tpu import tests_support as jts
    from dreamwaltz_g_tpu_torch import tests_support as tts
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer, avatar_tree

    jcfg = JNeRFConfig(triplane_resolution=16, triplane_dim=8)
    jmodel = JN.build_nerf(jcfg, with_background=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    step_dir = convert.nerf_checkpoint_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        NeRFConfig(triplane_resolution=16, triplane_dim=8),
        tmp_path / "jax_nerf" / "checkpoints" / "step_00000000")
    assert CK.resolve_ckpt_path(tmp_path / "jax_nerf") == step_dir
    seen = {}
    train = Trainer.train

    def before(self):
        seen["planes"] = self.state.avatar.params.encoder.planes.detach() \
            .clone()
        return train(self)

    common = ["--stage", "gs", "--log.debug", "true",
              "--log.platform", "cpu", "--log.exp_root", str(tmp_path),
              "--nerf.triplane_resolution", "16",
              "--nerf.triplane_dim", "8", "--data.train_w", "16",
              "--data.train_h", "16", "--render.n_gaussians", "64",
              "--render.nerf_resolution", "16",
              "--nerf.density_thresh", "1e-4",
              "--log.snapshot_interval", "0",
              "--log.evaluate_interval", "0", "--optim.iters", "1"]
    Trainer.train = before
    try:
        main(common + ["--log.exp_name", "from_jax",
                       "--render.from_nerf", str(tmp_path / "jax_nerf")])
    finally:
        Trainer.train = train
    np.testing.assert_array_equal(seen["planes"].numpy(),
                                  np.asarray(params.encoder.planes))

    from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane

    jset = jts.tiny_avatar_setup(
        enc_cfg=JTriplane(resolution=16, feature_dim=8))
    tset = tts.tiny_avatar_setup(device="cpu")
    jtree = jax.tree_util.tree_map(np.asarray, jset.state)
    ck = convert.avatar_checkpoint_from_numpy(jtree, tset.model,
                                              tmp_path / "jax_avatar")
    got = CK.load_pytree(ck)["params"]
    np.testing.assert_array_equal(got["positions"].numpy(),
                                  jtree.params.positions)
    np.testing.assert_array_equal(got["planes"].numpy(),
                                  jtree.params.encoder.planes)
    assert set(got) == set(avatar_tree(tset.state, tset.model))

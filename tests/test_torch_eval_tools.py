"""The port's evaluation tools (``dreamwaltz_g_tpu_torch/scripts/``)
against the JAX package's ``scripts/``, on the CPU.

* ``eval_r_precision``: the JAX tiny towers carried into the port
  (``convert.clip_vision_from_flax`` / ``clip_text_tower_from_flax``), three
  seeded PNGs (one of another size, so both the common-square resize and
  the towers' shrink run) named in the tool's three layouts: the images
  equal, the similarity matrix within 1e-5 of its largest entry of the JAX
  script's computation, top-1 and top-5 equal. ``--tiny --device cpu``
  end to end prints one line with the JAX script's keys.
* ``compare_backbones.score_field`` on a tiny triplane field and a tiny
  grid field carried with ``convert.nerf_state_from_numpy``, against the
  JAX functions the JAX script composes (the pretrain step's metrics with
  the same stratification draws, ``export_point_cloud`` at 96^3,
  ``find_nearest_triangles``, ``knn``) on the same views and an
  all-occupied grid: the mask and depth MSE within 1e-5 relative, the
  cloud's point count equal, both RMS within 1e-5. The density threshold
  sits between two sigma values of the 96^3 grid that differ by more than
  1e-4 relative, so no cell flips on float32 rounding.
* The 20 held-out views' cameras against the JAX package's.
* ``rescore_backbone_state`` on a ``--state-file`` of ``compare_backbones
  --iters 1 --res 16`` gives the run's own export scores (the backbone's
  configuration, whose cloud is empty after one step, and a dense tiny
  field); ``--verdict-from`` gives the JAX script's verdict.
"""
import importlib.util
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcameras
from dreamwaltz_g_tpu.nerf import export as JEx
from dreamwaltz_g_tpu.nerf import encoder as JEnc
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf import renderer as JR
from dreamwaltz_g_tpu.ops import mesh as JM
from dreamwaltz_g_tpu.ops.raycast import rasterize_mesh as jraster
from dreamwaltz_g_tpu.training import nerf_trainer as JT
from dreamwaltz_g_tpu.training.optim import build_nerf_optimizer as jopt
from dreamwaltz_g_tpu.utils import r_precision as JRP
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.configs import NeRFConfig
from dreamwaltz_g_tpu_torch.guidance.clip_text import tiny_text_config
from dreamwaltz_g_tpu_torch.nerf import network as TN
from dreamwaltz_g_tpu_torch.nerf.renderer import OccupancyGrid
from dreamwaltz_g_tpu_torch.scripts import compare_backbones as CB
from dreamwaltz_g_tpu_torch.scripts import eval_r_precision as ER
from dreamwaltz_g_tpu_torch.scripts import rescore_backbone_state as RB
from dreamwaltz_g_tpu_torch.scripts.record import REPO_ROOT
from dreamwaltz_g_tpu_torch.utils import r_precision as TRP
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-5
PROMPTS = ["a wizard in a blue robe", "an astronaut on the moon",
           "A Knight, in Silver Armour"]
EVAL_RES = 16


def _jax_script(name):
    """A module of the JAX package's ``scripts/`` (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO_ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- eval_r_precision ---------------------------------------------------------

def _renders(tmp_path):
    """Three seeded renders in the tool's three layouts, one of them
    smaller, and the prompt file."""
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "renders"
    d.mkdir()
    names = ["000", "1", ER.slugify(PROMPTS[2])]
    for name, size in zip(names, (48, 30, 48)):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)) \
            .save(d / f"{name}.png")
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n\n")
    return d, prompts


def _tiny_towers():
    jrp = JRP.make_tiny_r_precision(jax.random.PRNGKey(0))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    vc = TRP.tiny_vision_config()
    vision = convert.clip_vision_from_flax(TRP.CLIPVisionModel(vc),
                                           to_np(jrp.vision_params))
    text = convert.clip_text_tower_from_flax(
        TRP.CLIPTextTower(tiny_text_config(), vc.projection_dim),
        to_np(jrp.text_params))
    return jrp, TRP.RPrecision(vision, text, device="cpu")


def test_r_precision_matches_the_jax_script(tmp_path):
    renders, _ = _renders(tmp_path)
    J = _jax_script("eval_r_precision")
    jimages, jkept = J.load_images(renders, PROMPTS)
    images, kept = ER.load_images(renders, PROMPTS)
    assert kept == jkept == [0, 1, 2]
    assert [im.shape for im in images] == [(48, 48, 3), (30, 30, 3),
                                           (48, 48, 3)]
    for a, b in zip(images, jimages):
        np.testing.assert_array_equal(a, b)
    jrp, rp = _tiny_towers()
    ids = ER.tiny_ids(3)
    # the JAX script's computation
    size = max(im.shape[0] for im in jimages)
    stack = np.stack([np.asarray(jax.image.resize(
        jnp.asarray(im), (size, size, 3), "bilinear")) for im in jimages])
    want = np.asarray(jrp.image_features(stack) @ jrp.text_features(ids).T)
    order = np.argsort(-want, axis=1)
    top1 = float(np.mean(order[:, 0] == np.arange(3)))
    top5 = float(np.mean([i in order[i, :5] for i in range(3)]))
    got = ER.score(rp, images, ids)
    assert got["sims"].shape == (3, 3)
    assert np.abs(got["sims"] - want).max() <= TOL * np.abs(want).max()
    assert (got["top1"], got["top5"]) == (top1, top5)


def test_r_precision_tiny_end_to_end(tmp_path, capsys):
    renders, prompts = _renders(tmp_path)
    line = ER.main(["--renders", str(renders), "--prompts", str(prompts),
                    "--tiny", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "n", "top1", "top5", "tiny_towers"}
    assert line["metric"] == "clip_r_precision" and line["n"] == 3
    assert line["tiny_towers"] is True
    assert 0.0 <= line["top1"] <= line["top5"] == 1.0


def test_r_precision_refuses_without_renders(tmp_path):
    (tmp_path / "empty").mkdir()
    prompts = tmp_path / "p.txt"
    prompts.write_text("a prompt\n")
    with pytest.raises(SystemExit, match="no renders"):
        ER.main(["--renders", str(tmp_path / "empty"), "--prompts",
                 str(prompts), "--tiny", "--device", "cpu"])


# -- compare_backbones --------------------------------------------------------

TRIPLANE = dict(triplane_resolution=16, triplane_dim=8, bound=1.0,
                grid_size=16)
GRID = dict(backbone="tiledgrid", num_levels=4, level_dim=2,
            base_resolution=4, desired_resolution=32, log2_hashmap_size=8,
            bound=1.0, grid_size=16)


def _threshold(sigma, quantile):
    """A threshold near ``quantile`` of ``sigma`` between two values more
    than 1e-4 relative apart."""
    v = np.unique(np.sort(sigma.reshape(-1)))
    i = int(quantile * len(v))
    while v[i + 1] - v[i] <= 1e-4 * v[i + 1]:
        i += 1
    return float(0.5 * (v[i] + v[i + 1]))


def _field_pair(fields):
    """The JAX field (no background) with structure, its occupancy grid, the
    port's twin; the density threshold set between the 96^3 grid's
    sigmas."""
    jcfg = JNeRFConfig(**fields)
    jmodel = JN.build_nerf(jcfg, with_background=False)
    params = jmodel.init(jax.random.PRNGKey(3))
    if fields.get("backbone") == "tiledgrid":
        tables = np.random.default_rng(6).normal(
            size=params.encoder.tables.shape).astype(np.float32)
        params = params._replace(encoder=JEnc.GridEncoderParams(
            jnp.asarray(tables)))
    else:
        params = params._replace(encoder=params.encoder._replace(
            planes=params.encoder.planes * 6.0))
    r = CB.EXPORT_RESOLUTION
    xs = (np.arange(r, dtype=np.float32) + 0.5) / r * 2 * jcfg.bound \
        - jcfg.bound
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    sigma = np.concatenate([np.asarray(jmodel.density(params, jnp.asarray(c))
                                       [0]) for c in np.split(g, 8)])
    fields = dict(fields, density_thresh=_threshold(sigma, 0.97))
    jcfg = JNeRFConfig(**fields)
    jmodel = JN.build_nerf(jcfg, with_background=False)
    # every cell occupied: a sample's nearest cell can part on rounding
    # at a cell face, and a refreshed grid then masks it on one side only
    grid = JR.init_occupancy(jcfg.grid_size)
    tmodel = TN.build_nerf(NeRFConfig(**fields), with_background=False,
                           device="cpu")
    convert.nerf_state_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tmodel)
    tgrid = OccupancyGrid(*[torch.as_tensor(np.array(x)) for x in grid])
    return jcfg, jmodel, params, grid, tmodel, tgrid


def _jax_views():
    """The JAX script's 20 eval cameras and their ground truth."""
    from dreamwaltz_g_tpu.human.smplx_model import (
        default_params,
        make_synthetic_model,
        smplx_forward,
    )

    smpl = make_synthetic_model(num_vertices=240, num_joints=6, num_betas=3,
                                num_expr=2)
    verts = jnp.asarray(smplx_forward(smpl, default_params(smpl, 1))
                        .vertices[0])
    faces = jnp.asarray(smpl.faces)
    ev = CB.EVAL_VIEWS
    n, H = len(ev), EVAL_RES
    cams = jcameras(np.full(n, 2.0, np.float32),
                    np.asarray([a for a, _ in ev], np.float32),
                    np.asarray([e for _, e in ev], np.float32),
                    np.full(n, 50.0, np.float32), H, H)
    depth, mask = [], []
    for j in range(n):
        r = jraster(verts, faces, cams.extrinsic[j], cams.intrinsics[j], H, H)
        m = jnp.asarray(r.mask)
        depth.append(jnp.where(m, jnp.asarray(r.depth), 0.0))
        mask.append(m)
    return verts, faces, cams, jnp.stack(depth), jnp.stack(mask)


@pytest.mark.parametrize("backbone", ["triplane", "grid"])
def test_score_field_matches_the_jax_script(backbone):
    fields = TRIPLANE if backbone == "triplane" else GRID
    jcfg, jmodel, params, grid, tmodel, tgrid = _field_pair(fields)
    verts, faces, cams, depth, mask = _jax_views()
    H = EVAL_RES
    n = len(CB.EVAL_VIEWS)
    # the JAX script's composition (compare_backbones.py:255-287)
    tx = jopt(jcfg, 10)
    step = JT.make_pretrain_step(jmodel, tx, H, H, num_steps=CB.PRETRAIN_STEPS,
                                 compact_steps=0)
    state = JT.init_train_state(jmodel, tx, None, params)
    ekeys = jax.random.split(jax.random.PRNGKey(7), n)
    jm, jd, jitters = [], [], []
    for j in range(n):
        _, m = step(state, grid, cams.c2w[j], cams.intrinsics[j], depth[j],
                    mask[j], ekeys[j])
        jm.append(float(m["mask_loss"]))
        jd.append(float(m["depth_loss"]))
        k_render, _ = jax.random.split(ekeys[j])
        jitters.append(torch.as_tensor(np.asarray(jax.random.uniform(
            k_render, (H * H, CB.PRETRAIN_STEPS)))))
    pc = JEx.export_point_cloud(jmodel, params,
                                resolution=CB.EXPORT_RESOLUTION,
                                density_thresh=jcfg.density_thresh,
                                max_points=CB.EXPORT_MAX_POINTS,
                                min_neighbors=jcfg.export_min_neighbors)
    cloud = jnp.asarray(pc.points)
    near = JM.find_nearest_triangles(cloud, verts, faces)
    acc = float(jnp.sqrt(jnp.mean(near.sq_dists)))
    d2, _ = JM.knn(verts, cloud, 1)
    cov = float(jnp.sqrt(jnp.mean(d2)))

    T = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
    views = {"c2w": T(cams.c2w), "intr": T(cams.intrinsics),
             "depth": T(depth), "mask": T(mask)}
    got = CB.score_field(tmodel, tgrid, views, T(verts), T(faces).long(),
                         jitters=jitters)
    assert got["n_cloud_points"] == int(cloud.shape[0]) > 0
    np.testing.assert_allclose(got["eval_mask_mse"], np.mean(jm), rtol=TOL)
    np.testing.assert_allclose(got["eval_depth_mse"], np.mean(jd), rtol=TOL)
    np.testing.assert_allclose(got["cloud_to_mesh_rms"], acc, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["mesh_to_cloud_rms"], cov, rtol=0,
                               atol=TOL)


def test_eval_views_match_the_jax_script():
    verts, faces, cams, depth, mask = _jax_views()
    tv, tf = CB.synthetic_body("cpu")
    np.testing.assert_allclose(tv.numpy(), np.asarray(verts), atol=1e-6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(faces))
    got = CB.eval_views(tv, tf, EVAL_RES, EVAL_RES, "cpu")
    np.testing.assert_allclose(got["c2w"].numpy(), np.asarray(cams.c2w),
                               atol=1e-5)
    np.testing.assert_allclose(got["intr"].numpy(),
                               np.asarray(cams.intrinsics), rtol=1e-6)
    # a pixel whose centre grazes an edge may part on rounding
    agree = (got["mask"].numpy() == np.asarray(mask)).mean()
    assert agree >= 0.999 and np.asarray(mask).any()
    both = got["mask"].numpy() & np.asarray(mask)
    np.testing.assert_allclose(got["depth"].numpy()[both],
                               np.asarray(depth)[both], rtol=1e-5)


DENSE = dict(triplane_resolution=32, triplane_dim=8, bound=1.0,
             density_prior="gaussian", density_thresh=2.0)


@pytest.mark.parametrize("config", ["backbone", "dense"])
def test_rescore_gives_the_runs_export_scores(tmp_path, monkeypatch, capsys,
                                              config):
    if config == "dense":
        monkeypatch.setattr(CB, "backbone_config",
                            lambda name: NeRFConfig(**DENSE))
    state = tmp_path / "state.pt"
    rows = CB.main(["--cpu", "--backbone", "triplane", "--iters", "1",
                    "--res", "16", "--state-file", str(state), "--out",
                    str(tmp_path / "rows.jsonl")])
    saved = torch.load(state, weights_only=True)
    assert saved["step"] == 1 and saved["backbone"] == "triplane"
    min_nb = CB.backbone_config("triplane").export_min_neighbors
    again = RB.main([str(state), "--cpu", "--backbone", "triplane",
                     "--min-neighbors", str(min_nb), "0"])
    # as JSON text: an empty cloud's distances are NaN
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [json.dumps(r) for r in rows + again]
    assert (tmp_path / "rows.jsonl").read_text().splitlines() \
        == [json.dumps(r) for r in rows]
    (row,) = rows
    assert row["backbone"] == "triplane" and row["iters"] == 1
    assert math.isfinite(row["eval_mask_mse"])
    for k in ("cloud_to_mesh_rms", "mesh_to_cloud_rms", "n_cloud_points"):
        a, b = again[0][k], row[k]
        assert a == b or (math.isnan(a) and math.isnan(b)), k
    if config == "dense":
        assert row["n_cloud_points"] > 0
        assert again[1]["n_cloud_points"] >= row["n_cloud_points"]
    else:
        assert row["n_cloud_points"] == 0


def test_verdict_matches_the_jax_script(tmp_path):
    J = _jax_script("compare_backbones")
    h = {"backbone": "hash_2^19_bf16", "eval_mask_mse": 0.01,
         "eval_depth_mse": 0.02, "cloud_to_mesh_rms": 0.03,
         "mesh_to_cloud_rms": 0.04, "train_seconds": 10.0}
    t = {"backbone": "triplane", "eval_mask_mse": 0.012,
         "eval_depth_mse": 0.018, "cloud_to_mesh_rms": 0.02,
         "mesh_to_cloud_rms": 0.05, "train_seconds": 4.0}
    paths = []
    for name, row in (("h", h), ("t", t)):
        paths.append(str(tmp_path / f"{name}.jsonl"))
        with open(paths[-1], "w") as f:
            f.write(json.dumps(row) + "\n")
    (got,) = CB.main(["--verdict-from", *paths])
    assert got == J._verdict(h, t)

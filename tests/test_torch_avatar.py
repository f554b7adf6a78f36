"""Parity of the port's avatar render path against the JAX package, end to
end: ``init_avatar_state``'s geometry, ``animate`` and ``make_avatar_render``
on the JAX tiny avatar carried over by ``convert.avatar_state_from_numpy``.
Also: the package imports nothing of JAX, and its entry points refuse to
run without CUDA unless asked for the CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.human.smplx_model import SMPLXParams as JParams
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.system import avatar as JA
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.convert import avatar_state_from_numpy
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.human.smplx_model import SMPLXParams as TParams
from dreamwaltz_g_tpu_torch.system import avatar as TA
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
import tests.torch_threads  # noqa: F401  (per-worker threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the issue's end-to-end tolerance: float32 chains through SMPL-X, GLBS, the
# field, two MLPs and the blend (observed differences are ~1e-5)
ATOL_E2E = 5e-3


@pytest.fixture(scope="module")
def pair():
    """(JAX tiny setup, port setup carrying the JAX state and weights)."""
    jset = jts.tiny_avatar_setup(
        enc_cfg=JTriplane(resolution=16, feature_dim=8))
    tset = tts.tiny_avatar_setup(device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jset.state)
    tstate = avatar_state_from_numpy(tree, tset.model, device="cpu")
    return jset, tset._replace(state=tstate)


def _pose(jmodel, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    fields = {name: np.zeros(np.shape(x), np.float32)
              for name, x in jts.default_params(jmodel.smpl, 1)._asdict().items()}
    fields["body_pose"] = (rng.normal(size=(1, 63)) * scale).astype(np.float32)
    fields["global_orient"] = (rng.normal(size=(1, 3)) * 0.2).astype(np.float32)
    fields["transl"] = (rng.normal(size=(1, 3)) * 0.05).astype(np.float32)
    return (JParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TParams(**{k: torch.as_tensor(v) for k, v in fields.items()}))


@pytest.mark.parametrize("prune", [None, 0.05])
def test_init_geometry_matches_jax(pair, prune):
    """Nearest triangles -> LBS weights -> inverse LBS, within 1e-4."""
    jset, tset = pair
    jstate = JA.init_avatar_state(jset.model, jset.cloud,
                                  jax.random.PRNGKey(0), capacity=128,
                                  prune_dists_close_to_mesh=prune)
    tstate = TA.init_avatar_state(tset.model, torch.as_tensor(
        np.array(jset.cloud)), capacity=128,
        prune_dists_close_to_mesh=prune, device="cpu")
    np.testing.assert_array_equal(np.asarray(jstate.alive),
                                  tstate.alive.numpy())
    # a point closest to an edge shared by two triangles ties between them;
    # float rounding may pick the other one, whose min-barycentric vertex
    # differs while the interpolated LBS weights (checked below) do not
    same = np.asarray(jstate.vertex_indices) == tstate.vertex_indices.numpy()
    assert same.mean() >= 0.95
    for name in ("positions", "lbs_weights", "log_scales", "quats"):
        np.testing.assert_allclose(np.asarray(getattr(jstate.params, name)),
                                   getattr(tstate.params, name).numpy(),
                                   atol=1e-4)
    jm, tm = jstate.params.mesh["face"], tstate.params.mesh["face"]
    for name in jm._fields:
        np.testing.assert_allclose(np.asarray(getattr(jm, name)),
                                   getattr(tm, name).numpy(), atol=1e-6)
    # the networks were (re)drawn from the generator
    assert tset.model.sq_net.head_scale.weight.abs().max() < 1e-3


def test_animate_matches_jax(pair):
    jset, tset = pair
    # the state-carrying port setup: re-convert, the geometry test re-drew
    # the port model's weights
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jset.state), tset.model,
        device="cpu")
    jp, tp = _pose(jset.model, seed=1)
    jg = JA.animate(jset.model, jset.state, jp)
    tg = TA.animate(tset.model, tstate, tp)
    for name in jg._fields:
        j, t = np.asarray(getattr(jg, name)), getattr(tg, name).detach().numpy()
        if j.dtype == bool:
            np.testing.assert_array_equal(j, t)
        else:
            np.testing.assert_allclose(j, t, atol=ATOL_E2E)


def test_render_matches_jax(pair):
    """``make_avatar_render`` end to end. The JAX render on the CPU blends
    the (T, K) table with no early stop, the port the sorted segments with
    the TPU kernel's tile stop: they differ by at most 1e-4 |value| beyond
    float32 rounding."""
    jset, tset = pair
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jset.state), tset.model,
        device="cpu")
    H = W = 32
    rk = dict(tile_size=16, capacity=64, chunk=16)
    jp, tp = _pose(jset.model, seed=2)
    jc = jcamera(2.0, 20.0, 90.0, 50.0, H, W, at_vector=((0, 0.7, 0),))
    tc = tcamera(2.0, 20.0, 90.0, 50.0, H, W, at_vector=((0, 0.7, 0),),
                 device="cpu")
    bg = np.full((H, W, 3), 0.3, np.float32)
    jout = JG.make_avatar_render(jset.model, H, W, **rk)(
        jset.state, jp, jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
        jnp.asarray(bg))
    tout = TG.make_avatar_render(tset.model, H, W, device="cpu", **rk)(
        tstate, tp, tc.extrinsic[0], tc.intrinsics[0], tc.tanfov[0],
        torch.as_tensor(bg))
    assert float(tout[1].max()) > 0.5   # the body covers pixels
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=ATOL_E2E)


def test_render_frames_match_single_renders(pair):
    jset, tset = pair
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jset.state), tset.model,
        device="cpu")
    H = W = 32
    F = 3
    rk = dict(tile_size=8, capacity=64, chunk=32)
    single = TG.make_avatar_render(tset.model, H, W, device="cpu", **rk)
    frames = TG.make_avatar_render_frames(tset.model, H, W, device="cpu",
                                          **rk)
    poses = [_pose(jset.model, seed=10 + f)[1] for f in range(F)]
    obs = TParams(*[torch.stack([getattr(p, k) for p in poses])
                    for k in TParams._fields])
    cams = tcamera([2.5] * F, [0.0, 120.0, 240.0], [80.0] * F, [55.0] * F,
                   H, W, at_vector=((0, 0.7, 0),), device="cpu")
    bg = torch.full((H, W, 3), 0.3)
    imgs, alphas, depths = frames(tstate, obs, cams.extrinsic,
                                  cams.intrinsics, cams.tanfov, bg)
    assert imgs.shape == (F, H, W, 3) and alphas.shape == (F, H, W)
    for f in range(F):
        img, alpha, depth = single(tstate, poses[f], cams.extrinsic[f],
                                   cams.intrinsics[f], cams.tanfov[f], bg)
        torch.testing.assert_close(imgs[f], img, rtol=0, atol=1e-6)
        torch.testing.assert_close(depths[f], depth, rtol=0, atol=1e-6)


def test_package_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package, and ``chip_smoke.py`` (whose imports sit inside its functions)
    names neither in any import."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "dreamwaltz_g_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "dreamwaltz_g_tpu"}, roots

    code = (
        "import importlib, pkgutil, sys\n"
        "import dreamwaltz_g_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dreamwaltz_g_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _entry_points():
    from dreamwaltz_g_tpu_torch.human.smplx_model import make_synthetic_model

    def model():
        return tts.tiny_avatar_setup(device="cpu").model

    return {
        "make_synthetic_model": lambda: make_synthetic_model(),
        "tiny_avatar_setup": lambda: tts.tiny_avatar_setup(),
        "init_avatar_state": lambda: TA.init_avatar_state(
            model(), torch.zeros(4, 3)),
        "make_avatar_render": lambda: TG.make_avatar_render(model(), 8, 8),
        "make_avatar_render_frames": lambda: TG.make_avatar_render_frames(
            model(), 8, 8),
        "make_camera_batch": lambda: tcamera(2.0, 0.0, 90.0, 50.0, 8, 8),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_cuda(name):
    """Without ``device=`` an entry point asks for CUDA, and on a machine
    without it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_renders_take_the_sorted_blend_only(pair, monkeypatch):
    """The eval renders pass ``mode="eval"``: the sorted blend (B2) renders
    every frame and the table blends (B1, B3) are never reached."""
    from dreamwaltz_g_tpu_torch.ops import rasterize as TR

    _, tset = pair
    calls = []

    def sorted_blend(*a, **k):
        calls.append("blend_sorted")
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a table blend ran on the render path")

    real = TR.blend_sorted
    monkeypatch.setattr(TR, "blend_sorted", sorted_blend)
    monkeypatch.setattr(TR, "blend_tiles_train", refuse)
    monkeypatch.setattr(TR, "blend_tiles_eval", refuse)
    H = W = 16
    cams = tcamera([2.5] * 2, [0.0, 90.0], [80.0] * 2, [55.0] * 2, H, W,
                   at_vector=((0, 0.7, 0),), device="cpu")
    obs = TParams(*[torch.stack([x, x]) for x in tset.observed])
    bg = torch.zeros((H, W, 3))
    rk = dict(tile_size=8, capacity=32, chunk=16)
    TG.make_avatar_render_frames(tset.model, H, W, device="cpu", **rk)(
        tset.state, obs, cams.extrinsic, cams.intrinsics, cams.tanfov, bg)
    TG.make_avatar_render(tset.model, H, W, device="cpu", **rk)(
        tset.state, tset.observed, cams.extrinsic[0], cams.intrinsics[0],
        cams.tanfov[0], bg)
    assert calls == ["blend_sorted"] * 3

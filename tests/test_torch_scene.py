"""The scene options of the port against the JAX package, on the CPU: the
MLP background (``BackgroundMLPNet`` / ``MLPBackground``), the Gaussian
background read from a trained-3DGS PLY (``load_gaussian_background``),
and ``Scene.forward`` with an extra avatar and the per-avatar placement.
The helpers here serve the step tests too: ``test_torch_scene_step.py``
(the SDS step with the placement and the static background Gaussians)
and ``test_torch_scene_split.py`` (the split step).

The tiny avatar of ``tests_support`` (a 16^2 x 8 triplane field; the grid
steps of ``test_torch_grid_steps.py`` take it on a tiled grid), carried
over by ``convert.avatar_state_from_numpy``, and the tiny float32 guidance
with seeded weights (``tests/torch_jax_pairs.py``); 32^2 renders whose blend
chunk equals the tile capacity (no tile stop in the port's plain train
blend; the JAX jnp blend has none).

Tolerances: the background MLP within 1e-6; the PLY background exact;
``Scene.forward`` within 1e-4 (float32 through SMPL-X, GLBS, the field, two
MLPs and the blend); the steps' loss within 1e-4 relative, every
gradient within 2e-3 relative + 2e-4 of its largest entry, the
densification counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.data.camera import get_rays as jget_rays
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.system import background as JB
from dreamwaltz_g_tpu.system import scene as JSc
from dreamwaltz_g_tpu.utils import point_cloud as JPC
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.convert import (avatar_state_from_numpy,
                                            load_flax_dense_params)
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.system import background as TB
from dreamwaltz_g_tpu_torch.system import scene as TSc
from dreamwaltz_g_tpu_torch.utils import point_cloud as TPC
from tests.torch_jax_pairs import grad_close
import tests.torch_threads  # noqa: F401  (per-worker threads)

LATENT = 16
H = W = 2 * LATENT
RASTER = dict(tile_size=16, capacity=128, chunk=128,
              max_tiles_per_gaussian=16)
CAM = dict(radius=2.0, theta=20.0, phi=90.0, fovy=50.0)
AT = ((0, 0.7, 0),)
TRIPLANE = dict(resolution=16, feature_dim=8)
PLACEMENT = (np.float32(0.9), np.asarray([0.05, -0.02, 0.03], np.float32))
N_BG = 300


def _T(a):
    return torch.as_tensor(np.array(a))


def write_background_ply(path, n=N_BG, seed=5):
    """A seeded Gaussian scene on a shell around the avatar, in the
    trained-3DGS PLY layout (DC colors, no higher bands)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return TPC.save_gaussian_ply(
        str(path), d * 1.2 + np.asarray(AT[0]), rng.normal(size=(n, 3)),
        None, rng.normal(size=n) + 1.0, np.full((n, 3), -2.5)
        + 0.2 * rng.normal(size=(n, 3)), rng.normal(size=(n, 4)))


def avatar_pair(jenc=None, tenc=None):
    """The JAX tiny avatar and its port twin on ``jenc`` / ``tenc`` (default:
    the 16^2 x 8 triplane): (JAX setup, port model, the port state)."""
    jset = jts.tiny_avatar_setup(enc_cfg=jenc or JTriplane(**TRIPLANE))
    tset = tts.tiny_avatar_setup(device="cpu", enc_cfg=tenc)
    tstate = avatar_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jset.state), tset.model,
        device="cpu")
    return jset, tset.model, tstate, tset.observed


def cameras():
    return (jcamera(*CAM.values(), H, W, at_vector=AT),
            tcamera(*CAM.values(), H, W, at_vector=AT, device="cpu"))


def step_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return dict(txt=rng.normal(size=(1, 4, 32)).astype(np.float32),
                unc=np.zeros((1, 4, 32), np.float32),
                t=np.array([500], np.int32),
                bg=rng.uniform(size=(H, W, 3)).astype(np.float32))


def fields(params, model):
    """(name, torch leaf, JAX-layout accessor) of every trainable tensor,
    the encoder's whatever its backbone."""
    out = [(n, getattr(params, n), lambda p, n=n: getattr(p, n))
           for n in ("positions", "log_scales", "quats", "lbs_weights")]
    out.append(("encoder", params.encoder[0], lambda p: p.encoder[0]))
    for f in params.mesh["face"]._fields:
        out.append((f"mesh.{f}", getattr(params.mesh["face"], f),
                    lambda p, f=f: getattr(p.mesh["face"], f)))
    for net_name in ("color_mlp", "sq_net"):
        for lname, lin in getattr(model, net_name).named_children():
            out.append((f"{net_name}.{lname}.kernel", lin.weight,
                        lambda p, a=net_name, b=lname:
                        np.asarray(getattr(p, a)["params"][b]["kernel"]).T))
            out.append((f"{net_name}.{lname}.bias", lin.bias,
                        lambda p, a=net_name, b=lname:
                        getattr(p, a)["params"][b]["bias"]))
    return out


def check_grads(params, model, jgrads):
    """Every leaf's gradient against JAX's; the quaternions start
    isotropic, so theirs is float32 noise on both sides; a leaf JAX gives
    no gradient (the rotation head without non-rigid rotations) gets none
    here either."""
    scale = float(np.abs(np.asarray(jgrads.positions)).max())
    for name, leaf, get in fields(params, model):
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        want = np.asarray(get(jgrads))
        if name == "quats":
            assert float(got.abs().max()) < 1e-6 * scale
            assert float(np.abs(want).max()) < 1e-6 * scale
        elif not want.any():      # a head the loss does not reach
            assert not got.any(), name
        else:
            grad_close(name, got.numpy(), want)


def test_background_mlp_matches_flax():
    """``BackgroundMLPNet`` on Flax's weights and ``MLPBackground`` at a
    camera: the same (H, W, 3) image within 1e-6."""
    jnet = JB.BackgroundMLPNet()
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    tnet = TB.BackgroundMLPNet(device="cpu")
    load_flax_dense_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    jc, tc = cameras()
    want = JB.MLPBackground(jnet)(params, jc)
    got = TB.MLPBackground(tnet)(tc)
    assert got.shape == (H, W, 3) and float(np.asarray(want).std()) > 1e-3
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    _, rd = jget_rays(jc.c2w[:1], jc.intrinsics[:1], H, W)
    np.testing.assert_allclose(
        tnet(_T(rd[0])).detach().numpy(), np.asarray(jnet.apply(params,
                                                                 rd[0])),
        atol=1e-6)
    # the port's initialiser is Flax's: truncated LeCun kernels, zero bias
    tnet.reset_parameters(torch.Generator().manual_seed(0))
    assert float(tnet.dense_0.bias.detach().abs().max()) == 0.0
    w = tnet.dense_0.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / w.shape[1]) ** 0.5 / 0.8796 + 1e-6
    np.testing.assert_array_equal(
        TB.PureColorBackground.make("gray", device="cpu")(tc).numpy(),
        np.asarray(JB.PureColorBackground.make("gray")(jc)))


def test_gaussian_background_from_ply_is_exact(tmp_path):
    """The PLY written by the port's ``save_gaussian_ply`` is the JAX
    writer's byte for byte, both readers give the same arrays, and
    ``load_gaussian_background`` gives the JAX function's ``GaussiansOut``:
    the positions, colors and masks exactly, the activated fields to an
    ulp."""
    rng = np.random.default_rng(0)
    n = 50
    cols = (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
            rng.normal(size=(n, 15, 3)), rng.normal(size=n),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 4)))
    p1 = TPC.save_gaussian_ply(str(tmp_path / "t.ply"), *cols)
    p2 = JPC.save_gaussian_ply(str(tmp_path / "j.ply"), *cols)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    got, want = TPC.load_gaussian_ply(p1), JPC.load_gaussian_ply(p1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tg = TB.load_gaussian_background(p1, device="cpu")
    jg = JB.load_gaussian_background(p1)
    for name in jg._fields:
        got, want = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        if name in ("opacities", "scales", "quats"):
            # sigmoid, exp and the norm's sqrt: XLA's and torch's float32
            # functions part by an ulp
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_scene_forward_with_extra_avatar_and_placement_matches_jax():
    """``Scene.forward`` composing the avatar with a second one (the same
    model and state), each placed by its own scale and translation."""
    jset, tmodel, tstate, tobs = avatar_pair()
    scale = np.asarray([1.0, 0.8], np.float32)
    transl = np.asarray([[0.25, 0.0, 0.0], [-0.25, 0.05, 0.0]], np.float32)
    jc, tc = cameras()
    bg = np.full((H, W, 3), 0.2, np.float32)
    scene = JSc.Scene(jset.model, (jset.model,), jnp.asarray(scale),
                      jnp.asarray(transl))
    jr = jax.jit(lambda st, obs: scene.forward(
        st, jc, jnp.asarray(bg), obs, extra_states=(st,), **RASTER))(
        jset.state, jset.observed)
    with torch.no_grad():
        tr = TSc.Scene(tmodel, (tmodel,), _T(scale), _T(transl)).forward(
            tstate, tc, _T(bg), tobs, extra_states=(tstate,), **RASTER)
    assert float(tr.alpha.max()) > 0.5
    assert tr.radii.shape[0] == 2 * jset.state.capacity \
        + 2 * jset.model.n_mesh_points
    for name in JSc.SceneRender._fields:
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), atol=1e-4,
                                   err_msg=name)

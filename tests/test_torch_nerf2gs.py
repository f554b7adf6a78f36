"""The NeRF -> 3DGS distillation of the port against the JAX package, on the
CPU: the image reconstruction loss (L1 + DSSIM), ``make_nerf2gs_step`` and
``Trainer.pretrain_nerf2gs``.

* ``ssim`` within 1e-6 absolute (SSIM's scale is 1, its range [-1, 1]:
  the mean of a map of differences of nearly equal window sums) and
  ``image_reconstruction_loss`` within 1e-6 relative; both gradients
  within 3e-6 of their largest entry of the JAX ones, whose own float32
  error against a float64 evaluation is 0.9-1.9e-6 of it on these inputs,
  and within 1e-6 of it of the port's float64 evaluation (``F.conv2d``
  with explicit zero padding against the JAX package's 1-D convolutions
  of the zero-padded rows);
* the whole step against ``jax.value_and_grad`` of the JAX step's loss on
  the tiny avatar (carried over by ``convert.avatar_state_from_numpy``),
  in the envelope of ``tests/test_torch_sds_step.py``: the loss within
  1e-4 relative, each gradient within 2e-3 relative plus 2e-4 of its
  largest entry, the densification counts equal, the updated parameters
  within 1e-6 where the gradient stands clear of rounding; the render's
  blend is the JAX package's jnp blend and the port's plain train blend,
  which differ by float32 rounding only (no tile's pixels all fall below
  T = 1e-4 here);
* ``pretrain_nerf2gs``: the JAX trainer's own method, run on a namespace
  of the JAX providers with the step replaced by a recorder, hands its
  step the same cameras (within 1e-5) and the same frozen field's target
  renders (within 5e-3, the render tolerance of
  ``tests/test_torch_evaluate.py``) as the port's trainer; the port's
  field is bit for bit unchanged after its steps, and the avatar moved.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.configs import NeRFConfig as JNeRFConfig
from dreamwaltz_g_tpu.configs import RenderConfig as JRenderConfig
from dreamwaltz_g_tpu.configs import parse_args as jparse
from dreamwaltz_g_tpu.data.camera import make_camera_batch as jcamera
from dreamwaltz_g_tpu.nerf import network as JN
from dreamwaltz_g_tpu.nerf.encoder import TriplaneConfig as JTriplane
from dreamwaltz_g_tpu.training import gs_trainer as JG
from dreamwaltz_g_tpu.training import losses as JLo
from dreamwaltz_g_tpu.training import optim as JO
from dreamwaltz_g_tpu.training.trainer import Trainer as JTrainer
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.configs import NeRFConfig, RenderConfig
from dreamwaltz_g_tpu_torch.data.camera import make_camera_batch as tcamera
from dreamwaltz_g_tpu_torch.ops import blend_train as BT
from dreamwaltz_g_tpu_torch.training import gs_trainer as TG
from dreamwaltz_g_tpu_torch.training import losses as TLo
from dreamwaltz_g_tpu_torch.training import optim as TO

H = W = 32
RASTER = dict(tile_size=16, capacity=64, chunk=32)
MAX_STEPS = 5000
LOSS_REL = 1e-6
GRAD_OF_MAX = 3e-6
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-3, 2e-4
UPDATE_MIN_GRAD = 1e-3
TARGET_ATOL = 5e-3


def _images(seed=0, shape=(20, 28, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    # b: a blurred, shifted copy plus noise, so that SSIM is far from 0 and 1
    b = 0.6 * np.roll(a, 2, axis=1) + 0.4 * rng.uniform(size=shape)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("which", ["ssim", "image_reconstruction_loss"])
def test_image_losses_and_gradients_match_jax(which):
    a, b = _images()
    jf, tf = getattr(JLo, which), getattr(TLo, which)
    jv, (jga, jgb) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tv = tf(ta, tb)
    tv.backward()
    tv = float(tv.detach())
    assert 0.05 < tv < 0.95
    if which == "ssim":
        assert abs(tv - float(jv)) <= LOSS_REL
    else:
        np.testing.assert_allclose(tv, float(jv), rtol=LOSS_REL)
    a64 = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    b64 = torch.tensor(b, dtype=torch.float64, requires_grad=True)
    tf(a64, b64).backward()
    for got, want, exact in ((ta.grad, jga, a64.grad),
                             (tb.grad, jgb, b64.grad)):
        want = np.asarray(want)
        peak = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= GRAD_OF_MAX * peak
        assert np.abs(got.numpy() - exact.numpy()).max() <= LOSS_REL * peak


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _images(1, (16, 16, 3))
    t = torch.as_tensor(a)
    assert abs(float(TLo.ssim(t, t)) - 1.0) < 1e-6
    assert float(TLo.image_reconstruction_loss(t, t)) < 1e-6


def _fields(params, model):
    """(name, torch leaf, JAX-layout accessor) for every trainable tensor."""
    out = [(n, getattr(params, n), lambda p, n=n: getattr(p, n))
           for n in ("positions", "log_scales", "quats", "lbs_weights",
                     "extra_betas")]
    out.append(("encoder.planes", params.encoder.planes,
                lambda p: p.encoder.planes))
    for f in params.mesh["face"]._fields:
        out.append((f"mesh.{f}", getattr(params.mesh["face"], f),
                    lambda p, f=f: getattr(p.mesh["face"], f)))
    for net_name in ("color_mlp", "sq_net"):
        net = getattr(model, net_name)
        for lname, lin in net.named_children():
            out.append((f"{net_name}.{lname}.kernel", lin.weight,
                        lambda p, a=net_name, b=lname:
                        np.asarray(getattr(p, a)["params"][b]["kernel"]).T))
            out.append((f"{net_name}.{lname}.bias", lin.bias,
                        lambda p, a=net_name, b=lname:
                        getattr(p, a)["params"][b]["bias"]))
    return out


def _check_grad(name, got, want):
    want = np.asarray(want)
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float((err - bound).max()),
                                  float(np.abs(want).max()))


@pytest.fixture(scope="module")
def step_case():
    """The JAX step's loss, gradients and new state, and its inputs."""
    jset = jts.tiny_avatar_setup(enc_cfg=JTriplane(resolution=16,
                                                   feature_dim=8))
    cam = dict(radius=2.0, theta=20.0, phi=90.0, fovy=50.0)
    jc = jcamera(*cam.values(), H, W, at_vector=((0, 0.7, 0),))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    r2 = ((yy - H * 0.4) ** 2 + (xx - W / 2) ** 2) / (H * 0.35) ** 2
    inputs = dict(bg=rng.uniform(size=(H, W, 3)).astype(np.float32),
                  target=rng.uniform(size=(H, W, 3)).astype(np.float32),
                  alpha=np.clip(1.5 - r2, 0.0, 1.0).astype(np.float32))
    state = jset.state
    C, M = state.capacity, jset.model.n_mesh_points

    def loss_fn(params, dummy):
        image, out = JG._render_with_dummy(
            jset.model, state, params, jset.observed, dummy,
            jc.extrinsic[0], jc.intrinsics[0], jc.tanfov[0],
            jnp.asarray(inputs["bg"]), H, W, RASTER)
        m = jnp.asarray(inputs["alpha"])[..., None]
        return JLo.image_reconstruction_loss(
            image * m, jnp.asarray(inputs["target"]) * m), out.alpha

    (loss, alpha), (grads, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, jnp.zeros((C + M, 2), jnp.float32))
    assert float(alpha.max()) > 0.5          # the body covers pixels
    tx = JO.build_avatar_optimizer(JRenderConfig(), MAX_STEPS)
    jstep = JG.make_nerf2gs_step(jset.model, tx, H, W, **RASTER)
    jnew, jm = jstep(JG.AvatarTrainState(state, tx.init(state.params), 0),
                     jset.observed, jc.extrinsic[0], jc.intrinsics[0],
                     jc.tanfov[0], jnp.asarray(inputs["bg"]),
                     jnp.asarray(inputs["target"]),
                     jnp.asarray(inputs["alpha"]))
    np.testing.assert_allclose(float(jm["loss"]), float(loss), rtol=1e-6)
    tset = tts.tiny_avatar_setup(device="cpu")
    tc = tcamera(*cam.values(), H, W, at_vector=((0, 0.7, 0),),
                 device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, state)
    return dict(loss=float(loss), grads=grads, new=jnew.avatar,
                model=tset.model, observed=tset.observed,
                cam=(tc.extrinsic[0], tc.intrinsics[0], tc.tanfov[0]),
                inputs={k: torch.as_tensor(v) for k, v in inputs.items()},
                fresh=lambda: convert.avatar_state_from_numpy(
                    tree, tset.model, device="cpu"))


def test_nerf2gs_step_matches_jax(step_case):
    """The loss, every trainable tensor's gradient, the densification
    statistics and the updated parameters after one step; on the CPU the
    blend's plain versions run and no kernel launches."""
    c = step_case
    model, x = c["model"], c["inputs"]
    tstate = TG.init_avatar_train_state(
        c["fresh"](), TO.build_avatar_optimizer(RenderConfig(), MAX_STEPS),
        model)
    step = TG.make_nerf2gs_step(model, H, W, device="cpu", **RASTER)
    launches = (BT.blend_train_fwd.launches, BT.blend_train_bwd.launches)
    new, m = step(tstate, c["observed"], *c["cam"], x["bg"], x["target"],
                  x["alpha"])
    assert (BT.blend_train_fwd.launches,
            BT.blend_train_bwd.launches) == launches
    assert new.step == 1 and tstate.opt_state.count == 1
    np.testing.assert_allclose(float(m["loss"]), c["loss"], rtol=LOSS_RTOL)
    jnew = c["new"]
    np.testing.assert_array_equal(new.avatar.grad_denom.numpy(),
                                  np.asarray(jnew.grad_denom))
    np.testing.assert_array_equal(new.avatar.max_radii.numpy(),
                                  np.asarray(jnew.max_radii))
    assert float(new.avatar.grad_denom.sum()) > 0
    _check_grad("grad_accum", new.avatar.grad_accum.numpy(),
                jnew.grad_accum)
    scale = float(np.abs(np.asarray(c["grads"].positions)).max())
    assert scale > 0
    for name, leaf, get in _fields(new.avatar.params, model):
        want = np.asarray(get(c["grads"]))
        got = np.zeros_like(want) if leaf.grad is None \
            else leaf.grad.numpy()
        if name == "quats":
            # isotropic Gaussians: a rotation gradient of float32 noise
            assert np.abs(got).max() < 1e-6 * scale
            continue
        _check_grad(name, got, want)
        sure = np.abs(want) > UPDATE_MIN_GRAD * max(np.abs(want).max(),
                                                    1e-30)
        np.testing.assert_allclose(leaf.detach().numpy()[sure],
                                   np.asarray(get(jnew.params))[sure],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


# -- the trainer's loop -------------------------------------------------------

FIELD = dict(triplane_resolution=16, triplane_dim=8)


def _argv(tmp_path, name, *extra):
    return ["--stage", "gs", "--log.debug", "true",
            "--log.exp_root", str(tmp_path), "--log.exp_name", name,
            "--optim.seed", "3", "--guide.text", "a dancer",
            "--nerf.triplane_resolution", "16", "--nerf.triplane_dim", "8",
            "--render.n_gaussians", "256", "--render.nerf_resolution", "24",
            "--nerf.density_thresh", "1.0", "--nerf.num_steps", "32",
            "--data.train_w", "24", "--data.train_h", "24",
            "--log.snapshot_interval", "0", "--log.evaluate_interval", "0",
            "--render.tile_size", "8", "--render.tile_capacity", "64",
            "--render.chunk", "16", "--optim.iters", "2", *extra]


def _jax_field():
    """A JAX field whose density exceeds 1 in places (planes x 6)."""
    jmodel = JN.build_nerf(JNeRFConfig(**FIELD), with_background=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    params = params._replace(encoder=params.encoder._replace(
        planes=params.encoder.planes * 6.0))
    return jmodel, params


def _jax_providers(jcfg):
    """The JAX trainer's prompt and training camera, built as its Trainer
    builds them (the debug body)."""
    from dreamwaltz_g_tpu.data.sampler import RandomCamera4Avatar
    from dreamwaltz_g_tpu.human.keypoints import openpose_keypoints
    from dreamwaltz_g_tpu.human.prompt import SMPLPrompt
    from dreamwaltz_g_tpu.human.smplx_model import make_synthetic_model

    smpl = make_synthetic_model()
    prompt = SMPLPrompt(jcfg.prompt, smpl,
                        cond_type=list(jcfg.guide.controlnet_condition),
                        height=512, width=512, seed=jcfg.optim.seed)
    res = int(jcfg.data.train_w)
    cam = RandomCamera4Avatar(jcfg.data, res, res, seed=jcfg.optim.seed)
    kp = np.asarray(openpose_keypoints(smpl, prompt.canonical_outputs,
                                       prompt.condition.landmarks))
    if np.isfinite(kp[:, :18]).all():
        cam.setup_camera_offset(kp)
    return types.SimpleNamespace(cfg=jcfg, smpl=smpl, prompt=prompt,
                                 train_camera=cam, train_res=res,
                                 rng=np.random.default_rng(jcfg.optim.seed))


def test_pretrain_nerf2gs_matches_jax(tmp_path, monkeypatch):
    jmodel, params = _jax_field()
    tree = jax.tree_util.tree_map(np.asarray, params)
    convert.nerf_checkpoint_from_numpy(
        tree, NeRFConfig(**FIELD),
        tmp_path / "field" / "checkpoints" / "step_00000000")
    argv = _argv(tmp_path, "n2g", "--log.nerf2gs", "true",
                 "--render.from_nerf", str(tmp_path / "field"))

    # JAX: its own method, the step a recorder
    jcfg = jparse(argv)
    ns = _jax_providers(jcfg)
    jseen = []

    def jmake(model, tx, Hs, Ws, **kw):
        assert (Hs, Ws) == (ns.train_res,) * 2
        assert kw == dict(tile_size=8, capacity=64, chunk=16)

        def step(tstate, obs, extr, intr, tanfov, bg, target, alpha):
            jseen.append([np.asarray(a) for a in (extr, bg, target, alpha)])
            return tstate, {"loss": jnp.float32(0.0)}
        return step

    monkeypatch.setattr(JG, "make_nerf2gs_step", jmake)
    ns.__dict__.update(
        _nerf_guidance=(jmodel, params), avatar_model=None, tx=None,
        state=None, train_step=0, max_iteration=jcfg.optim.iters,
        save_checkpoint=lambda: None)
    ns._bg_color = types.MethodType(JTrainer._bg_color, ns)
    JTrainer.pretrain_nerf2gs(ns)

    # the port: its trainer, the real step, its inputs recorded
    from dreamwaltz_g_tpu_torch.main import main
    from dreamwaltz_g_tpu_torch.training.checkpoint import resolve_ckpt_path
    from dreamwaltz_g_tpu_torch.training.trainer import avatar_tree

    tseen, start = [], {}
    make = TG.make_nerf2gs_step

    def tmake(*a, **kw):
        step = make(*a, **kw)

        def recorded(tstate, obs, extr, intr, tanfov, bg, target, alpha):
            tseen.append([t.detach().numpy().copy()
                          for t in (extr, bg, target, alpha)])
            return step(tstate, obs, extr, intr, tanfov, bg, target, alpha)
        return recorded

    monkeypatch.setattr(TG, "make_nerf2gs_step", tmake)
    from dreamwaltz_g_tpu_torch.training.trainer import Trainer

    init = Trainer._init_avatar

    def snap(self):
        init(self)
        start["avatar"] = {k: v.detach().clone() for k, v in avatar_tree(
            self.state.avatar, self.avatar_model).items()
            if torch.is_tensor(v)}
        start["field"] = {k: v.clone() for k, v in
                          self._nerf_guidance[0].state_dict().items()}

    monkeypatch.setattr(Trainer, "_init_avatar", snap)
    tr = main(argv + ["--log.platform", "cpu"])

    assert len(tseen) == len(jseen) == 2 and tr.train_step == 2
    assert all(np.isfinite(tr.losses)) and len(tr.losses) == 2
    for t, j in zip(tseen, jseen):
        np.testing.assert_allclose(t[0], j[0], atol=1e-5)      # extrinsic
        np.testing.assert_array_equal(t[1], j[1])              # background
        np.testing.assert_allclose(t[2], j[2], atol=TARGET_ATOL)
        np.testing.assert_allclose(t[3], j[3], atol=TARGET_ATOL)
        assert t[3].max() > 0.5                  # the field covers pixels
    # the frozen field, bit for bit; the avatar moved; a checkpoint
    for k, v in tr._nerf_guidance[0].state_dict().items():
        assert torch.equal(v, start["field"][k]), k
    now = avatar_tree(tr.state.avatar, tr.avatar_model)
    assert not torch.equal(now["positions"], start["avatar"]["positions"])
    assert resolve_ckpt_path(tr.exp_dir).name == "step_00000002"


def test_nerf2gs_step_defaults_to_cuda():
    """Without ``device=`` the step asks for CUDA, and on a machine without
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    tset = tts.tiny_avatar_setup(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.make_nerf2gs_step(tset.model, 8, 8)

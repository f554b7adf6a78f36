"""The VPoser decoder and the 'vposer' scene of the port against the JAX
package, on the CPU.

Tolerances: the rotation conversions within 1e-5 (absolute, on values of
order 1); the decoder's axis-angles within 2e-5 absolute (angles up to pi;
float32 rounding of 512-wide dot products in two frameworks, ~1e-6, which
the Gram-Schmidt frame and ``arccos`` amplify at the angles near pi that
random weights give); the
'vposer' scene's SMPL-X poses and outputs within 1e-5 with the
JAX pose draws handed to the port (``tests/test_torch_prompt.py``'s
recovery of the normals from the JAX pose); the numpy generator's state
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.configs import PromptConfig as JPromptConfig
from dreamwaltz_g_tpu.human import prompt as JPr
from dreamwaltz_g_tpu.human import smplx_model as JX
from dreamwaltz_g_tpu.human import vposer as JV
from dreamwaltz_g_tpu_torch.configs import PromptConfig
from dreamwaltz_g_tpu_torch.human import prompt as TPr
from dreamwaltz_g_tpu_torch.human import smplx_model as TX
from dreamwaltz_g_tpu_torch.human import vposer as TV
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-5
AA_TOL = 2e-5


def _state_dict(seed=0):
    """A V02_05 decoder's state dict (human_body_prior's names), numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (o, n) in zip((1, 3, 5), ((512, 32), (512, 512), (126, 512))):
        sd[f"decoder_net.{i}.weight"] = (rng.normal(size=(o, n))
                                         / np.sqrt(n)).astype(np.float32)
        sd[f"decoder_net.{i}.bias"] = (rng.normal(size=(o,)) * 0.1
                                       ).astype(np.float32)
    return sd


def test_rotation_conversions_match_jax():
    x = np.random.default_rng(1).normal(size=(7, 21, 6)).astype(np.float32)
    jR = JV.rot6d_to_matrix(jnp.asarray(x))
    tR = TV.rot6d_to_matrix(torch.as_tensor(x))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=TOL)
    # proper rotations
    eye = tR @ tR.transpose(-1, -2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(3, dtype=np.float32), eye.shape), atol=TOL)
    np.testing.assert_allclose(
        TV.matrix_to_axis_angle(tR).numpy(),
        np.asarray(JV.matrix_to_axis_angle(jR)), atol=TOL)


def test_decoder_matches_jax():
    sd = _state_dict()
    z = np.random.default_rng(2).normal(size=(5, 32)).astype(np.float32)
    want = np.asarray(JV.vposer_from_torch(sd).decode(jnp.asarray(z)))
    vp = TV.vposer_from_torch(sd, device="cpu")
    got = vp.decode(torch.as_tensor(z))
    assert got.shape == (5, 63)
    np.testing.assert_allclose(got.numpy(), want, atol=AA_TOL)
    # the prior: a seeded draw, decoded
    g = torch.Generator().manual_seed(4)
    a = vp.sample(g, batch_size=3)
    z2 = torch.randn((3, 32), generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, vp.decode(z2))


@pytest.mark.parametrize("kind", ["npz", "ckpt"])
def test_load_vposer(tmp_path, kind):
    """A pre-converted ``.npz`` and a torch ``.ckpt`` (the snapshot's
    ``vp_model.`` prefix, encoder keys beside the decoder's), read by both
    packages, decode alike; a missing path gives None."""
    sd = _state_dict(3)
    if kind == "npz":
        path = tmp_path / "vposer.npz"
        np.savez(path, **sd)
    else:
        path = tmp_path / "V02_05.ckpt"
        tree = {f"vp_model.{k}": torch.as_tensor(v) for k, v in sd.items()}
        tree["vp_model.encoder_net.1.weight"] = torch.zeros(4, 4)
        torch.save({"state_dict": tree}, path)
    z = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32)
    want = np.asarray(JV.load_vposer(str(path)).decode(jnp.asarray(z)))
    got = TV.load_vposer(str(path), device="cpu").decode(torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), want, atol=AA_TOL)
    assert TV.load_vposer(str(tmp_path / "absent.npz"), device="cpu") is None
    assert TV.load_vposer(None, device="cpu") is None


def _bodies():
    kw = dict(num_vertices=300, num_joints=55, num_betas=10, num_expr=10,
              seed=0)
    return JX.make_synthetic_model(**kw), \
        TX.make_synthetic_model(device="cpu", **kw)


def test_vposer_scene_matches_jax():
    """``--prompt.scene vposer`` (no ``sample_body_fn``, as both trainers
    build it): a random scene without the canonical mixup, body poses from
    the scaled-normal prior, hands and expression at rest."""
    jbody, tbody = _bodies()
    cfg = dict(scene="vposer", canonical_mixup_prob=0.5)
    jpr = JPr.SMPLPrompt(JPromptConfig(**cfg), jbody, seed=3)
    tpr = TPr.SMPLPrompt(PromptConfig(**cfg), tbody, seed=3)
    assert tpr.scene_type == jpr.scene_type == "random"
    for i in range(3):
        jp, jo = jpr(batch_idx=i)
        body = np.asarray(jp.body_pose)
        assert np.abs(body).max() > 0
        tp, to = tpr(batch_idx=i, draws={
            "body": torch.as_tensor(body / 0.3)})
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
        np.testing.assert_allclose(to.vertices.numpy(),
                                   np.asarray(jo.vertices), atol=TOL)
        assert not tp.left_hand_pose.any() and not tp.expression.any()
    assert tpr._rng.bit_generator.state == jpr._rng.bit_generator.state


def test_vposer_scene_takes_the_body_sampler():
    """With ``sample_body_fn`` the body pose is the sampler's, in both
    packages (a fixed pose here, whatever the key or generator)."""
    jbody, tbody = _bodies()
    pose = np.random.default_rng(6).normal(size=(1, 63)).astype(np.float32) \
        * 0.2
    cfg = dict(scene="vposer")
    jpr = JPr.SMPLPrompt(JPromptConfig(**cfg), jbody, seed=1,
                         sample_body_fn=lambda key, b: jnp.asarray(pose))
    tpr = TPr.SMPLPrompt(PromptConfig(**cfg), tbody, seed=1,
                         sample_body_fn=lambda g, b: torch.as_tensor(pose))
    jp, jo = jpr()
    tp, to = tpr()
    np.testing.assert_allclose(tp.body_pose.numpy(), pose, atol=TOL)
    np.testing.assert_allclose(np.asarray(jp.body_pose), pose, atol=TOL)
    np.testing.assert_allclose(to.vertices.numpy(), np.asarray(jo.vertices),
                               atol=TOL)
    # the decoder as the sampler: a (1, 63) pose from the prompt's generator
    vp = TV.vposer_from_torch(_state_dict(), device="cpu")
    tpr = TPr.SMPLPrompt(PromptConfig(**cfg), tbody, seed=1,
                         sample_body_fn=vp.sample_body_fn())
    tp, _ = tpr()
    assert tp.body_pose.shape == (1, 63) and tp.body_pose.abs().max() > 0
    assert jax.numpy.isfinite(jnp.asarray(tp.body_pose.numpy())).all()


@pytest.mark.parametrize("name", ["VPoser", "vposer_from_torch",
                                  "load_vposer"])
def test_vposer_defaults_to_cuda(name, tmp_path):
    """Without ``device=`` each entry point asks for CUDA, and on a machine
    without it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    np.savez(tmp_path / "v.npz", **_state_dict())
    make = {"VPoser": lambda: TV.VPoser(),
            "vposer_from_torch": lambda: TV.vposer_from_torch(_state_dict()),
            "load_vposer": lambda: TV.load_vposer(str(tmp_path / "v.npz"))}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make[name]()

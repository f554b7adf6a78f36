"""The port's leaf helpers against the JAX package's, on seeded numpy
inputs, on the CPU.

* ``utils/transforms.py``: ``quat_identity``, ``quat_conjugate`` and
  ``transform_points_homogeneous`` (a w near 0 among the points), and
  ``nerf/encoder.py:freq_output_dim``: within 1e-6;
  ``human/glbs.py:LEARNABLE_TEMPLATE_KEYS`` equal.
* ``data/camera.py``: ``camera_wireframes`` (segments within 1e-6, colours
  equal) and ``draw_camera_viz`` (the canvases within one 8-bit level).
* ``utils/overlay.py:overlay_pngs_on_video`` on a 4-frame 32^2 mp4 written
  with OpenCV and four RGBA PNGs: the overlay's PNG frames and its mp4's
  frames within one 8-bit level of the JAX package's.
* The constructors that default to the card (``DMTetModel.create``,
  ``make_add_time_ids``, ``quat_identity``) refuse on a host without CUDA,
  with ``resolve_device``'s error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.data import camera as JC
from dreamwaltz_g_tpu.nerf import encoder as JE
from dreamwaltz_g_tpu.utils import overlay as JO
from dreamwaltz_g_tpu.utils import transforms as JT
from dreamwaltz_g_tpu_torch.data import camera as TC
from dreamwaltz_g_tpu_torch.nerf import encoder as TE
from dreamwaltz_g_tpu_torch.utils import overlay as TO
from dreamwaltz_g_tpu_torch.utils import transforms as TT
import tests.torch_threads  # noqa: F401  (per-worker threads)

TOL = 1e-6


def _poses(n, seed=0):
    """Seeded camera-to-world poses (n, 4, 4): rotations from random
    quaternions, translations within 3 of the origin."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, :3, :3] = np.asarray(JT.quat_to_matrix(jnp.asarray(q)))
    c2w[:, :3, 3] = rng.uniform(-3, 3, (n, 3))
    return c2w


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_quat_identity_matches_jax(shape):
    got = TT.quat_identity(shape, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JT.quat_identity(shape)))
    assert got.dtype == torch.float32


def test_quat_conjugate_matches_jax():
    q = np.random.default_rng(1).standard_normal((7, 4)).astype(np.float32)
    np.testing.assert_allclose(TT.quat_conjugate(torch.as_tensor(q)).numpy(),
                               np.asarray(JT.quat_conjugate(jnp.asarray(q))),
                               rtol=0, atol=TOL)
    # the conjugate of a unit quaternion undoes its rotation
    u = torch.as_tensor(q / np.linalg.norm(q, axis=-1, keepdims=True))
    v = torch.randn((7, 3), generator=torch.Generator().manual_seed(0))
    back = TT.quat_rotate(TT.quat_conjugate(u), TT.quat_rotate(u, v))
    assert float((back - v).abs().max()) < 1e-5


@pytest.mark.parametrize("batch", [(), (4,)])
def test_transform_points_homogeneous_matches_jax(batch):
    rng = np.random.default_rng(2)
    mat = rng.standard_normal(batch + (4, 4)).astype(np.float32)
    pts = rng.standard_normal(batch + (9, 3)).astype(np.float32)
    mat = np.broadcast_to(mat[..., None, :, :], batch + (9, 4, 4)).copy()
    # a w of exactly 0 and one just below 0 take the safe divide
    mat[..., 0, 3, :] = 0.0
    mat[..., 1, 3, :3] = 0.0
    mat[..., 1, 3, 3] = -1e-9
    got_p, got_w = TT.transform_points_homogeneous(torch.as_tensor(mat),
                                                   torch.as_tensor(pts))
    want_p, want_w = JT.transform_points_homogeneous(jnp.asarray(mat),
                                                     jnp.asarray(pts))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dim,degree,include", [(3, 6, True), (3, 6, False),
                                                (2, 10, True), (4, 0, True)])
def test_freq_output_dim_matches_jax(dim, degree, include):
    want = JE.freq_output_dim(dim, degree, include)
    assert TE.freq_output_dim(dim, degree, include) == want
    x = torch.zeros((1, dim))
    assert TE.frequency_encode(x, degree, include).shape[-1] == want


@pytest.mark.parametrize("dirs,draw_axis", [(None, True), ("seeded", True),
                                            ("seeded", False)])
def test_camera_wireframes_match_jax(dirs, draw_axis):
    c2w = _poses(5)
    if dirs == "seeded":
        dirs = np.random.default_rng(3).integers(0, 9, 5)
    got_s, got_c = TC.camera_wireframes(c2w, dirs=dirs, draw_axis=draw_axis)
    want_s, want_c = JC.camera_wireframes(c2w, dirs=dirs,
                                          draw_axis=draw_axis)
    assert got_s.dtype == np.float32 and got_c.dtype == np.uint8
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_c, want_c)


def test_camera_wireframes_of_one_pose():
    c2w = _poses(1)[0]
    got_s, _ = TC.camera_wireframes(c2w)
    want_s, _ = JC.camera_wireframes(c2w)
    assert got_s.shape == (11, 2, 3)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)


@pytest.mark.parametrize("plane,with_body", [("xz", False), ("xy", True),
                                             ("zy", True)])
def test_draw_camera_viz_matches_jax(plane, with_body):
    c2w = _poses(4)
    dirs = np.arange(4)
    body = np.random.default_rng(4).uniform(-0.5, 0.5, (60, 3)) \
        if with_body else None
    got = TC.draw_camera_viz(c2w, dirs=dirs, smpl_vertices=body,
                             image_size=128, plane=plane)
    want = JC.draw_camera_viz(c2w, dirs=dirs, smpl_vertices=body,
                              image_size=128, plane=plane)
    assert got.shape == (128, 128, 3) and got.dtype == np.uint8
    assert (got != 255).any()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _overlay_inputs(tmp_path, n=4, size=32):
    """An n-frame mp4 of ``size``^2 written with OpenCV and n RGBA PNGs."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(5)
    video = tmp_path / "src.mp4"
    w = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        (size, size))
    assert w.isOpened()
    for _ in range(n):
        w.write(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    w.release()
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    for i in range(n):
        rgba = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
        Image.fromarray(rgba, "RGBA").save(pngs / f"{i:04d}.png")
    return str(pngs), str(video)


def test_overlay_pngs_on_video_matches_jax(tmp_path):
    from dreamwaltz_g_tpu_torch.utils.media import load_image, read_video

    pngs, video = _overlay_inputs(tmp_path)
    outs = {}
    for name, fn in (("jax", JO.overlay_pngs_on_video),
                     ("torch", TO.overlay_pngs_on_video)):
        d = tmp_path / name
        d.mkdir()
        path = fn(pngs, video, str(d / "overlay.mp4"), fps=30)
        assert path == str(d / "overlay.mp4")
        frames = sorted((d / "overlay_frames").glob("*.png"))
        outs[name] = (np.stack([load_image(str(f)) for f in frames]),
                      read_video(path))
    (jp, jv), (tp, tv) = outs["jax"], outs["torch"]
    assert tp.shape == jp.shape == (4, 32, 32, 3)
    assert tv.shape == jv.shape == (4, 32, 32, 3)
    assert np.abs(tp - jp).max() * 255 <= 1.0 + 1e-4
    assert np.abs(tv - jv).max() * 255 <= 1.0 + 1e-4


def test_learnable_template_keys_match_jax():
    from dreamwaltz_g_tpu.human import glbs as JG
    from dreamwaltz_g_tpu_torch.human import glbs as TG
    from dreamwaltz_g_tpu_torch.human.smplx_model import SMPLXModelData

    assert TG.LEARNABLE_TEMPLATE_KEYS == JG.LEARNABLE_TEMPLATE_KEYS
    assert set(TG.LEARNABLE_TEMPLATE_KEYS) <= set(SMPLXModelData._fields)


@pytest.mark.parametrize("call", ["dmtet", "add_time_ids", "quat_identity"])
def test_card_defaults_refuse_without_cuda(call):
    from dreamwaltz_g_tpu_torch.guidance.sdxl import make_add_time_ids
    from dreamwaltz_g_tpu_torch.nerf.dmtet import DMTetModel

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults take it")

    fn = {"dmtet": lambda: DMTetModel.create(resolution=4),
          "add_time_ids": lambda: make_add_time_ids(1),
          "quat_identity": lambda: TT.quat_identity()}[call]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()

"""The port's image and video IO (``utils/media.py``) and overlay export
(``utils/overlay.py``) against the JAX package's, on the CPU.

Exact: ``to_uint8``; a PNG written by the port reads back (through the
port and the JAX reader) as its ``to_uint8`` / 255; ``load_image`` with a
resize; ``read_video`` of one mp4 through both packages; the overlay
compositing (numpy and OpenCV on both sides). The mp4 and gif writers are
held to their frame counts and sizes (mp4v is lossy), and a writer that
cannot be opened raises.
"""
import numpy as np
import pytest

from dreamwaltz_g_tpu.utils import media as JM
from dreamwaltz_g_tpu.utils import overlay as JO
from dreamwaltz_g_tpu_torch.utils import media as TM
from dreamwaltz_g_tpu_torch.utils import overlay as TO


def _img(shape, seed=0, lo=-0.2, hi=1.2):
    r = np.random.default_rng(seed)
    return (r.random(shape) * (hi - lo) + lo).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 1), (6, 5, 3), (6, 5, 4)])
def test_to_uint8_matches_jax(shape):
    x = _img(shape)
    np.testing.assert_array_equal(TM.to_uint8(x), JM.to_uint8(x))
    u = (_img(shape, lo=0, hi=1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(TM.to_uint8(u), JM.to_uint8(u))


def test_png_round_trip(tmp_path):
    x = _img((12, 10, 3), seed=1)
    path = TM.save_image(str(tmp_path / "a" / "0000.png"), x)
    want = TM.to_uint8(x).astype(np.float32) / 255.0
    np.testing.assert_array_equal(TM.load_image(path), want)
    np.testing.assert_array_equal(JM.load_image(path), want)
    np.testing.assert_array_equal(TM.load_image(path, size=(7, 5)),
                                  JM.load_image(path, size=(7, 5)))


def _frames(n, h=48, w=64, seed=2):
    """Smooth frames (a random color ramp, moving), which mp4v keeps close."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b = r.random((2, 3)).astype(np.float32)
    ramp = (a * xx[..., None] / w + b * yy[..., None] / h) / 2
    return [np.clip(0.2 + 0.6 * ramp + 0.03 * i, 0, 1) for i in range(n)]


def test_mp4_frames_and_sizes(tmp_path):
    path = TM.write_video(str(tmp_path / "v" / "clip.mp4"), _frames(7),
                          fps=30)
    got = TM.read_video(path)
    assert got.shape == (7, 48, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JM.read_video(path))
    np.testing.assert_array_equal(TM.read_video(path, max_frames=3),
                                  JM.read_video(path, max_frames=3))
    # mp4v is lossy: the frames come back close, not equal
    assert np.abs(got - np.stack(_frames(7))).mean() < 0.05


def test_gif_frames_and_sizes(tmp_path):
    from PIL import Image

    path = TM.write_gif(str(tmp_path / "g.gif"), _frames(4, 16, 20), fps=10)
    with Image.open(path) as im:
        assert im.size == (20, 16) and im.n_frames == 4


def test_writer_that_cannot_open_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        TM.write_video(str(tmp_path / "clip.xyz"), _frames(2))
    assert TM.read_video(str(tmp_path / "absent.mp4")).size == 0


@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("frame_shape", [(16, 20, 3), (32, 24, 3)])
def test_overlay_matches_jax(premultiplied, frame_shape):
    rgba = _img((24, 20, 4), seed=3, lo=0, hi=1)
    frame = (_img(frame_shape, seed=4, lo=0, hi=1) * 255).astype(np.uint8)
    got = TO.overlay_rgba_on_frame(rgba, frame, premultiplied)
    np.testing.assert_array_equal(
        got, JO.overlay_rgba_on_frame(rgba, frame, premultiplied))
    assert got.shape[:2] == (min(24, frame_shape[0]), 20)


def test_overlay_video_export(tmp_path):
    rgba = [_img((24, 32, 4), seed=i, lo=0, hi=1) for i in range(5)]
    video = _frames(4, 24, 32)
    out = TO.overlay_frames_on_video(rgba, video,
                                     str(tmp_path / "o" / "overlay.mp4"),
                                     save_images=True, premultiplied=True)
    assert TM.read_video(out).shape == (4, 24, 32, 3)
    pngs = sorted((tmp_path / "o" / "overlay_frames").glob("*.png"))
    assert len(pngs) == 4
    np.testing.assert_array_equal(
        TM.load_image(str(pngs[2])),
        TM.to_uint8(TO.overlay_rgba_on_frame(rgba[2], video[2], True))
        .astype(np.float32) / 255.0)

"""The port's CLIP R-Precision (``utils/r_precision.py``) against the JAX
package's, on the CPU, at tiny tower sizes.

The JAX towers' Flax parameters (``make_tiny_r_precision``'s random init)
are carried into the port (``convert.clip_vision_from_flax`` /
``clip_text_tower_from_flax``); both embed the same images and ids, made
from a seed with numpy. Tolerances: the unit-norm features within 1e-5 of
their largest entry (float32 towers of two layers), ``preprocess_images``
within 1e-5 (the antialiased bilinear resize of ``jax.image.resize``
against ``F.interpolate``), the retrieval scores equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu.utils import r_precision as J
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch.guidance.clip_text import (
    _bytes_to_unicode,
    tiny_text_config,
)
from dreamwaltz_g_tpu_torch.utils import r_precision as T

TOL = 1e-5


def _towers(seed=0):
    """The JAX tiny R-Precision and the port's, on the same weights."""
    jrp = J.make_tiny_r_precision(jax.random.PRNGKey(seed))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    vc = T.tiny_vision_config()
    vision = convert.clip_vision_from_flax(T.CLIPVisionModel(vc),
                                           to_np(jrp.vision_params))
    text = convert.clip_text_tower_from_flax(
        T.CLIPTextTower(tiny_text_config(), vc.projection_dim),
        to_np(jrp.text_params))
    return jrp, T.RPrecision(vision, text, device="cpu")


def _images(n, size, seed=1):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def _ids(n, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 200, size=(n, 16)).astype(np.int32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("size", [32, 48, 20])
def test_preprocess_images_matches_jax(size):
    """No resize, a shrink (antialiased) and an enlargement to 32^2."""
    x = _images(3, size)
    _close(T.preprocess_images(x, 32, device="cpu").numpy(),
           J.preprocess_images(x, 32))


@pytest.mark.parametrize("size", [32, 64])
def test_image_features_match_jax(size):
    jrp, rp = _towers()
    x = _images(4, size)
    _close(rp.image_features(x).numpy(), jrp.image_features(x))


def test_text_features_match_jax():
    jrp, rp = _towers()
    ids = _ids(5)
    _close(rp.text_features(ids).numpy(), jrp.text_features(ids))


@pytest.mark.parametrize("top_k", [1, 2])
def test_retrieve_matches_jax(top_k):
    jrp, rp = _towers(seed=3)
    x, ids = _images(6, 48, seed=4), _ids(6, seed=5)
    assert rp.retrieve(x, ids, top_k=top_k) \
        == jrp.retrieve(x, ids, top_k=top_k)


def test_retrieve_counts_own_prompt_hits():
    """Identical towers on features built to match: every image's own prompt
    ranks first when the image and text features are the same vectors."""
    _, rp = _towers()
    x, ids = _images(4, 32), _ids(4)
    feats = rp.text_features(ids)
    rp.image_features = lambda images: feats
    assert rp.retrieve(x, ids) == 1.0
    rp.image_features = lambda images: feats.roll(1, dims=0)
    assert rp.retrieve(x, ids) == 0.0


def _write_clip_dir(root, vision, text):
    """A transformers CLIP directory: one torch weights file with every
    tower's tensors (plus the two entries the towers do not hold) and a
    BPE vocabulary of the byte symbols."""
    sd = {**vision.state_dict(), **text.state_dict(),
          "logit_scale": torch.tensor(2.0),
          "text_model.embeddings.position_ids": torch.arange(16)[None]}
    root.mkdir()
    torch.save(sd, root / "pytorch_model.bin")
    symbols = list(_bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols] \
        + ["<|startoftext|>", "<|endoftext|>"]
    (root / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(vocab)}))
    (root / "merges.txt").write_text("#version: 0.2\n")


def test_load_r_precision_reads_a_transformers_directory(tmp_path,
                                                         monkeypatch):
    """At the default sizes (ViT-B/32, the 768-wide text tower): the loaded
    towers equal the written ones, prompts go through the BPE tokenizer,
    a directory without a weights file gives None, and a file that does
    not match the towers raises."""
    gen = torch.Generator().manual_seed(0)
    vision, text = T.CLIPVisionModel(), T.CLIPTextTower()
    vision.reset_parameters(gen)
    text.reset_parameters(gen)
    _write_clip_dir(tmp_path / "clip", vision, text)
    rp = T.load_r_precision(tmp_path / "clip", device="cpu")
    for a, b in ((rp.vision, vision), (rp.text, text)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    texts = ["a dancer", "a wizard in a robe"]
    ids = rp.tokenizer(texts)
    assert ids.shape == (2, 77)
    torch.testing.assert_close(rp.text_features(texts),
                               rp.text_features(ids), rtol=0, atol=0)
    assert T.load_r_precision(tmp_path / "absent", device="cpu") is None
    small = T.CLIPVisionModel(T.tiny_vision_config())
    _write_clip_dir(tmp_path / "bad", small, text)
    with pytest.raises((KeyError, ValueError)):
        T.load_r_precision(tmp_path / "bad", device="cpu")


def test_make_tiny_r_precision_scores_frames():
    rp = T.make_tiny_r_precision(torch.Generator().manual_seed(0),
                                 device="cpu")
    score = rp.retrieve(_images(3, 64), _ids(3))
    assert 0.0 <= score <= 1.0
    assert next(rp.vision.parameters()).device.type == "cpu"

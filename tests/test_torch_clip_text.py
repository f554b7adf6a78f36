"""The guidance's inputs in the port against the JAX package, on the CPU:
the CLIP text tower (``guidance/clip_text.py``, weights carried by
``convert.clip_text_from_flax``), its two tokenizers, and the loader of
released weights (``guidance/convert.py``).

Tolerances: the tower's outputs within 1e-5 of their largest entry, in all
three modes; token ids equal; loaded and merged weights equal to the bit
where they are copies and within 1e-6 where a LoRA product is added. The
tokenizer's vocabulary, the safetensors files and the state dicts are
written by the tests themselves (no released file is in the repo).
"""
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamwaltz_g_tpu import tests_support as jts
from dreamwaltz_g_tpu.guidance import clip_text as JCT
from dreamwaltz_g_tpu.guidance import convert as JCV
from dreamwaltz_g_tpu_torch import convert
from dreamwaltz_g_tpu_torch import tests_support as tts
from dreamwaltz_g_tpu_torch.guidance import clip_text as TCT
from dreamwaltz_g_tpu_torch.guidance import convert as TCV
from dreamwaltz_g_tpu_torch.guidance.unet import tiny_unet_config
from dreamwaltz_g_tpu_torch.guidance.vae import tiny_vae_config
import tests.torch_threads  # noqa: F401  (per-worker threads)

REL_TOL = 1e-5
PROMPTS = ["a photo of a person, dancing!", "Hello hello  world",
           "ninja's 3 swords", ""]
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("rl", "d</w>"), ("wo", "rld</w>"),
          ("p", "e"), ("pe", "r"), ("s", "o"), ("so", "n</w>")]


def _write_bpe(tmp_path):
    """A tiny CLIP BPE vocabulary: the 256 byte symbols, each with a word
    end, the merges' products, and the two special tokens."""
    symbols = list(JCT._bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols] \
        + ["".join(m) for m in MERGES] + ["<|startoftext|>",
                                          "<|endoftext|>"]
    vpath, mpath = tmp_path / "vocab.json", tmp_path / "merges.txt"
    assert len(set(vocab)) == len(vocab)
    vpath.write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    mpath.write_text("#version: 0.2\n" + "\n".join(" ".join(m)
                                                  for m in MERGES) + "\n")
    return str(vpath), str(mpath), len(vocab)


def _clip_pair(cfg):
    """The JAX tower's params and the port's tower carrying them."""
    jmodel = JCT.CLIPTextModel(JCT.CLIPTextConfig(*cfg))
    mode = "penultimate_pooled" if cfg.projection_dim else "final"
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, cfg.max_length), jnp.int32), mode=mode)
    tmodel = TCT.CLIPTextModel(cfg)
    convert.clip_text_from_flax(tmodel, jax.tree_util.tree_map(np.asarray,
                                                               params))
    return jmodel, params, tmodel


def _close(got, want):
    want = np.asarray(want)
    assert float(np.abs(got.detach().numpy() - want).max()) \
        <= REL_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("mode", ["final", "penultimate",
                                  "penultimate_pooled"])
@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
def test_clip_tower_matches_jax(mode, activation):
    """Every output mode (the pooled one through a text projection) and
    both activations, on hashed prompts padded with EOS: the causal -inf
    mask never empties a row, so no NaN."""
    cfg = TCT.tiny_text_config()._replace(activation=activation,
                                          projection_dim=12)
    jmodel, params, tmodel = _clip_pair(cfg)
    ids = JCT.HashTokenizer(cfg.vocab_size, cfg.max_length)(PROMPTS)
    want = jmodel.apply(params, jnp.asarray(ids), mode=mode)
    got = tmodel(torch.as_tensor(ids), mode=mode)
    if mode == "penultimate_pooled":
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)
        assert bool(torch.isfinite(got).all())


def test_hash_tokenizer_ids_equal():
    for vocab, length in ((49408, 77), (256, 16)):
        np.testing.assert_array_equal(
            TCT.HashTokenizer(vocab, length)(PROMPTS + ["x " * 100]),
            JCT.HashTokenizer(vocab, length)(PROMPTS + ["x " * 100]))


def test_clip_tokenizer_ids_equal(tmp_path):
    """BPE over a vocabulary the test writes, with a Textual-Inversion
    placeholder token added on both sides."""
    vpath, mpath, _ = _write_bpe(tmp_path)
    j = JCT.CLIPTokenizer(vpath, mpath, max_length=16)
    t = TCT.CLIPTokenizer(vpath, mpath, max_length=16)
    prompts = PROMPTS + ["hello &amp; <sks> person", "a " * 30]
    np.testing.assert_array_equal(t(prompts), j(prompts))
    assert t.add_token("<sks>") == j.add_token("<sks>")
    np.testing.assert_array_equal(t(prompts), j(prompts))
    with pytest.raises(ValueError):
        t.add_token("<sks>")


def _safetensors_bytes(entries):
    """A .safetensors file, byte by byte: {name: (dtype tag, shape, raw
    little-endian bytes)}."""
    header, blob = {"__metadata__": {"format": "pt"}}, b""
    for name, (tag, shape, raw) in entries.items():
        header[name] = {"dtype": tag, "shape": list(shape),
                        "data_offsets": [len(blob), len(blob) + len(raw)]}
        blob += raw
    head = json.dumps(header).encode()
    return struct.pack("<Q", len(head)) + head + blob


def _write_safetensors(path, sd):
    """A state dict of float32 / bf16 tensors to ``path``."""
    entries = {}
    for k, v in sd.items():
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            raw = v.view(torch.int16).numpy().astype("<i2").tobytes()
            entries[k] = ("BF16", v.shape, raw)
        else:
            entries[k] = ("F32", v.shape,
                          v.float().numpy().astype("<f4").tobytes())
    path.write_bytes(_safetensors_bytes(entries))


def test_safetensors_reader_reads_a_file_written_by_hand(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3)).astype("<f4")
    h = rng.normal(size=(5,)).astype("<f2")
    i = np.array([7, -3], "<i8")
    bf = torch.tensor([1.5, -2.25, 3e-3, 65280.0], dtype=torch.bfloat16)
    path = tmp_path / "w.safetensors"
    path.write_bytes(_safetensors_bytes({
        "a": ("F32", a.shape, a.tobytes()),
        "h": ("F16", h.shape, h.tobytes()),
        "i": ("I64", i.shape, i.tobytes()),
        "bf": ("BF16", bf.shape,
               bf.view(torch.int16).numpy().astype("<i2").tobytes())}))
    sd = TCV.read_safetensors(str(path))
    np.testing.assert_array_equal(sd["a"].numpy(), a)
    np.testing.assert_array_equal(sd["h"].numpy(), h)
    np.testing.assert_array_equal(sd["i"].numpy(), i)
    assert sd["bf"].dtype == torch.bfloat16 and torch.equal(sd["bf"], bf)
    assert "__metadata__" not in sd
    flat = TCV.load_torch_state_dict(str(path))
    assert flat["bf"].dtype == np.float32
    np.testing.assert_array_equal(flat["bf"], bf.float().numpy())
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(_safetensors_bytes({"x": ("F8_E4M3", (1,), b"\0")}))
    with pytest.raises(ValueError, match="F8_E4M3"):
        TCV.read_safetensors(str(bad))
    torch.save({"a": torch.tensor(a)}, tmp_path / "w.bin")
    np.testing.assert_array_equal(
        TCV.load_torch_state_dict(str(tmp_path / "w.bin"))["a"], a)


def _lora_sd(rng):
    """A kohya adapter on a Linear and a 1x1 conv, a diffusers-peft one on
    another Linear (no alpha), a 3x3 conv and a text-encoder entry that do
    not merge."""
    f32 = np.float32
    lin = "down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
    sd = {f"lora_unet_{lin}.lora_down.weight": rng.normal(size=(4, 32)),
          f"lora_unet_{lin}.lora_up.weight": rng.normal(size=(32, 4)),
          f"lora_unet_{lin}.alpha": np.array(2.0),
          "lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight":
              rng.normal(size=(2, 32, 1, 1)),
          "lora_unet_down_blocks_0_attentions_0_proj_in.lora_up.weight":
              rng.normal(size=(32, 2, 1, 1)),
          "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k"
          ".lora_A.weight": rng.normal(size=(3, 32)),
          "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k"
          ".lora_B.weight": rng.normal(size=(32, 3)),
          "lora_unet_conv_in.lora_down.weight": rng.normal(size=(2, 4, 3, 3)),
          "lora_unet_conv_in.lora_up.weight": rng.normal(size=(32, 2, 3, 3)),
          "lora_te_text_model_encoder_layers_0_mlp_fc1.lora_down.weight":
              rng.normal(size=(2, 8))}
    return {k: np.asarray(v, f32) for k, v in sd.items()}


def test_lora_merge_matches_jax():
    """``merge_lora_into_params`` on the port's UNet against the JAX merge
    into the Flax tree, from the same numpy adapter: the merged weights,
    the count and the leftovers."""
    _, jgp = jts.tiny_guidance(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jgp.unet)
    lora = _lora_sd(np.random.default_rng(1))
    jmerged, jn, jleft = JCV.merge_lora_into_params(jgp.unet, lora, 0.7)
    _, tgp = tts.tiny_guidance(0, device="cpu")
    convert.unet_from_flax(tgp.unet, tree)
    _, tn, tleft = TCV.merge_lora_into_params(tgp.unet, lora, 0.7)
    assert (tn, tleft) == (jn, jleft) and tn == 3
    want = convert.flax_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          jmerged))
    base = convert.flax_state_dict(tree)
    changed = 0
    for name, t in tgp.unet.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        changed += not torch.equal(t, base[name])
    assert changed == 3


def test_concept_merge_matches_jax(tmp_path):
    """A Textual-Inversion token: the same id from both tokenizers and the
    same appended row, from an .npz (both packages) and a torch file (the
    port)."""
    vpath, mpath, n_vocab = _write_bpe(tmp_path)
    cfg = TCT.tiny_text_config()._replace(vocab_size=n_vocab)
    jmodel, params, tmodel = _clip_pair(cfg)
    emb = np.random.default_rng(2).normal(size=(1, 32)).astype(np.float32)
    np.savez(tmp_path / "c.npz", **{"<sks>": emb})
    torch.save({"<sks>": torch.tensor(emb[0])}, tmp_path / "c.bin")
    jtok = JCT.CLIPTokenizer(vpath, mpath, max_length=16)
    jp, jtoken = JCV.merge_concept(params, jtok, str(tmp_path / "c.npz"))
    for name in ("c.npz", "c.bin"):
        ttok = TCT.CLIPTokenizer(vpath, mpath, max_length=16)
        _, _, t2 = _clip_pair(cfg)
        _, token = TCV.merge_concept(t2, ttok, str(tmp_path / name))
        assert token == jtoken == "<sks>"
        table = t2.text_model.embeddings.token_embedding.weight
        np.testing.assert_array_equal(
            table.detach().numpy(),
            np.asarray(jp["params"]["token_embedding"]["embedding"]))
        ids = ttok(["a <sks> person"])
        np.testing.assert_array_equal(ids, jtok(["a <sks> person"]))
        grown = JCT.CLIPTextModel(JCT.CLIPTextConfig(
            *cfg._replace(vocab_size=n_vocab + 1)))
        _close(t2(torch.as_tensor(ids)), grown.apply(jp, jnp.asarray(ids)))


def _write_model_dir(root, gp, clip, vpath, mpath):
    """A diffusers-format model directory of the port's modules: the UNet
    and ControlNet as safetensors (the UNet in bf16), the VAE as a torch
    file under diffusers' older attention names, the text tower under
    transformers' names with its ``position_ids`` buffer."""
    for sub in ("unet", "vae", "controlnet_pose", "text_encoder",
                "tokenizer"):
        (root / sub).mkdir(parents=True)
    _write_safetensors(root / "unet" / "diffusion_pytorch_model.safetensors",
                       {k: v.to(torch.bfloat16)
                        for k, v in gp.unet.state_dict().items()})
    _write_safetensors(
        root / "controlnet_pose" / "diffusion_pytorch_model.safetensors",
        gp.controlnet.state_dict())
    old = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
           ".to_out.0.": ".proj_attn."}
    vae = {}
    for k, v in gp.vae.state_dict().items():
        if ".attentions." in k:
            for new, was in old.items():
                k = k.replace(new, was)
        vae[k] = v
    torch.save(vae, root / "vae" / "diffusion_pytorch_model.bin")
    sd = dict(clip.state_dict())
    sd["text_model.embeddings.position_ids"] = torch.arange(
        clip.cfg.max_length)[None]
    _write_safetensors(root / "text_encoder" / "model.safetensors",
                       {k: v.float() for k, v in sd.items()})
    for src, name in ((vpath, "vocab.json"), (mpath, "merges.txt")):
        (root / "tokenizer" / name).write_text(open(src).read())


def test_load_guidance_round_trip(tmp_path):
    """``load_guidance`` over a diffusers-format directory written from the
    port's own tiny modules: every tensor back to the bit (the bf16 UNet's
    as bf16), the text embedding function equal to the tower on the
    tokenizer's ids, the LoRA and concept merges applied, and the unported
    cards refused."""
    vpath, mpath, n_vocab = _write_bpe(tmp_path)
    tcfg = TCT.tiny_text_config()._replace(vocab_size=n_vocab)
    _, gp = tts.tiny_guidance(3, with_controlnet=True, device="cpu")
    clip = TCT.CLIPTextModel(tcfg)
    clip.reset_parameters(torch.Generator().manual_seed(4))
    root = tmp_path / "model"
    _write_model_dir(root, gp, clip, vpath, mpath)
    configs = dict(unet=tiny_unet_config(), vae=tiny_vae_config(), text=tcfg,
                   cond_block_channels=(16, 32), latent_size=8)
    sd, lgp, embed = TCV.load_guidance(str(root), configs=configs,
                                       device="cpu", guidance_scale=7.5)
    assert sd.latent_size == 8 and sd.guidance_scale == 7.5
    for name in ("vae", "controlnet"):
        got, want = getattr(lgp, name).state_dict(), \
            getattr(gp, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    for k, v in gp.unet.state_dict().items():
        assert torch.equal(lgp.unet.state_dict()[k],
                           v.to(torch.bfloat16).float()), k
    tok = TCT.CLIPTokenizer(vpath, mpath, max_length=tcfg.max_length)
    texts = ["hello world", "a person"]
    assert torch.equal(embed(texts), clip(torch.as_tensor(tok(texts))))

    lora = _lora_sd(np.random.default_rng(5))
    np.savez(tmp_path / "c.npz", **{"<sks>": np.ones((1, 32), np.float32)})
    (root / "lora").mkdir()
    torch.save({k: torch.as_tensor(v) for k, v in lora.items()},
               root / "lora" / "style.bin")
    _, lgp2, embed2 = TCV.load_guidance(
        str(root), configs=configs, device="cpu", lora_name="style.bin",
        lora_scale=0.5, concept_name=str(tmp_path / "c.npz"),
        use_controlnet=False)
    assert lgp2.controlnet is None
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert not torch.equal(lgp2.unet.state_dict()[key],
                           lgp.unet.state_dict()[key])
    assert embed2(["a <sks>"]).shape == (1, tcfg.max_length, 32)
    with pytest.raises(NotImplementedError, match="sd21"):
        TCV.load_guidance(str(root), model="sd21", device="cpu")
    with pytest.raises(KeyError):
        TCV.load_guidance(str(root), model="sdxx", device="cpu")

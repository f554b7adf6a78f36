"""CLIP text encoder (the ViT-L/14 text tower) and its tokenizers.

Port of ``dreamwaltz_g_tpu/guidance/clip_text.py``. Module and parameter
names are transformers' own below ``text_model.`` (``embeddings.
token_embedding``, ``encoder.layers.0.self_attn.q_proj``, ``mlp.fc1``,
``final_layer_norm``), so a released ``text_encoder`` state dict loads by
name (``guidance/convert.py``). The tower runs in float32; callers cast its
output to the guidance's type.

The attention is a 77-token einsum under a causal ``-inf`` mask: no TPU
kernel computes it in the JAX package, so it stays plain torch here. Every
row keeps its diagonal, so padding never masks a whole row.

``CLIPTokenizer`` (BPE over ``vocab.json`` / ``merges.txt``) and
``HashTokenizer`` (zlib ids, for random-weight models) are pure Python and
give the JAX package's ids. ``clip_h_config`` is SD2.x's tower (OpenCLIP
ViT-H, 23 layers, gelu), ``clip_bigg_config`` SDXL's second (OpenCLIP
ViT-bigG, 32 layers, a 1280-wide projection of the pooled output).
"""
from __future__ import annotations

import gzip
import html
import json
import re
import zlib
from functools import lru_cache
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class CLIPTextConfig(NamedTuple):
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    # SD1.5's CLIP uses quick_gelu
    activation: str = "quick_gelu"
    # > 0: a text_projection head on the pooled output (SDXL's second tower)
    projection_dim: int = 0


def tiny_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=256, hidden_size=32, num_layers=2,
                          num_heads=2, max_length=16)


def clip_h_config() -> CLIPTextConfig:
    """OpenCLIP ViT-H text tower, SD2.x's text encoder (1024 wide, the 23
    layers diffusers ships, gelu)."""
    return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                          activation="gelu")


def clip_bigg_config() -> CLIPTextConfig:
    """OpenCLIP ViT-bigG text tower, SDXL's ``text_encoder_2`` (gelu, a
    1280-wide projection)."""
    return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                          activation="gelu", projection_dim=1280)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, mask):
        B, N, D = x.shape
        hd = D // self.num_heads
        q = (self.q_proj(x) * hd ** -0.5).reshape(B, N, self.num_heads, hd)
        k = self.k_proj(x).reshape(B, N, self.num_heads, hd)
        v = self.v_proj(x).reshape(B, N, self.num_heads, hd)
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) + mask
        a = torch.softmax(a, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, N, D)
        return self.out_proj(o)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.hidden_size * 4)
        self.fc2 = nn.Linear(cfg.hidden_size * 4, cfg.hidden_size)
        self.quick = cfg.activation == "quick_gelu"

    def forward(self, x):
        h = self.fc1(x)
        # Flax's nn.gelu is the tanh approximation
        h = _quick_gelu(h) if self.quick else F.gelu(h, approximate="tanh")
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg)
                                    for _ in range(cfg.num_layers))


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """(B, L) token ids -> hidden states; transformers' layout."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        if cfg.projection_dim:
            self.text_projection = nn.Linear(
                cfg.hidden_size, cfg.projection_dim, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: Linear weights N(0, 1/fan_in),
        biases 0, norm scales 1, embeddings N(0, 0.02^2) (tokens) and
        N(0, 0.01^2) (positions, the JAX package's initialiser)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    w = m.weight
                    w.copy_(torch.randn(w.shape, generator=generator,
                                        device=w.device, dtype=w.dtype)
                            * w.shape[1] ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            emb = self.text_model.embeddings
            for table, std in ((emb.token_embedding.weight, 0.02),
                               (emb.position_embedding.weight, 0.01)):
                table.copy_(torch.randn(table.shape, generator=generator,
                                        device=table.device,
                                        dtype=table.dtype) * std)

    def forward(self, input_ids: torch.Tensor, mode: str = "final"):
        """mode 'final': (B, L, D) final-LN hidden states (SD1.5's
        context); 'penultimate': (B, L, D) the second-to-last layer's
        output; 'penultimate_pooled': (penultimate, pooled (B, Dp)), the
        final-LN feature at the EOS token (the argmax id), through
        ``text_projection`` when the config has one."""
        tm = self.text_model
        B, L = input_ids.shape
        ids = input_ids.long()
        x = tm.embeddings.token_embedding(ids) \
            + tm.embeddings.position_embedding.weight[None, :L]
        mask = torch.full((L, L), float("-inf"), device=x.device,
                          dtype=x.dtype).triu(1)[None, None]
        n = len(tm.encoder.layers)
        penult = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == n - 1:
                penult = x
            x = layer(x, mask)
        out = tm.final_layer_norm(x)
        if mode == "final":
            return out
        if mode == "penultimate":
            return penult
        if mode == "penultimate_pooled":
            eos = torch.argmax(ids, dim=-1)
            pooled = out[torch.arange(B, device=out.device), eos]
            if self.cfg.projection_dim:
                pooled = self.text_projection(pooled)
            return penult, pooled
        raise ValueError(f"unknown CLIP output mode {mode!r}")


# ---------------------------------------------------------------------------
# Tokenizers (pure Python, the JAX package's ids)
# ---------------------------------------------------------------------------

@lru_cache()
def _bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """Byte-pair-encoding tokenizer, CLIP flavour (lowercase, ``</w>`` word
    ends), over the standard ``vocab.json`` + ``merges.txt`` (or the
    gzipped ``bpe_simple_vocab_16e6.txt.gz``)."""

    def __init__(self, vocab_path: str, merges_path: Optional[str] = None,
                 max_length: int = 77):
        self.max_length = max_length
        self.byte_encoder = _bytes_to_unicode()
        if vocab_path.endswith(".gz"):
            with gzip.open(vocab_path) as f:
                merges = f.read().decode("utf-8").split("\n")
            merges = merges[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = [tuple(m.split()) for m in merges[1:]
                      if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        # the id after the terminating EOS: SD1.x pads with EOS (the loader
        # sets it per model family)
        self.pad_id = self.eos
        # Textual-Inversion placeholder tokens, matched verbatim before BPE
        self.added: dict = {}

    def add_token(self, token: str) -> int:
        """Register a placeholder token; returns its id, the row to append
        to the text tower's embedding table."""
        token = token.strip().lower()
        if token in self.added or token in self.encoder:
            raise ValueError(f"token {token!r} already in the tokenizer")
        idx = len(self.encoder) + len(self.added)
        self.added[token] = idx
        return idx

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        if self.added:
            pat = "(" + "|".join(re.escape(t) for t in self.added) + ")"
            ids = []
            for seg in re.split(pat, text):
                if seg in self.added:
                    ids.append(self.added[seg])
                elif seg:
                    ids.extend(self._encode_bpe(seg))
            return ids
        return self._encode_bpe(text)

    def _encode_bpe(self, text: str) -> List[int]:
        ids = []
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: self.max_length - 2] \
                + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic offline fallback: stable per-word hash ids (for
    random-weight models, not real checkpoints)."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos = 49406 % vocab_size, 49407 % vocab_size

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, t in enumerate(texts):
            words = re.findall(r"\w+|[^\s\w]", t.lower())
            ids = [self.bos] + [
                (zlib.crc32(w.encode()) % (self.vocab_size - 3)) + 1
                for w in words[: self.max_length - 2]
            ] + [self.eos]
            out[i, : len(ids)] = ids
        return out

"""Load released diffusers / transformers weights into the port's guidance.

Port of the loading half of ``dreamwaltz_g_tpu/guidance/convert.py``. The
port's modules carry diffusers' and transformers' own names
(``guidance/layers.py``, ``guidance/clip_text.py``), so a released state
dict loads by name, with no renaming: the JAX package's ``_torch_name``
rename of the ControlNet's keys is not copied.

* ``load_torch_state_dict``: ``.bin`` / ``.pt`` through ``torch.load``;
  ``.safetensors`` through ``read_safetensors``, a reader of the format's
  own (an 8-byte little-endian header length, a JSON header, raw
  little-endian data; bf16 read through ``uint16``), so no package is
  needed for it.
* ``merge_lora_into_params``: ``W += scale (alpha / r) up @ down`` into the
  Linear and 1x1 Conv2d weights that a kohya or diffusers-peft adapter
  names.
* ``load_concept_embedding`` / ``merge_concept``: a Textual-Inversion token
  appended to the tokenizer and to the text tower's embedding table.
* ``load_guidance``: a diffusers-format model directory (``unet/``,
  ``vae/``, ``text_encoder/``, ``tokenizer/``, ``controlnet_pose/`` or
  ``controlnet/``) -> (ScoreDistillation, GuidanceParams, text_embed_fn),
  for every card of ``MODEL_FAMILIES``: SD1.x, the HumanNorm finetunes
  (SD1.5's architecture), SD2.x (the ViT-H tower, its tokenizer padding
  with "!", id 0; the 768-v cards with v-prediction and 96^2 latents).
* ``load_guidance_xl``: a diffusers SDXL directory (``unet/``, ``vae/``,
  ``text_encoder/`` CLIP-L, ``text_encoder_2/`` bigG with its projection,
  ``tokenizer/``, and a ``controlnet_*/`` ControlNet on the XL config) ->
  (ScoreDistillationXL, GuidanceParams, text_embed_fn), where
  ``text_embed_fn(texts)`` -> (embeds (N, 77, 2048), pooled (N, 1280)): the
  two towers' penultimate states side by side and tower 2's projected
  pooled output. Both towers take ``tokenizer/``'s ids (``tokenizer_2/``
  is not read), as the JAX loader tokenizes both with its one
  tokenizer.
"""
from __future__ import annotations

import json
import logging
import os.path as osp
import struct
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device

logger = logging.getLogger(__name__)

_SAFETENSORS_TYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} from a ``.safetensors`` file. bf16 entries come
    back as ``torch.bfloat16``; a type the reader does not know raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
    # mapped, not read: each tensor below copies only its own bytes
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _SAFETENSORS_TYPES:
            raise ValueError(f"{path}: {name} has type {dtype}, which the "
                             "reader does not take")
        lo, hi = info["data_offsets"]
        np_type = np.dtype(_SAFETENSORS_TYPES[dtype])
        a = np.frombuffer(data, dtype=np_type.newbyteorder("<"),
                          count=(hi - lo) // np_type.itemsize,
                          offset=lo).reshape(info["shape"])
        a = a.astype(np_type, copy=True)      # native byte order, writable
        if dtype == "BF16":                   # the bits, as int16
            out[name] = torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a)
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A flat torch or safetensors state dict as numpy (float32 for bf16
    entries, which numpy has no type for)."""
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(str(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in sd.items()}


def _normalize_lora_sd(lora_sd: Dict[str, np.ndarray]):
    """LoRA state dict -> ({kohya_module_name: (down, up, alpha)}, skipped).

    Takes kohya-ss names (``lora_unet_<mod>.lora_down/lora_up.weight`` +
    ``.alpha``) and diffusers-peft names (``unet.<mod.with.dots>.lora_A/
    lora_B.weight``). Text-encoder entries and other towers are skipped
    and returned so that callers can report them."""
    mods: Dict[str, dict] = {}
    skipped = []
    for k, v in lora_sd.items():
        name = None
        slot = None
        if k.startswith("lora_unet_"):
            body = k[len("lora_unet_"):]
            if body.endswith(".lora_down.weight"):
                name, slot = body[:-len(".lora_down.weight")], "down"
            elif body.endswith(".lora_up.weight"):
                name, slot = body[:-len(".lora_up.weight")], "up"
            elif body.endswith(".alpha"):
                name, slot = body[:-len(".alpha")], "alpha"
        elif k.startswith("unet."):
            body = k[len("unet."):]
            for suf, sl in ((".lora_A.weight", "down"),
                            (".lora_B.weight", "up"),
                            (".lora_A.default.weight", "down"),
                            (".lora_B.default.weight", "up"),
                            (".lora.down.weight", "down"),
                            (".lora.up.weight", "up"),
                            (".alpha", "alpha")):
                if body.endswith(suf):
                    name = body[:-len(suf)].replace(".", "_")
                    # old diffusers attn-processor naming
                    name = name.replace("_processor", "")
                    name = name.replace("to_q_lora", "to_q") \
                        .replace("to_k_lora", "to_k") \
                        .replace("to_v_lora", "to_v") \
                        .replace("to_out_lora", "to_out_0")
                    slot = sl
                    break
        if name is None:
            skipped.append(k)
            continue
        mods.setdefault(name, {})[slot] = np.asarray(v, np.float32)
    out = {}
    n_alpha_defaulted = 0
    for name, d in mods.items():
        if "down" not in d or "up" not in d:
            skipped.append(name)
            continue
        down, up = d["down"], d["up"]
        # kohya conv LoRAs carry 4D (r, in, kh, kw); only 1x1 is a plain
        # matmul that merges into a 1x1 conv
        if down.ndim == 4:
            if down.shape[2:] != (1, 1) or up.shape[2:] != (1, 1):
                skipped.append(name)
                continue
            down, up = down[:, :, 0, 0], up[:, :, 0, 0]
        r = down.shape[0]
        if "alpha" not in d:
            n_alpha_defaulted += 1
        alpha = float(d.get("alpha", r))
        out[name] = (down, up, alpha)
    if n_alpha_defaulted:
        # peft / diffusers files carry no .alpha (lora_alpha lives in the
        # adapter's config): alpha = r, factor 1.0, is the common default
        logger.warning(
            "LoRA: %d modules carry no alpha entry; defaulting alpha = r "
            "(factor 1.0). If the adapter's config says lora_alpha != r, "
            "set lora_scale = lora_alpha / r.", n_alpha_defaulted)
    return out, skipped


@torch.no_grad()
def merge_lora_into_params(module: nn.Module, lora_sd: Dict[str, np.ndarray],
                           scale: float = 1.0):
    """Merge a LoRA adapter into ``module``'s weights in place:
    ``W += scale (alpha / r) up @ down`` for every Linear and 1x1 Conv2d
    whose module path, dots turned to underscores, the adapter names (the
    kohya name). Returns ``(module, n_merged, unmatched_module_names)``."""
    mods, skipped = _normalize_lora_sd(lora_sd)
    n_merged = 0
    matched = set()
    for path, m in module.named_modules():
        name = path.replace(".", "_")
        if name not in mods or not isinstance(m, (nn.Linear, nn.Conv2d)):
            continue
        down, up, alpha = mods[name]
        delta = torch.as_tensor((up @ down) * (alpha / down.shape[0]) * scale)
        w = m.weight
        if w.ndim == 4 and tuple(w.shape[2:]) != (1, 1):
            skipped.append(name)
            continue
        if w.ndim == 4:
            delta = delta[:, :, None, None]
        w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
        matched.add(name)
        n_merged += 1
    leftover = sorted((set(mods) - matched) | set(skipped))
    return module, n_merged, leftover


def load_concept_embedding(path: str):
    """A Textual-Inversion concept file -> (token, (D,) float32 numpy):
    a torch ``learned_embeds.bin`` ({token: (D,) tensor}), a safetensors
    file, or an ``.npz`` with one named array."""
    if path.endswith(".safetensors"):
        d = {k: v.float().numpy() for k, v in read_safetensors(path).items()}
    elif path.endswith(".npz"):
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
    else:
        d = {k: v.detach().float().cpu().numpy() for k, v in torch.load(
            path, map_location="cpu", weights_only=True).items()}
    token = next(iter(d))
    emb = np.asarray(d[token], np.float32)
    if emb.ndim == 2:
        if emb.shape[0] != 1:
            raise ValueError(
                f"multi-vector concepts ({emb.shape[0]} vectors) are not "
                "supported: the reference's sd-concepts are single-vector")
        emb = emb[0]
    return token, emb


@torch.no_grad()
def merge_concept(clip_module: nn.Module, tokenizer, path: str):
    """Register the concept's token with ``tokenizer`` and append its
    embedding row to the text tower's token table (a new ``nn.Embedding``
    one row longer). Returns (clip_module, token)."""
    token, emb = load_concept_embedding(path)
    tok_id = tokenizer.add_token(token)
    emb_mod = clip_module.text_model.embeddings
    table = emb_mod.token_embedding.weight
    if tok_id != table.shape[0]:
        raise ValueError(
            f"concept token id {tok_id} != table size {table.shape[0]}")
    if emb.shape[0] != table.shape[1]:
        raise ValueError(
            f"concept dim {emb.shape[0]} != text width {table.shape[1]}")
    new = nn.Embedding(table.shape[0] + 1, table.shape[1],
                       device=table.device, dtype=table.dtype)
    new.weight.copy_(torch.cat(
        [table, torch.as_tensor(emb, dtype=table.dtype,
                                device=table.device)[None]]))
    new.weight.requires_grad_(table.requires_grad)
    emb_mod.token_embedding = new
    return clip_module, token


# ---------------------------------------------------------------------------
# A diffusers-format model directory
# ---------------------------------------------------------------------------

# model cards (the JAX package's MODEL_FAMILIES): (UNet architecture, text
# tower, latent grid, prediction type)
MODEL_FAMILIES = {
    "sd14": dict(arch="sd15", text="clip_l", latent=64, pred="epsilon"),
    "sd15": dict(arch="sd15", text="clip_l", latent=64, pred="epsilon"),
    "normal-adapted": dict(arch="sd15", text="clip_l", latent=64,
                           pred="epsilon"),
    "depth-adapted": dict(arch="sd15", text="clip_l", latent=64,
                          pred="epsilon"),
    "sd20b": dict(arch="sd21", text="clip_h", latent=64, pred="epsilon"),
    "sd21b": dict(arch="sd21", text="clip_h", latent=64, pred="epsilon"),
    "sd20": dict(arch="sd21", text="clip_h", latent=96, pred="v_prediction"),
    "sd21": dict(arch="sd21", text="clip_h", latent=96, pred="v_prediction"),
}


def _family(model: str) -> dict:
    fam = MODEL_FAMILIES.get(model)
    if fam is None:
        raise KeyError(f"unknown model card {model!r}; known: "
                       f"{sorted(MODEL_FAMILIES)} + sdxl10 "
                       "(load_guidance_xl)")
    return fam


def _weights_file(directory: str) -> str:
    """The one weights file of a diffusers / transformers component folder:
    safetensors first, then a torch pickle."""
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin"):
        p = osp.join(directory, name)
        if osp.isfile(p):
            return p
    raise FileNotFoundError(f"no weights file under {directory}")


# diffusers' older names for the VAE mid block's attention
_OLD_VAE_ATTN = {"query.": "to_q.", "key.": "to_k.", "value.": "to_v.",
                 "proj_attn.": "to_out.0."}


@torch.no_grad()
def load_state_dict_into(module: nn.Module, sd: Dict[str, np.ndarray],
                         prefix: str = "") -> nn.Module:
    """Copy a released state dict into ``module`` by name (``prefix`` is
    stripped from the file's keys first). Every module tensor must be
    covered and every file entry used, but for the ``position_ids`` buffer
    older transformers files carry; 1x1 conv kernels load into a Linear of
    the same matrix."""
    own = module.state_dict()
    state = {}
    for k, v in sd.items():
        if not k.startswith(prefix) or k.endswith("position_ids"):
            continue
        name = k[len(prefix):]
        if name not in own and ".attentions." in name:
            for old, new in _OLD_VAE_ATTN.items():
                name = name.replace(f".{old}", f".{new}")
        state[name] = v
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"weights do not match the module: missing "
                       f"{missing[:5]} ({len(missing)}), unused {unused[:5]} "
                       f"({len(unused)})")
    for name, t in own.items():
        v = torch.as_tensor(np.asarray(state[name]))
        if v.ndim == 4 and t.ndim == 2 and tuple(v.shape[2:]) == (1, 1):
            v = v[:, :, 0, 0]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: file {tuple(v.shape)} vs module "
                             f"{tuple(t.shape)}")
        t.copy_(v.to(t.dtype))
    return module


def load_guidance(
    weights_dir: str,
    use_controlnet: bool = True,
    loss_type: str = "sds",
    weight_type: str = "sjc",
    guidance_scale: float = 50.0,
    controlnet_scale: float = 1.0,
    guidance_rescale: float = 0.0,
    denoise_timesteps: int = 50,
    model: str = "sd15",
    lora_name: Optional[str] = None,
    lora_scale: float = 1.0,
    concept_name: Optional[str] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    configs: Optional[dict] = None,
):
    """The SD guidance stack from a diffusers-format model directory:
    ``unet/``, ``vae/``, ``text_encoder/`` and ``tokenizer/`` (``vocab.json``,
    ``merges.txt``), and, when ``use_controlnet``, ``controlnet_pose/`` or
    ``controlnet/`` (none there: no ControlNet). ``lora_name`` (a file, or a
    name under ``lora/``) is merged into the UNet, ``concept_name`` (a file,
    or ``concepts/<name>/learned_embeds.bin``) into the text tower.
    ``configs`` replaces the card's model configs (keys ``unet``, ``vae``,
    ``text``, ``cond_block_channels``, ``latent_size``), for small models.

    The UNet, ControlNet and VAE are built frozen in ``dtype`` on
    ``device``; the text tower in float32. Returns (ScoreDistillation,
    GuidanceParams, text_embed_fn), where ``text_embed_fn(list[str])`` ->
    (N, 77, D) float32 runs the frozen tower. ``denoise_timesteps`` is the
    z0 / x0 modes' grid."""
    from .clip_text import CLIPTextConfig, clip_h_config
    from .sds import GuidanceParams, ScoreDistillation
    from .time_prior import make_schedule
    from .unet import sd15_unet_config, sd21_unet_config
    from .vae import sd_vae_config

    device = resolve_device(device)
    fam = _family(model)
    cfgs = dict(unet=sd21_unet_config() if fam["arch"] == "sd21"
                else sd15_unet_config(), vae=sd_vae_config(),
                text=clip_h_config() if fam["text"] == "clip_h"
                else CLIPTextConfig(),
                cond_block_channels=(16, 32, 96, 256),
                latent_size=fam["latent"])
    cfgs.update(configs or {})
    unet, vae, cn = _load_models(
        weights_dir, cfgs, ("controlnet_pose", "controlnet"),
        use_controlnet, lora_name, lora_scale, device, dtype)
    clip = _load_tower(weights_dir, "text_encoder", cfgs["text"], device)
    tokenizer = _tokenizer(weights_dir, cfgs["text"])
    if fam["text"] == "clip_h":
        # SD2.x pads with "!" (id 0), not EOS, as the card's tokenizer
        # config sets pad_token
        tokenizer.pad_id = 0
    if concept_name:
        cpath = concept_name
        if not osp.isfile(cpath):
            cpath = osp.join(weights_dir, "concepts", concept_name,
                             "learned_embeds.bin")
        clip, token = merge_concept(clip, tokenizer, cpath)
        logger.info("merged Textual-Inversion concept %s (token %r) into "
                    "the text tower", concept_name, token)

    @torch.no_grad()
    def text_embed_fn(texts):
        ids = torch.as_tensor(tokenizer(list(texts)), device=device)
        return clip(ids)

    sd = ScoreDistillation(
        schedule=make_schedule(device=device), loss_type=loss_type,
        weight_type=weight_type, guidance_scale=guidance_scale,
        controlnet_scale=controlnet_scale, guidance_rescale=guidance_rescale,
        denoise_timesteps=denoise_timesteps,
        latent_size=cfgs["latent_size"], prediction_type=fam["pred"])
    return sd, GuidanceParams(unet=unet, vae=vae, controlnet=cn), \
        text_embed_fn


def _component(weights_dir: str, name: str) -> Dict[str, np.ndarray]:
    return load_torch_state_dict(_weights_file(osp.join(weights_dir, name)))


def _load_models(weights_dir, cfgs, controlnets, use_controlnet, lora_name,
                 lora_scale, device, dtype):
    """The UNet (with the LoRA merged), the VAE and, when
    ``use_controlnet``, the first of the ``controlnets`` folders there,
    frozen in ``dtype`` on ``device``."""
    from .controlnet import ControlNet
    from .layers import build
    from .unet import UNet2DCondition
    from .vae import AutoencoderKL

    unet = build(lambda: UNet2DCondition(cfgs["unet"]), device, dtype)
    load_state_dict_into(unet, _component(weights_dir, "unet"))
    if lora_name:
        lpath = lora_name if osp.isfile(lora_name) else \
            osp.join(weights_dir, "lora", lora_name)
        _, n_merged, leftover = merge_lora_into_params(
            unet, load_torch_state_dict(lpath), scale=lora_scale)
        logger.info("merged LoRA %s into the UNet: %d layers (%d entries "
                    "not mergeable)", lora_name, n_merged, len(leftover))
    vae = build(lambda: AutoencoderKL(cfgs["vae"]), device, dtype)
    load_state_dict_into(vae, _component(weights_dir, "vae"))
    cn = None
    if use_controlnet:
        for cand in controlnets:
            if osp.isdir(osp.join(weights_dir, cand)):
                cn = build(lambda: ControlNet(cfgs["unet"],
                                              cfgs["cond_block_channels"]),
                           device, dtype)
                load_state_dict_into(cn, _component(weights_dir, cand))
                break
    return unet, vae, cn


def _load_tower(weights_dir, name, cfg, device):
    from .clip_text import CLIPTextModel
    from .layers import build

    clip = build(lambda: CLIPTextModel(cfg), device, torch.float32)
    return load_state_dict_into(clip, _component(weights_dir, name))


def _tokenizer(weights_dir, cfg):
    from .clip_text import CLIPTokenizer

    tok_dir = osp.join(weights_dir, "tokenizer")
    return CLIPTokenizer(osp.join(tok_dir, "vocab.json"),
                         osp.join(tok_dir, "merges.txt"),
                         max_length=cfg.max_length)


def load_guidance_xl(
    weights_dir: str,
    loss_type: str = "sds",
    weight_type: str = "sjc",
    guidance_scale: float = 50.0,
    guidance_rescale: float = 0.0,
    denoise_timesteps: int = 50,
    use_controlnet: bool = False,
    controlnet_scale: float = 1.0,
    guess_mode: bool = False,
    lora_name: Optional[str] = None,
    lora_scale: float = 1.0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    configs: Optional[dict] = None,
):
    """The SDXL guidance stack from a diffusers SDXL directory (module
    docstring). The ControlNet, when ``use_controlnet``, is the first
    ``controlnet_*/`` folder in sorted order (the JAX loader's first
    ``controlnet_*_xl`` file), built on the XL UNet config. ``configs``
    replaces the model configs (keys ``unet``, ``vae``, ``text``,
    ``text_2``, ``cond_block_channels``, ``latent_size``), for small
    models. Returns (ScoreDistillationXL, GuidanceParams, text_embed_fn);
    the caller sets the guidance's ``pooled_text`` / ``pooled_uncond``."""
    import glob

    from .clip_text import CLIPTextConfig, clip_bigg_config
    from .sds import GuidanceParams
    from .sdxl import ScoreDistillationXL, xl_text_embed_fn
    from .time_prior import make_schedule
    from .unet import sdxl_unet_config
    from .vae import sd_vae_config

    device = resolve_device(device)
    cfgs = dict(unet=sdxl_unet_config(), vae=sd_vae_config(),
                text=CLIPTextConfig(), text_2=clip_bigg_config(),
                cond_block_channels=(16, 32, 96, 256), latent_size=128)
    cfgs.update(configs or {})
    controlnets = [osp.basename(p) for p in sorted(
        glob.glob(osp.join(weights_dir, "controlnet_*"))) if osp.isdir(p)]
    unet, vae, cn = _load_models(weights_dir, cfgs, controlnets,
                                 use_controlnet, lora_name, lora_scale,
                                 device, dtype)
    clip1 = _load_tower(weights_dir, "text_encoder", cfgs["text"], device)
    clip2 = _load_tower(weights_dir, "text_encoder_2", cfgs["text_2"],
                        device)
    text_embed_fn = xl_text_embed_fn(_tokenizer(weights_dir, cfgs["text"]),
                                     clip1, clip2, device)
    sd = ScoreDistillationXL(
        schedule=make_schedule(device=device), loss_type=loss_type,
        weight_type=weight_type, guidance_scale=guidance_scale,
        guidance_rescale=guidance_rescale,
        denoise_timesteps=denoise_timesteps,
        latent_size=cfgs["latent_size"], controlnet_scale=controlnet_scale,
        guess_mode=guess_mode)
    return sd, GuidanceParams(unet=unet, vae=vae, controlnet=cn), \
        text_embed_fn

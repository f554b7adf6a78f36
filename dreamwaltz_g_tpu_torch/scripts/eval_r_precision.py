"""Standalone CLIP R-Precision over a set of rendered avatars.

The paper's quantitative protocol: N avatars rendered from their runs and
their N prompts, both embedded with CLIP; the score is the share of renders
whose own prompt ranks first (top-1) or in the first five (top-5) among all
N. The twin of the JAX package's ``scripts/eval_r_precision.py``, on the
port's ``utils/r_precision.py``.

Usage:
    python -m dreamwaltz_g_tpu_torch.scripts.eval_r_precision \\
        --renders DIR --prompts FILE [--weights DIR] [--tiny] [--device cpu]

``--renders``: a directory of images; each file's stem names a line of the
prompt file by its index (``000.png`` or ``0.png`` is line 0) or by the
prompt's exp-name slug (``<slug>.png``). ``--prompts``: a text file, one
prompt per line. ``--weights``: a transformers CLIP directory, as
``utils/r_precision.py:load_r_precision`` reads it (one weights file,
``vocab.json``, ``merges.txt``; the trainer's ``clip_retrieval/``).
``--tiny`` runs random tiny towers instead: a smoke of the pipeline, not a
meaningful score. ``--device``: ``cuda`` (the default) or ``cpu``.
Prints one JSON line: ``metric``, ``n``, ``top1``, ``top5``,
``tiny_towers``.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np


def slugify(text: str) -> str:
    """Prompt -> exp-name slug (as ``main.py``'s '@' substitution)."""
    return re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")


def load_images(renders_dir, prompts):
    """The renders that name a prompt, as (H, W, 3) float32 in [0, 1], and
    the indices of their prompts."""
    from PIL import Image

    files = sorted(p for p in Path(renders_dir).iterdir()
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    by_stem = {p.stem: p for p in files}
    images, kept = [], []
    for i, prompt in enumerate(prompts):
        cand = by_stem.get(f"{i:03d}") or by_stem.get(str(i)) \
            or by_stem.get(slugify(prompt))
        if cand is None:
            continue
        images.append(np.asarray(Image.open(cand).convert("RGB"),
                                 np.float32) / 255.0)
        kept.append(i)
    return images, kept


def score(rp, images, texts) -> dict:
    """R-Precision of ``images`` (a list of (H, W, 3) float arrays) against
    ``texts`` (prompts, or (N, L) token ids), pair i matching. Every image
    is first resized to the tallest one's square, as
    ``jax.image.resize(..., 'bilinear')`` resizes (antialiased when it
    shrinks). Returns ``sims`` (N, N) numpy, image i against text j, and
    ``top1`` / ``top5``."""
    import torch

    from ..guidance.sds import resize_images

    size = max(im.shape[0] for im in images)
    stack = torch.cat([resize_images(
        torch.as_tensor(im, dtype=torch.float32, device=rp.device)[None],
        size, size) for im in images])
    sims = (rp.image_features(stack) @ rp.text_features(texts).T) \
        .cpu().numpy()
    order = np.argsort(-sims, axis=1)
    n = sims.shape[0]
    top1 = float(np.mean(order[:, 0] == np.arange(n)))
    top5 = float(np.mean([i in order[i, :min(5, n)] for i in range(n)]))
    return {"sims": sims, "top1": top1, "top5": top5}


def tiny_ids(n: int) -> np.ndarray:
    """The prompts' stand-in token ids for ``--tiny``."""
    return np.asarray(
        np.random.RandomState(0).randint(1, 200, size=(n, 16)), np.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--renders", required=True)
    ap.add_argument("--prompts", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny towers (pipeline smoke only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..utils.r_precision import load_r_precision, make_tiny_r_precision

    prompts = [ln.strip() for ln in Path(args.prompts).read_text()
               .splitlines() if ln.strip()]
    images, kept = load_images(args.renders, prompts)
    if not images:
        raise SystemExit("no renders matched the prompt list")
    texts = [prompts[i] for i in kept]
    if args.tiny:
        dev = resolve_device(args.device)
        rp = make_tiny_r_precision(torch.Generator(dev).manual_seed(0),
                                   device=dev)
        texts = tiny_ids(len(texts))
    else:
        rp = load_r_precision(args.weights or "", device=args.device)
        if rp is None:
            raise SystemExit(f"no CLIP weights file under {args.weights!r}")
    out = score(rp, images, texts)
    line = {"metric": "clip_r_precision", "n": int(out["sims"].shape[0]),
            "top1": out["top1"], "top5": out["top5"],
            "tiny_towers": bool(args.tiny)}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()

#!/usr/bin/env bash
# Real-weights runbook for the PyTorch port: run this once on a machine that
# has the licensed/public assets, then smoke-train 100 steps before
# committing to a full run. scripts/convert_all.sh is the JAX package's
# runbook; this one converts nothing, since the port reads the diffusers
# layout as it is (dreamwaltz_g_tpu_torch/configs/paths.py).
#
# Inputs (set the env vars or edit the defaults):
#   HF_SRC    - a diffusers model directory of the card (runwayml/
#               stable-diffusion-v1-5's layout) with the pose ControlNet
#               beside it: unet/, vae/, text_encoder/, tokenizer/
#               (vocab.json, merges.txt), controlnet_pose/ (from
#               lllyasviel/control_v11p_sd15_openpose), and optionally
#               clip_retrieval/ (a transformers CLIPModel of
#               openai/clip-vit-base-patch32 with its vocab.json /
#               merges.txt) for R-Precision
#   SMPLX_NPZ - SMPLX_NEUTRAL_2020.npz (https://smpl-x.is.tue.mpg.de, licensed)
#   EXTERNAL  - asset root (default ./external, see configs/paths.py)
#   COPY      - 1 copies HF_SRC instead of linking it
set -euo pipefail
cd "$(dirname "$0")/../.."

EXTERNAL="${EXTERNAL:-external}"
HF_SRC="${HF_SRC:?set HF_SRC to the diffusers model directory}"
SMPLX_NPZ="${SMPLX_NPZ:-}"
COPY="${COPY:-0}"
OUT="$EXTERNAL/guidance_diffusers"
mkdir -p "$EXTERNAL/human_templates/smplx"
# the port reads its assets from these (configs/paths.py)
export GUIDANCE_WEIGHTS="$OUT"
export HUMAN_TEMPLATES="$EXTERNAL/human_templates"

echo "== 1/4 check the diffusers layout of $HF_SRC -> $OUT"
# the card is picked at run time (--guide.diffusion), LoRA files go under
# $OUT/lora/<name> (--guide.lora_name) and Textual-Inversion embeddings
# under $OUT/concepts/<name>/learned_embeds.bin (--guide.concept_name)
for d in unet vae text_encoder tokenizer controlnet_pose; do
    if [ ! -d "$HF_SRC/$d" ]; then
        echo "   $HF_SRC/$d is missing: guidance/convert.py:load_guidance" \
             "reads unet/, vae/, text_encoder/, tokenizer/ and" \
             "controlnet_pose/" >&2
        exit 1
    fi
done
for f in vocab.json merges.txt; do
    if [ ! -f "$HF_SRC/tokenizer/$f" ]; then
        echo "   $HF_SRC/tokenizer/$f is missing" >&2
        exit 1
    fi
done
if [ -d "$HF_SRC/clip_retrieval" ]; then
    echo "   clip_retrieval/ found: R-Precision runs after each evaluation"
else
    echo "   (no clip_retrieval/: R-Precision is skipped)"
fi
src="$(cd "$HF_SRC" && pwd -P)"
if [ -L "$OUT" ]; then
    rm "$OUT"
fi
if [ -e "$OUT" ]; then
    echo "   $OUT exists and is not a link: left as it is"
elif [ "$COPY" = 1 ]; then
    cp -r "$src" "$OUT"
else
    ln -s "$src" "$OUT"
fi

echo "== 2/4 SMPL-X template"
if [ -n "$SMPLX_NPZ" ]; then
    cp "$SMPLX_NPZ" "$EXTERNAL/human_templates/smplx/SMPLX_NEUTRAL_2020.npz"
else
    echo "   (skip: SMPLX_NPZ not set — place SMPLX_NEUTRAL_2020.npz under"
    echo "    $EXTERNAL/human_templates/smplx/ manually)"
fi
# optional extras next to the npz: smplx_vert_segmentation.json (semantic
# parts), smplx_kid_template.npy (--prompt.smpl_age kid), VPoser ckpt

echo "== 3/4 weights self-check (check_sd sample export)"
python -m dreamwaltz_g_tpu_torch.main --stage nerf --guide.text "a photo of a person" \
    --log.exp_root outputs/smoke --log.exp_name checksd \
    --log.check_sd true --optim.iters 1 \
    --log.snapshot_interval 0 --log.evaluate_interval 0 --log.save_interval 0
echo "   inspect outputs/smoke/checksd/check/sd_*.png — they must look like"
echo "   real SD samples of the prompt before you spend hours training"

echo "== 4/4 100-step smoke train (stage 1 then stage 2)"
python -m dreamwaltz_g_tpu_torch.main --stage nerf --guide.text "a photo of a person" \
    --log.exp_root outputs/smoke --log.exp_name s1 --optim.iters 100 \
    --data.train_w 64 --log.save_interval 100
python -m dreamwaltz_g_tpu_torch.main --stage gs --guide.text "a photo of a person" \
    --render.from_nerf outputs/smoke/s1 \
    --log.exp_root outputs/smoke --log.exp_name s2 --optim.iters 100 \
    --log.save_interval 100
echo "smoke OK — full runs: dreamwaltz_g_tpu_torch/scripts/train_w_expr.sh /"
echo "train_wo_expr.sh"

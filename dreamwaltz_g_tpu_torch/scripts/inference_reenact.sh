#!/usr/bin/env bash
# Video reenactment with Motion-X-ReEnact motion + inpainted background,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/inference_reenact.sh makes the same calls
# through the JAX package's main.py.
set -e
exp_name="${1:?usage: inference_reenact.sh <exp_name> <sequence>}"
seq="${2:?sequence name inside Motion-X-ReEnact}"
python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true --optim.resume true \
    --log.exp_name "${exp_name}" --prompt.scene "motionx_reenact,${seq}" \
    --render.use_video_background "${seq}"

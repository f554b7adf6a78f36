#!/usr/bin/env bash
# AIST++ dance animation of a trained avatar,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/inference_aist.sh makes the same calls
# through the JAX package's main.py.
set -e
exp_name="${1:?usage: inference_aist.sh <exp_name>}"
python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true --optim.resume true \
    --log.exp_name "${exp_name}" --prompt.scene demo,aist \
    --data.eval_camera_track fixed --data.eval_elevation 90

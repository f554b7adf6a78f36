#!/usr/bin/env bash
# TalkSHOW demo-motion animation of a trained avatar,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/inference_talkshow.sh makes the same calls
# through the JAX package's main.py.
set -e
exp_name="${1:?usage: inference_talkshow.sh <exp_name>}"
python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true --optim.resume true \
    --log.exp_name "${exp_name}" --prompt.scene demo,talkshow \
    --data.eval_camera_track fixed --data.eval_elevation 90

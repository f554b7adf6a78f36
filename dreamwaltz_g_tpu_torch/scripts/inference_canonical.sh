#!/usr/bin/env bash
# Canonical-pose turntable render of a trained avatar,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/inference_canonical.sh makes the same calls
# through the JAX package's main.py.
set -e
exp_name="${1:?usage: inference_canonical.sh <exp_name>}"
python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true --optim.resume true \
    --log.exp_name "${exp_name}" --prompt.scene canonical

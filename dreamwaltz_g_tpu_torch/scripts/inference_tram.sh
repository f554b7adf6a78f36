#!/usr/bin/env bash
# In-the-wild reenactment from TRAM estimates,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/inference_tram.sh makes the same calls
# through the JAX package's main.py.
set -e
exp_name="${1:?usage: inference_tram.sh <exp_name> <sequence>}"
seq="${2:?sequence name inside the tram root}"
python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true --optim.resume true \
    --log.exp_name "${exp_name}" --prompt.scene "tram,${seq}"

#!/usr/bin/env bash
# NeRF pretrain against SMPL-X depth/mask -> the human template checkpoint
# consumed by stage 1.1,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/pretrain_nerf.sh makes the same calls
# through the JAX package's main.py.
set -e
python -m dreamwaltz_g_tpu_torch.main \
    --stage nerf \
    --log.pretrain_only true \
    --log.exp_name "pretrain/instant-ngp-adult-neutral" \
    --optim.iters 5000 \
    --data.train_w 512 --data.train_h 512 \
    --prompt.scene canonical

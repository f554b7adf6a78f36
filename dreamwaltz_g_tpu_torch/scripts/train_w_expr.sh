#!/usr/bin/env bash
# Full two-stage training with expression control (5 sub-stages), then
# the animation test,
# through the PyTorch port's CLI (python -m dreamwaltz_g_tpu_torch.main).
# Run from the repository root; scripts/train_w_expr.sh makes the same calls
# through the JAX package's main.py.
set -e
text="${1:?usage: train_w_expr.sh \"a wizard ...\"}"

exp_root="$(echo "$text" | tr '[:upper:]' '[:lower:]' | sed 's/ /_/g')"
predefined_body_parts=hands,face
random_pose_sampler=random-body,hand,expr

# 1.1 Canonical NeRF, progressive 64 -> 128 -> 256
last_ckpt="external/human_templates/instant-ngp/adult_neutral/"
exp_name="${exp_root}/nerf,64-256,10k"
python -m dreamwaltz_g_tpu_torch.main \
    --guide.text "${text}" \
    --log.exp_name "${exp_name}" \
    --optim.ckpt "${last_ckpt}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage nerf \
    --nerf.bg_mode gray \
    --optim.iters 10000 \
    --prompt.scene canonical \
    --data.train_w "64,128,256" \
    --data.train_h "64,128,256" \
    --data.progressive_grid true \
    --use_sigma_guidance true

# 1.2 Canonical NeRF, 512
last_ckpt="outputs/${exp_name}"
exp_name="${exp_name}-nerf,512,5k"
python -m dreamwaltz_g_tpu_torch.main \
    --guide.text "${text}" \
    --log.exp_name "${exp_name}" \
    --optim.ckpt "${last_ckpt}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage nerf \
    --nerf.bg_mode gray \
    --optim.iters 5000 \
    --prompt.scene canonical \
    --data.train_w 512 --data.train_h 512 \
    --use_sigma_guidance true

# 2.1 Animatable 3DGS, canonical pose
last_ckpt="outputs/${exp_name}"
exp_name="${exp_name}-3dgs,cnl,5k"
python -m dreamwaltz_g_tpu_torch.main \
    --guide.text "${text}" \
    --log.exp_name "${exp_name}" \
    --render.from_nerf "${last_ckpt}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage gs \
    --optim.iters 5000 \
    --prompt.scene canonical \
    --render.learn_hand_betas true \
    --render.lbs_weight_smooth true \
    --render.bg_color "(0.5,0.5,0.5)"

# 2.2 Animatable 3DGS, random canonical pose
last_ckpt="outputs/${exp_name}"
from_nerf_ckpt="${last_ckpt}"
exp_name="${exp_name}-3dgs,rcnl,5k"
python -m dreamwaltz_g_tpu_torch.main \
    --guide.text "${text}" \
    --log.exp_name "${exp_name}" \
    --optim.ckpt "${last_ckpt}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage gs \
    --optim.iters 5000 \
    --prompt.scene canonical-R \
    --render.bg_color "(0.5,0.5,0.5)"

# 2.3 Animatable 3DGS, random pose
last_ckpt="outputs/${exp_name}"
exp_name="${exp_name}-3dgs,rand,5k"
python -m dreamwaltz_g_tpu_torch.main \
    --guide.text "${text}" \
    --log.exp_name "${exp_name}" \
    --optim.ckpt "${last_ckpt}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage gs \
    --optim.iters 5000 \
    --prompt.scene "${random_pose_sampler}" \
    --render.bg_color "(0.5,0.5,0.5)"

# 3 Animation test (TalkSHOW demo motion)
python -m dreamwaltz_g_tpu_torch.main \
    --log.exp_name "${exp_name}" \
    --predefined_body_parts ${predefined_body_parts} \
    --stage gs \
    --log.eval_only true \
    --optim.resume true \
    --prompt.scene demo,talkshow \
    --data.eval_elevation 90 \
    --data.eval_camera_track fixed

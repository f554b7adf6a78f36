"""PyTorch + CUDA port of ``dreamwaltz_g_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout and names, so each module here
has its counterpart at the same relative path there. It imports ``torch``
and numpy only: nothing of JAX and nothing of the JAX package.

Entry points take ``device="cuda"`` by default and raise when CUDA is absent;
only an explicit ``device="cpu"`` runs on the CPU, through each kernel's
plain PyTorch version.

Ported so far:

* the render path of a trained avatar (animate -> project -> sorted tile
  bin -> sorted tile blend), with the blend as a hand-written CUDA kernel
  (``csrc/blend_sorted.cu``);
* the stage-2 avatar SDS training step (render through the (T, K) tile
  table -> VAE encode -> ControlNet + UNet CFG -> SDS gradient -> backward
  -> Adam -> densification stats), with the table blend's forward and
  backward, and its forward-only eval twin, as hand-written CUDA kernels
  (``csrc/blend_train.cu``);
* the run around that step: flash attention in the UNet, the ControlNet
  and the VAE as a hand-written CUDA kernel, forward and backward
  (``csrc/flash_attn.cu``), densification, the pixel-gradient hooks, the
  timestep scheduler and the OpenPose canvas;
* stage 1 and the guidance's inputs: the CLIP text tower and its
  tokenizers, the loader of released diffusers / transformers weights, and
  the NeRF SDS step (rays -> occupancy grid -> compacted samples ->
  triplane field -> composite -> the same guidance, flash attention
  included -> regularisers -> Adam / AdamW / Adan), with the pretrain step
  and the eval render;
* the trainer and its CLI (``main.py``), inference and evaluation, and
  multi-view SDS (``parallel/dp.py``: B views a step through one blend
  launch each way and one guidance call), as ``ROADMAP.md`` lists them.
"""

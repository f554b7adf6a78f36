"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

# cuDNN's setting on the card: its default float32 convolution backward adds
# in no fixed order; ``scripts/repeat_check.py`` turns this off to show it
CUDNN_DETERMINISTIC = True


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    A CUDA device is refused when CUDA is absent: nothing falls back to the
    CPU unless the caller asks for it. ``"cuda"`` resolves to the current
    card's index, so it compares equal to a tensor's ``cuda:<i>`` device.
    On CUDA, float32 matmuls and
    convolutions are held at full precision (no TF32), as the JAX reference
    runs at ``highest`` matmul precision, and cuDNN takes only
    deterministic convolution algorithms: its default float32 backward
    adds in no fixed order, so two equal training steps parted (the tiny
    stage-1 step's gradients by up to 1e-4 on an H100)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    A CUDA device is refused when CUDA is absent: nothing falls back to the
    CPU unless the caller asks for it. ``"cuda"`` resolves to the current
    card's index, so it compares equal to a tensor's ``cuda:<i>`` device.
    On CUDA, float32 matmuls and
    convolutions are held at full precision (no TF32), as the JAX reference
    runs at ``highest`` matmul precision."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

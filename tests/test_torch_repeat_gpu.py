"""Stage 1 on the card repeats to the bit within one process.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so on a machine without them it runs as

    python -m pytest tests/test_torch_repeat_gpu.py -m gpu --noconftest -q

* One stage-1 SDS step of a tiny NeRF (``scripts/repeat_check.py``'s: a
  16^2 x 8 triplane, a 16^3 grid, rays in checkpointed chunks, sigma
  guidance, volume sparsity, the background MLP) with the tiny float32
  guidance and its ControlNet, twice from copies of the same field, grid
  and draws, as ``resolve_device`` leaves cuDNN: the metrics, every
  gradient and every updated weight equal to the bit, with flash attention
  "on" (the kernels) and "off" (einsum). cuDNN's default float32
  convolution backward adds in no fixed order, and ``resolve_device``
  holds it to deterministic algorithms.
* ``nerf/export.py:export_point_cloud`` of one field at 400^3 with the
  isolated-cell filter, twice: the points, colours and counts equal.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dreamwaltz_g_tpu_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("flash", ["on", "off"])
def test_stage1_step_repeats_to_the_bit(flash):
    from dreamwaltz_g_tpu_torch.guidance import layers as TL
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC

    dev = _card()
    inputs = RC.stage1_inputs(dev)
    setting = TL.FLASH_ATTENTION
    TL.FLASH_ATTENTION = flash
    try:
        (m1, g1, p1), (m2, g2, p2) = (RC.stage1_step(dev, *inputs)
                                      for _ in range(2))
    finally:
        TL.FLASH_ATTENTION = setting
    assert torch.backends.cudnn.deterministic
    assert m1 == m2
    assert max(float(g.abs().max()) for g in g1 if g.numel()) > 0.0
    assert RC.differ(g1, g2)["differing"] == 0
    assert RC.differ(p1, p2)["differing"] == 0


def test_export_repeats_to_the_bit():
    from dreamwaltz_g_tpu_torch.scripts import repeat_check as RC

    (s1, c1), (s2, c2) = RC.export_twice(_card())
    assert s1 == s2 and s1["kept_cells"] > 0
    np.testing.assert_array_equal(c1.points, c2.points)
    np.testing.assert_array_equal(c1.colors, c2.colors)

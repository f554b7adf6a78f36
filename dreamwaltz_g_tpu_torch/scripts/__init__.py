"""The port's entry scripts and tools.

The shell scripts are the twins of the JAX package's ``scripts/*.sh``: the
same calls, each through ``python -m dreamwaltz_g_tpu_torch.main``, run
from the repository root. ``eval_r_precision``, ``compare_backbones`` and
``rescore_backbone_state`` are the twins of the JAX package's tools of the
same names (``python -m dreamwaltz_g_tpu_torch.scripts.<name>``).
``repeat_check`` runs a stage-1 step twice on the card under each cuDNN
setting. ``record.record_calls`` runs a shell script with a ``python`` that
only records its command lines.
"""

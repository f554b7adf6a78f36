"""Command-line entry of the port: ``python -m dreamwaltz_g_tpu_torch.main``.

Port of the JAX package's ``main.py``: the same ``--section.field value``
flags parse to a ``TrainConfig``, and ``run`` dispatches to the trainer:
``--log.eval_only true`` to ``full_eval`` (inference: the avatar animated
on the test track, its frames, video and R-Precision), else to ``train``.
Runs on the card unless ``--log.platform cpu``. The multi-prompt batch
mode (``--guide.text_set``) is not ported yet.

Usage:
    python -m dreamwaltz_g_tpu_torch.main --stage nerf --guide.text "a wizard" \\
        --log.exp_name wiz/nerf
    python -m dreamwaltz_g_tpu_torch.main --stage gs \\
        --render.from_nerf outputs/wiz/nerf --guide.text "a wizard" \\
        --log.exp_name wiz/gs
    python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true \\
        --optim.resume true --log.exp_name wiz/gs --prompt.scene demo,talkshow
"""
from __future__ import annotations

import sys

from .configs import TrainConfig, parse_args


def run(cfg: TrainConfig):
    """Build the trainer, restore its checkpoint under ``--optim.resume``,
    then evaluate (``--log.eval_only``) or train. Returns the trainer."""
    from .training.trainer import Trainer

    trainer = Trainer(cfg)
    if cfg.optim.resume:
        try:
            trainer.load_checkpoint()
        except FileNotFoundError:
            pass
    if cfg.log.eval_only:
        trainer.full_eval()
    else:
        trainer.train()
    return trainer


def main(argv=None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    if cfg.guide.text_set:
        raise NotImplementedError(
            "--guide.text_set (run_multiple, configs/prompts.py) is not "
            "ported yet")
    return run(cfg)


if __name__ == "__main__":
    main()

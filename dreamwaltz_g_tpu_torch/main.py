"""Command-line entry of the port: ``python -m dreamwaltz_g_tpu_torch.main``.

Port of the JAX package's ``main.py``: the same ``--section.field value``
flags parse to a ``TrainConfig``, and ``run`` dispatches to the trainer in
the JAX order: ``--log.eval_only true`` to ``full_eval`` (inference: the
avatar animated on the test track, its frames, video and R-Precision),
``--log.pretrain_only`` to ``pretrain`` (the NeRF fitted to the SMPL-X
depth and mask), ``--log.nerf2gs`` to ``pretrain_nerf2gs`` (the avatar
distilled from a frozen stage-1 field), ``--log.nerf2mesh`` to
``export_mesh`` (the stage-1 field as a textured mesh), else to ``train``.
``--guide.text_set`` runs every prompt of a set (``run_multiple``). Runs on
the card unless ``--log.platform cpu``.

Usage:
    python -m dreamwaltz_g_tpu_torch.main --stage nerf --guide.text "a wizard" \\
        --log.exp_name wiz/nerf
    python -m dreamwaltz_g_tpu_torch.main --stage gs \\
        --render.from_nerf outputs/wiz/nerf --guide.text "a wizard" \\
        --log.exp_name wiz/gs
    python -m dreamwaltz_g_tpu_torch.main --stage gs --log.eval_only true \\
        --optim.resume true --log.exp_name wiz/gs --prompt.scene demo,talkshow
    python -m dreamwaltz_g_tpu_torch.main --stage nerf \\
        --log.pretrain_only true --log.exp_name pretrain/adult_neutral
    python -m dreamwaltz_g_tpu_torch.main --guide.text_set demo,1-3 \\
        --stage nerf --log.exp_name batch/@/nerf
"""
from __future__ import annotations

import copy
import logging
import sys

from .configs import TrainConfig, parse_args

logger = logging.getLogger("dreamwaltz_g_tpu_torch")


def run(cfg: TrainConfig):
    """Build the trainer, restore its checkpoint under ``--optim.resume``,
    then run the mode the flags select. Returns the trainer."""
    from .training.trainer import Trainer

    trainer = Trainer(cfg)
    if cfg.optim.resume:
        try:
            trainer.load_checkpoint()
        except FileNotFoundError:
            pass
    if cfg.log.eval_only:
        trainer.full_eval()
    elif cfg.log.pretrain_only:
        trainer.pretrain()
    elif cfg.log.nerf2gs:
        trainer.pretrain_nerf2gs()
    elif cfg.log.nerf2mesh:
        trainer.export_mesh()
    else:
        trainer.train()
    return trainer


def run_multiple(cfg: TrainConfig) -> list:
    """Every prompt of ``--guide.text_set`` in turn, each in its own
    experiment: '@' in ``exp_name`` becomes the prompt's slug, else the
    slug is appended as a sub-directory. A failed prompt does not stop the
    batch; after the last one, one ``RuntimeError`` names every prompt that
    failed, chained to the first failure. Returns the trainers."""
    from .configs.prompts import get_avatar_list

    base_exp = cfg.log.exp_name
    trainers, failed, first = [], [], None
    for slug, text in get_avatar_list(cfg.guide.text_set):
        c = copy.deepcopy(cfg)
        c.guide.text = text
        c.log.exp_name = base_exp.replace("@", slug) if "@" in base_exp \
            else f"{base_exp}/{slug}"
        try:
            trainers.append(run(c))
        except Exception as e:   # re-raised below, after the batch
            logger.exception("run_multiple: prompt %r failed", text)
            failed.append(text)
            first = first or e
    if failed:
        raise RuntimeError(f"run_multiple: {len(failed)} prompt(s) failed: "
                           f"{failed}") from first
    return trainers


def main(argv=None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    if cfg.guide.text_set:
        return run_multiple(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()

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

Several cards: under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` in the environment, ``WORLD_SIZE`` > 1) ``main`` starts the
default process group when none is started yet, ``nccl`` on card
``LOCAL_RANK`` (``gloo`` under ``--log.platform cpu``), and every rank runs
the trainer (``training/trainer.py``: the (data, model) mesh, rank 0
writing). A group that already exists is used as it is.

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
    torchrun --nproc_per_node 2 -m dreamwaltz_g_tpu_torch.main --stage gs \\
        --optim.batch_size 2 --render.from_nerf outputs/wiz/nerf \\
        --guide.text "a wizard" --log.exp_name wiz/gs
"""
from __future__ import annotations

import copy
import logging
import os
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


def init_distributed(cfg: TrainConfig) -> None:
    """Start the default process group of a ``torchrun`` launch (module
    docstring): nothing without one, with a group already started, or at
    ``WORLD_SIZE`` 1. On the card the rank's device is set before its
    first launch; a rank without CUDA raises."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ or dist.is_initialized():
        return
    if cfg.log.platform == "cpu":
        dist.init_process_group("gloo")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a rank of a torchrun "
                           "launch runs on its card (--log.platform cpu "
                           "for the CPU)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))


def main(argv=None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    init_distributed(cfg)
    if cfg.guide.text_set:
        return run_multiple(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

"""Checkpoint save/load with rotating retention.

Port of ``dreamwaltz_g_tpu/training/checkpoint.py`` with a torch format in
place of orbax: a checkpoint is a directory ``step_{:08d}/`` holding one
``state.pt`` written by ``torch.save``. Its tree holds tensors, numbers,
strings, lists, tuples and dicts only, so ``torch.load(weights_only=True)``
reads it. ``max_keep`` rotation and latest-step discovery are the JAX
package's; ``resolve_ckpt_path`` takes the same three forms as its
``training/trainer.py:resolve_ckpt_path``.
"""
from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, List, Optional

import torch

_STEP_RE = re.compile(r"step_(\d+)$")
STATE_FILE = "state.pt"


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_pytree(path, tree) -> Path:
    """Write ``tree`` (tensors moved to the CPU) as ``path/state.pt``,
    replacing a directory already there."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(_to_cpu(tree), path / STATE_FILE)
    return path


def load_pytree(path, map_location="cpu"):
    """Read a tree written by ``save_pytree`` (tensors on
    ``map_location``)."""
    return torch.load(Path(path).absolute() / STATE_FILE,
                      map_location=map_location, weights_only=True)


class Checkpointer:
    def __init__(self, ckpt_dir, max_keep: int = 1):
        self.dir = Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_keep = max_keep

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.iterdir():
            m = _STEP_RE.search(p.name)
            if m and p.is_dir():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, state: Any) -> Path:
        """Write the tree; keep the newest ``max_keep`` checkpoints
        (every one when ``max_keep <= 0``)."""
        path = save_pytree(self._path(step), state)
        if self.max_keep > 0:
            for s in self.all_steps()[: -self.max_keep]:
                shutil.rmtree(self._path(s), ignore_errors=True)
        return path

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """(tree, step) of the given step, the latest when ``step`` is
        None."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return load_pytree(self._path(step), map_location), step


def resolve_ckpt_path(path) -> Optional[Path]:
    """A step directory, a ``checkpoints/`` directory (its latest step) or
    an experiment directory (its ``checkpoints/``' latest step); None when
    nothing is there."""
    p = Path(path)
    if not p.exists():
        return None
    if p.name.startswith("step_"):
        return p
    if (p / "checkpoints").is_dir():
        p = p / "checkpoints"
    steps = sorted(d for d in p.iterdir() if d.name.startswith("step_"))
    return steps[-1] if steps else None

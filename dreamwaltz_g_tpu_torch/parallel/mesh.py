"""The data axis of multi-view SDS training.

Port of ``dreamwaltz_g_tpu/parallel/mesh.py``. The JAX package shards the
view batch over the ``data`` axis of a device mesh; here the data axis is
a process group of ``torch.distributed``, one process a card. Each rank
renders and guides its contiguous slice of the views, and the step
(``parallel/dp.py``) all-reduces the gradients. Without an initialized
group the mesh is this one process: world 1, rank 0, every view here.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .._device import resolve_device

DATA_AXIS = "data"


class DataMesh(NamedTuple):
    """The data axis: ``world`` ranks, this process's ``rank``, its card
    and the process group (None: the default group, or no group)."""

    world: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world}


def make_mesh(group=None, device="cuda") -> DataMesh:
    """The data axis of ``group`` (the default group when None) when
    ``torch.distributed`` is initialized, else of this process alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    return DataMesh(world, rank, resolve_device(device), group)


def resolve_dp(req_dp: int, world: int, batch_size: int) -> int:
    """The data-parallel degree of ``--parallel.dp``: -1 means every rank;
    clamped to ``min(dp, world, batch_size)``, at least 1, and it must
    divide ``batch_size`` (the JAX trainer's resolution)."""
    dp = world if req_dp < 0 else min(req_dp, world)
    dp = max(min(dp, batch_size), 1)
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} must divide over "
                         f"dp={dp} (parallel.dp={req_dp}, {world} ranks)")
    return dp


def local_batch_size(global_batch: int, mesh: DataMesh,
                     axis_name: str = DATA_AXIS) -> int:
    n = mesh.shape[axis_name]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"mesh axis {axis_name}={n}")
    return global_batch // n


def shard_batch(tree, mesh: DataMesh, axis_name: str = DATA_AXIS):
    """This rank's contiguous slice of the leading (view) dimension:
    tensors and lists (one entry a view, e.g. generators) are sliced,
    NamedTuples, tuples and dicts leaf by leaf; None and scalars pass."""
    if mesh.world == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis_name) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [shard_batch(v, mesh, axis_name) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    if isinstance(tree, (torch.Tensor, list)):
        n = local_batch_size(len(tree), mesh, axis_name)
        return tree[mesh.rank * n:(mesh.rank + 1) * n]
    return tree


def replicate(tree, mesh: Optional[DataMesh] = None):
    """Every rank holds the whole model and optimizer state, so placing a
    tree on every rank is a no-op in one process: the tree is returned as
    it is (ranks agree by construction from one seed and by the step's
    all-reduce)."""
    return tree

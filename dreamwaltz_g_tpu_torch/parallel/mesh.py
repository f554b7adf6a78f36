"""The (data, model) mesh of multi-view SDS training.

Port of ``dreamwaltz_g_tpu/parallel/mesh.py``. The JAX package shards the
view batch over the ``data`` axis of a device mesh and the guidance over
its ``model`` axis (``make_mesh_2d``); here the axes are process groups of
``torch.distributed``, one process a card. The model axis is minor: ranks
``g * tp ... g * tp + tp - 1`` form model group ``g`` and hold the same
views; the data axis takes every ``tp``-th rank. Each model group renders
and guides its contiguous slice of the views (``shard_batch`` slices by the
data index), and the step (``parallel/dp.py``) all-reduces the gradients.

With fewer views than data groups (``dp`` below ``world / tp``) the spare
groups are replicas: group ``g`` takes data index ``g % dp``, and the
gradient mean over every rank is the mean over the ``dp`` data indices.
Without an initialized group the mesh is this one process: world 1, rank
0, every view here.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class DataMesh(NamedTuple):
    """The data axis: ``world`` data indices, this process's ``rank`` among
    them, its card and the group spanning its data axis (None: the default
    group, or no group); group rank ``j`` holds data index ``j % world``.
    The model axis: ``tp`` ranks, this process's ``model_rank``, its group
    (None at tp = 1). The step's mean over every rank of the default group
    is the view mean (``parallel/dp.py``)."""

    world: int
    rank: int
    device: torch.device
    group: Any = None
    tp: int = 1
    model_rank: int = 0
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world, MODEL_AXIS: self.tp}


def world_size() -> int:
    """The ranks of the default group (1 without an initialized one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(dp: int = -1, device="cuda") -> DataMesh:
    """The data axis alone (the JAX ``make_mesh``): ``make_mesh_2d(dp,
    1)``."""
    return make_mesh_2d(dp, 1, device)


def make_mesh_2d(dp: int = -1, tp: int = 1, device="cuda") -> DataMesh:
    """The (data, model) mesh over the default group (the JAX
    ``make_mesh_2d``): ``tp`` must divide the world; ``dp`` (-1: world /
    tp) data indices. Every rank builds every subgroup, in the same order
    (``dist.new_group`` is collective); at world 1 no group is made."""
    import torch.distributed as dist

    world = world_size()
    rank = dist.get_rank() if world > 1 else 0
    if tp < 1 or world % tp:
        raise ValueError(f"parallel.tp={tp} must divide the {world} ranks")
    groups = world // tp
    dp = groups if dp < 0 else dp
    if not 1 <= dp <= groups:
        raise ValueError(f"dp={dp} with tp={tp} needs 1..{groups} data "
                         f"groups of {world} ranks")
    device = resolve_device(device)
    if world == 1:
        return DataMesh(1, 0, device)
    model_group = data_group = None
    for g in range(groups):
        ranks = list(range(g * tp, (g + 1) * tp))
        grp = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            model_group = grp
    for m in range(tp):
        ranks = list(range(m, world, tp))
        grp = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            data_group = grp
    return DataMesh(dp, (rank // tp) % dp, device, data_group, tp,
                    rank % tp, model_group)


def resolve_dp(req_dp: int, world: int, batch_size: int) -> int:
    """The data-parallel degree of ``--parallel.dp``: -1 means every data
    group; clamped to ``min(dp, world, batch_size)``, at least 1, and it
    must divide ``batch_size`` (the JAX trainer's resolution; ``world`` is
    the number of data groups, ranks / tp)."""
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
    """This rank's contiguous slice of the leading (view) dimension, by its
    data index: tensors and lists (one entry a view, e.g. generators) are
    sliced, NamedTuples, tuples and dicts leaf by leaf; None and scalars
    pass."""
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


def gather_batch(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The data axis's slices of ``t`` concatenated along dim 0 in data
    order (a list ``all_gather`` over ``mesh.group``, whose first ``world``
    ranks hold data indices 0 .. world - 1); ``t`` itself at world 1."""
    if mesh.world == 1:
        return t
    import torch.distributed as dist

    if t.dtype == torch.bool:
        return gather_batch(t.to(torch.uint8), mesh).bool()
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts[:mesh.world])


def all_reduce_mean(tensors) -> None:
    """Every rank's tensors replaced by the mean over every rank of the
    default group, in place, in one collective (replicas of one data index
    average too, so they stay equal); nothing on a single rank."""
    tensors = [t for t in tensors if t is not None]
    n = world_size()
    if n == 1 or not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= n
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].reshape(t.shape))
        i += n


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """``t``'s maximum over every rank (``t`` itself on a single rank)."""
    if world_size() > 1:
        import torch.distributed as dist

        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def replicate(tree, mesh: Optional[DataMesh] = None):
    """Every rank holds the whole model and optimizer state, so placing a
    tree on every rank is a no-op in one process: the tree is returned as
    it is (ranks agree by construction from one seed and by the step's
    all-reduce)."""
    return tree

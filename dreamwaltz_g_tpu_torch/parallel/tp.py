"""Tensor-parallel sharding of the frozen guidance (UNet and ControlNet).

Port of ``dreamwaltz_g_tpu/parallel/tp.py``. The JAX package annotates the
guidance's weights with Megatron partition specs over the mesh's ``model``
axis and lets GSPMD partition the matmuls and insert the all-reduces. Here
each rank of a model group keeps its own slice of those weights and the
layers run it (``guidance/layers.py``): the column-parallel projections
compute this rank's heads (or feed-forward columns), the row-parallel ones
this rank's partial sums, all-reduced over the model group, their bias
added once after the sum.

The rule, by parameter name (diffusers' names, the port's own):

- ``to_q`` / ``to_k`` / ``to_v`` weights: column-parallel, this rank's
  heads (the weight's rows, torch keeping (out, in));
- ``to_out.0`` weight: row-parallel (its columns); the bias replicated;
- ``ff.net.0.proj`` weight and bias: column-parallel; GEGLU's two halves
  each split alike, so a rank's gate multiplies its own columns;
- ``ff.net.2`` weight: row-parallel; the bias replicated;
- everything else replicated: convolutions, norms, time embeddings, the
  whole VAE and the text towers.

Heads split as evenly as possible: with ``H`` heads over ``tp`` ranks,
rank ``r`` takes heads ``r * H // tp`` to ``(r + 1) * H // tp``, and a
block with fewer heads than ``tp`` raises. Differences by design from the
JAX package: GSPMD runs any head count (it reshards where ``tp`` does not
divide); and its contiguous split of the GEGLU projection's ``2 * inner``
columns gives one rank the value half and the other the gate, resharded at
the split, where each rank here keeps its slice of both halves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..guidance.layers import Attention, FeedForwardGEGLU
from .mesh import DataMesh

COLUMN, ROW = "column", "row"
_COL_PARALLEL = ("to_q", "to_k", "to_v")


def tp_rule(name: str) -> Optional[str]:
    """``COLUMN``, ``ROW`` or None (replicated) for the guidance parameter
    ``name`` of the UNet or the ControlNet (the JAX ``_tp_spec``)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    leaf, parent = parts[-1], parts[-2]
    if parent in _COL_PARALLEL and leaf == "weight":
        return COLUMN
    if parts[-3:-1] == ["to_out", "0"] and leaf == "weight":
        return ROW
    if parts[-4:-1] == ["net", "0", "proj"]:
        return COLUMN
    if parts[-3:-1] == ["net", "2"] and leaf == "weight":
        return ROW
    return None


def guidance_pspecs(gparams) -> Dict[str, Optional[Dict[str, Optional[str]]]]:
    """{model: {parameter name: ``tp_rule``}} for ``GuidanceParams``: the
    UNet and the ControlNet by the rule, the VAE replicated."""
    def specs(module):
        return None if module is None else {
            n: tp_rule(n) for n, _ in module.named_parameters()}

    return {"unet": specs(gparams.unet),
            "vae": {n: None for n, _ in gparams.vae.named_parameters()},
            "controlnet": specs(gparams.controlnet)}


def split_range(n: int, tp: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s share ``[lo, hi)`` of ``n`` items split as evenly as
    possible over ``tp`` ranks."""
    return rank * n // tp, (rank + 1) * n // tp


@torch.no_grad()
def _keep(param: nn.Parameter, index: torch.Tensor, dim: int) -> None:
    """Replace ``param``'s data by its ``index`` slice along ``dim``."""
    param.data = param.data.index_select(dim, index.to(param.device)) \
        .contiguous()


def _shard_attention(attn: Attention, tp: int, rank: int, group) -> None:
    H, D = attn.heads, attn.head_dim
    if H < tp:
        raise ValueError(f"tensor parallelism over {tp} ranks needs at least "
                         f"{tp} heads a block; a block has {H}")
    lo, hi = split_range(H, tp, rank)
    cols = torch.arange(lo * D, hi * D)
    for lin in (attn.to_q, attn.to_k, attn.to_v):
        _keep(lin.weight, cols, 0)
    _keep(attn.to_out[0].weight, cols, 1)
    attn.heads = hi - lo
    attn.tp_group = group


def _shard_geglu(ff: FeedForwardGEGLU, tp: int, rank: int, group) -> None:
    proj = ff.net[0].proj
    inner = proj.weight.shape[0] // 2
    lo, hi = split_range(inner, tp, rank)
    cols = torch.arange(lo, hi)
    both = torch.cat([cols, cols + inner])
    _keep(proj.weight, both, 0)
    if proj.bias is not None:
        _keep(proj.bias, both, 0)
    _keep(ff.net[2].weight, cols, 1)
    ff.tp_group = group


def shard_guidance_params(gparams, mesh: DataMesh):
    """Keep this rank's slice of the UNet's and the ControlNet's Megatron
    weights in place (``tp_rule``), set each ``Attention`` to its local head
    count and give it and each GEGLU feed-forward the model group. At tp =
    1 nothing changes. Returns ``gparams``."""
    if mesh.tp == 1:
        return gparams
    for net in (gparams.unet, gparams.controlnet):
        if net is None:
            continue
        for module in net.modules():
            if isinstance(module, Attention):
                _shard_attention(module, mesh.tp, mesh.model_rank,
                                 mesh.model_group)
            elif isinstance(module, FeedForwardGEGLU):
                _shard_geglu(module, mesh.tp, mesh.model_rank,
                             mesh.model_group)
    return gparams

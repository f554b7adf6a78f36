"""Adaptive density control in fixed-capacity buffers.

Port of the parts of ``dreamwaltz_g_tpu/gaussian/densify.py`` that the
avatar's densifier uses: ``DensifyConfig``, ``allocate_slots`` and
``reset_opt_slots``. Clone, split and prune are masked writes into the
slots of a buffer whose size never changes; the optimizer's moments are
zeroed on every slot that was rewritten. The vanilla-3DGS ``densify_step``
and ``reset_opacity`` are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class DensifyConfig(NamedTuple):
    grad_threshold: float = 100.0       # SDS-scale default
    percent_dense: float = 0.01
    spatial_scale: float = 1.0
    min_opacity: float = 0.005
    max_screen_size: Optional[float] = None   # prune if max radii exceeds
    max_world_size: Optional[float] = None    # prune if world scale exceeds
    split_scale_shrink: float = 1.6
    enable_clone: bool = True
    enable_split: bool = True
    enable_prune: bool = True
    opacity_reset_value: float = 0.01
    # grad-prune mode: suspend clone/split and prune the points whose
    # accumulated screen-space gradient exceeds grad_threshold
    grad_prune: bool = False


def allocate_slots(need: torch.Tensor, alive: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each needing entry a dead slot index.

    need: (C,) bool, entries requesting one new slot each; alive: (C,) bool,
    slot occupancy after pruning. Returns (dest (C,) int32: the allocated
    slot per need, C where denied; granted (C,) bool). The k-th needing
    entry takes the k-th free slot, in index order."""
    C = need.shape[0]
    dev = need.device
    free = ~alive
    need_rank = torch.cumsum(need.to(torch.int32), 0) - 1
    free_slots = torch.nonzero(free)[:, 0].to(torch.int32)
    n_free = free_slots.shape[0]
    # slot_of_rank[r] = the r-th free slot, C past the last one
    slot_of_rank = torch.full((C,), C, dtype=torch.int32, device=dev)
    slot_of_rank[:n_free] = free_slots
    granted = need & (need_rank < n_free)
    dest = torch.where(granted,
                       slot_of_rank[torch.clamp(need_rank, 0, C - 1).long()],
                       torch.full_like(need_rank, C))
    return dest.to(torch.int32), granted


@torch.no_grad()
def reset_opt_slots(opt_state, written: torch.Tensor):
    """Zero Adam's first and second moments on the rewritten slots, in
    place, for every tensor of the optimizer whose leading dimension is the
    capacity. Adam creates its state at a parameter's first step: a
    parameter with no state yet has nothing to reset. Returns
    ``opt_state``."""
    C = written.shape[0]
    adam = opt_state.adam
    for group in adam.param_groups:
        for p in group["params"]:
            st = adam.state.get(p)
            if not st:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                m = st.get(key)
                if m is not None and m.ndim >= 1 and m.shape[0] == C:
                    m[written.to(m.device)] = 0.0
    return opt_state

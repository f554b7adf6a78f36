"""Adaptive density control in fixed-capacity buffers.

Port of ``dreamwaltz_g_tpu/gaussian/densify.py``: ``DensifyConfig``,
``allocate_slots`` and ``reset_opt_slots`` (the avatar's densifier uses
them, ``system/avatar.py:densify_avatar``), and the vanilla-3DGS pass over
a ``GaussianState``: ``update_stats``, ``densify_step`` and
``reset_opacity``. Clone, split and prune are masked writes into the slots
of a buffer whose size never changes, made in place into the parameter
tensors (the leaves an optimizer holds); the optimizer's moments are
zeroed on every slot that was rewritten.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.transforms import quat_normalize, quat_rotate
from .model import GaussianParams, GaussianState, logit32, opacities, scales


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


def update_stats(state: GaussianState, means2d_grad: torch.Tensor,
                 radii: torch.Tensor) -> GaussianState:
    """Accumulate the densification statistics of the visible slots
    (alive, radius > 0): the screen-space gradient norm, a visibility
    count and the largest radius."""
    vis = (radii > 0) & state.alive
    gnorm = torch.linalg.norm(means2d_grad, dim=-1)
    zero = torch.zeros_like(gnorm)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(vis, gnorm, zero),
        grad_denom=state.grad_denom + vis.to(torch.float32),
        max_radii=torch.maximum(state.max_radii,
                                torch.where(vis, radii, zero)))


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


def sample_split_offsets(params: GaussianParams, normal: torch.Tensor
                         ) -> torch.Tensor:
    """A split child's offset: the (C, 3) standard-normal draw scaled by the
    Gaussian's scales and rotated into its frame."""
    return quat_rotate(quat_normalize(params.quats),
                       normal * scales(params))


@torch.no_grad()
def densify_step(state: GaussianState, cfg: DensifyConfig,
                 generator: Optional[torch.Generator] = None,
                 densify_mask: Optional[torch.Tensor] = None,
                 extra_attrs: Optional[Dict[str, torch.Tensor]] = None,
                 offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One clone / split / prune pass. Returns (new_state, written), or
    (new_state, written, extras) with ``extra_attrs``; ``written`` marks the
    slots whose parameters were rewritten or pruned, whose optimizer
    moments must be reset.

    The parameters are written in place (the returned state shares
    ``state.params``' tensors), with a new alive mask and zeroed
    statistics. ``densify_mask`` restricts the pass to a subset.
    ``extra_attrs``: per-slot (C, ...) tensors riding along (the vanilla
    avatar's LBS weights); children copy their parent's rows, into copies.
    The split's two (C, 3) standard-normal draws come from ``generator``,
    or are handed in as ``offsets=(n1, n2)`` (the JAX package draws them
    from the two halves of its key)."""
    p = state.params
    C = state.capacity
    dev = p.means.device
    avg_grad = state.grad_accum / torch.clamp(state.grad_denom, min=1.0)
    s = scales(p)
    max_s = s.max(dim=-1).values
    op = opacities(p)
    none = torch.zeros(C, dtype=torch.bool, device=dev)

    eligible = state.alive
    if densify_mask is not None:
        eligible = eligible & densify_mask
    limit = cfg.percent_dense * cfg.spatial_scale
    hot = eligible & (avg_grad > cfg.grad_threshold) & (state.grad_denom > 0)
    if cfg.grad_prune:
        clone_mask = split_mask = none
    else:
        clone_mask = hot & (max_s <= limit) if cfg.enable_clone else none
        split_mask = hot & (max_s > limit) if cfg.enable_split else none

    prune_mask = eligible & (op < cfg.min_opacity)
    if cfg.max_screen_size is not None:
        prune_mask = prune_mask | (eligible
                                   & (state.max_radii > cfg.max_screen_size))
    if cfg.max_world_size is not None:
        prune_mask = prune_mask | (eligible & (max_s > cfg.max_world_size))
    if cfg.grad_prune:
        prune_mask = prune_mask | hot
    if not cfg.enable_prune:
        prune_mask = none
    # a split parent is consumed: its slot is overwritten by child 1
    prune_mask = prune_mask & ~split_mask
    alive_after = state.alive & ~prune_mask
    need = clone_mask | split_mask
    dest, granted = allocate_slots(need, alive_after)

    if offsets is None:
        if generator is None:
            raise ValueError("pass generator= or offsets=")
        n1, n2 = (torch.randn(s.shape, generator=generator, device=dev)
                  for _ in range(2))
    else:
        n1, n2 = (torch.as_tensor(n, dtype=torch.float32, device=dev)
                  for n in offsets)
    off1 = sample_split_offsets(p, n1)
    off2 = sample_split_offsets(p, n2)
    split_logs = torch.log(torch.clamp(s / cfg.split_scale_shrink,
                                       min=1e-10))

    # every source value is taken before the first write; the free slots
    # that receive children and the split parents' own slots are disjoint
    src = torch.nonzero(granted)[:, 0]
    dst = dest[src].long()
    sp = split_mask & granted
    split_src = split_mask[src, None]
    child = {
        "means": torch.where(split_src, (p.means + off2)[src], p.means[src]),
        "log_scales": torch.where(split_src, split_logs[src],
                                  p.log_scales[src]),
        **{k: getattr(p, k)[src]
           for k in ("sh_dc", "sh_rest", "opacity_logit", "quats")}}
    first_means = (p.means + off1)[sp]
    for k, v in child.items():
        getattr(p, k)[dst] = v
    p.means[sp] = first_means
    p.log_scales[sp] = split_logs[sp]

    alive_new = alive_after.clone()
    alive_new[dst] = True
    written = torch.zeros(C, dtype=torch.bool, device=dev)
    written[dst] = True
    written = written | sp | prune_mask
    z = torch.zeros((C,), dtype=torch.float32, device=dev)
    new_state = GaussianState(params=p, alive=alive_new, grad_accum=z,
                              grad_denom=z.clone(), max_radii=z.clone())
    if extra_attrs is None:
        return new_state, written
    extras = {}
    for k, v in extra_attrs.items():
        v = v.clone()
        v[dst] = v[src]
        extras[k] = v
    return new_state, written, extras


@torch.no_grad()
def reset_opacity(state: GaussianState, value: float = 0.01
                  ) -> GaussianState:
    """Clamp every opacity to at most ``value``, in place on the logit
    tensor."""
    state.params.opacity_logit.clamp_(max=logit32(value))
    return state


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

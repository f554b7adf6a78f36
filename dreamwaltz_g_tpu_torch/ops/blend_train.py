"""Tile-table blend of the training step (B1) and its forward-only twin (B3).

Port of ``dreamwaltz_g_tpu/ops/pallas_blend.py``: ``blend_tiles_pallas_train``
(the differentiable pair, forward ``_make_fwd_train_kernel`` and backward
``_make_bwd_train_kernel``) and ``blend_tiles_pallas`` (the eval forward
``_make_kernel``). Tile t composites the Gaussians ``tile_lists[b, t, :k]``,
``k = tile_counts[b, t]`` (depth-ordered by ``rasterize.bin_gaussians``),
front to back over its ``tile_size**2`` pixels. The kernels take a leading
view dimension B (1 on the single-view training step).

Per-entry inputs are the packed rows of ``blend.pack_rows``; per-entry
gradients come back as a (B, T, K, 16) panel in the same lane layout
([d mx, d my, d ca, d cb, d cc, d op, 0, 0, d values...]) and reach the
Gaussians through ``panel_grads``, a sum over ``tile_lists`` in one fixed
order, the sentinel row dropped: the vjp of the per-tile gather, as in the
JAX package.

* ``blend_train_fwd`` / ``blend_train_bwd`` / ``blend_tiles_eval`` launch
  ``csrc/blend_train.cu`` for CUDA tensors and take the plain versions for
  CPU tensors; each counts its kernel launches in ``.launches``.
* ``blend_tiles_train_reference_fwd`` / ``_bwd`` and
  ``blend_tiles_eval_reference`` are the TPU kernels' algorithm in float32
  PyTorch: chunks of C entries, an exclusive log-transmittance prefix, a
  tile-granular stop at chunk boundaries once every pixel's log T is below
  ln(1e-4), a per-chunk log-T checkpoint, and the hand-derived backward
  ``dw = G T - S / (1 - w)`` (S the suffix sum of G * contrib) chained to
  the mean, conic and opacity.
* ``BlendTilesTrain`` is the ``torch.autograd.Function`` over the two.

The kernels stop per pixel (after the entry that takes its T to 1e-4 or
below), the TPU kernels per tile at chunk boundaries (once every pixel of
the tile is there). What the tile stop still adds after a pixel's own stop
is at most 1e-4 |value| on each output. The gradients differ more: for an
entry before the stop, the extra suffix (at most 1e-4 of the upstream
gradient) is divided by 1 - w, which alpha_clip = 0.999 lets reach 1e-3.
So the plain versions take ``stop="tile"`` (the TPU algorithm, the
default, held against the JAX package) or ``stop="pixel"`` (the kernels'
rule: a pair counts only while the pixel's log T before it is above
ln(1e-4)), which the kernels are held to. ``PLAIN_STOP`` picks the rule
the wrappers' plain versions follow on CPU tensors, and
``blend_tiles_train_stop_envelope`` bounds, entry by entry, how far the
two rules' gradients may part.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from .. import kernels
from .blend import (
    BLOCK_ROWS,
    LOG_T_EPS,
    _tile,
    _tile_pixel_centres,
    _untile,
    pack_rows,
)

#: the stop rule of the plain versions the wrappers take for CPU tensors:
#: "tile" (the TPU kernels' algorithm) or "pixel" (the CUDA kernels' rule)
PLAIN_STOP = "tile"


def _gather(packed: torch.Tensor, tile_lists: torch.Tensor) -> torch.Tensor:
    """(B, N + 1, 16) rows, (B, T, K) lists -> (B, T, K, 16) panels."""
    B, T, K = tile_lists.shape
    idx = tile_lists.long().reshape(B, T * K, 1).expand(B, T * K, 16)
    return torch.gather(packed, 1, idx).reshape(B, T, K, 16)


def _chunked(tile_lists: torch.Tensor, n_rows: int, chunk: int):
    """Pad the lists to a chunk multiple with the sentinel row."""
    B, T, K = tile_lists.shape
    C = min(chunk, K)
    n_chunks = -(-K // C)
    if K % C:
        tile_lists = torch.cat([tile_lists, torch.full(
            (B, T, n_chunks * C - K), n_rows - 1, dtype=tile_lists.dtype,
            device=tile_lists.device)], -1)
    return tile_lists, C, n_chunks


def _weights(a, px, py, alpha_clip, min_alpha):
    """q, w_raw and the clipped, masked w of every (pixel, entry) pair, in
    the order the kernels evaluate them. a: (B, T, C, 16); px, py: (T, P, 1).
    Returns dx, dy, q, w_raw, w, each (B, T, P, C)."""
    dx = px - a[..., None, :, 0]
    dy = py - a[..., None, :, 1]
    q = a[..., None, :, 2] * dx * dx + 2.0 * a[..., None, :, 3] * dx * dy \
        + a[..., None, :, 4] * dy * dy
    w_raw = a[..., None, :, 5] * torch.exp(-0.5 * q)
    w = torch.where((q >= 0) & (w_raw >= min_alpha),
                    torch.clamp(w_raw, max=alpha_clip), torch.zeros_like(w_raw))
    return dx, dy, q, w_raw, w


def _exclusive_log_t(w, log_t, stop="tile"):
    """Exclusive log-T prefix of every pair, and the chunk's total. With
    ``stop="pixel"`` the pairs after a pixel's own stop (log T before them
    at or below LOG_T_EPS) get w = 0; the prefix is monotone, so those are
    exactly the pairs after the stop. Returns (excl, total, w)."""
    l = torch.log1p(-w)
    incl = torch.cumsum(l, dim=-1)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                     dim=-1) + log_t[..., None]
    if stop == "pixel":
        w = torch.where(excl > LOG_T_EPS, w, torch.zeros_like(w))
        return _exclusive_log_t(w, log_t)
    if stop != "tile":
        raise ValueError(f"stop must be 'tile' or 'pixel', got {stop!r}")
    return excl, incl[..., -1], w


def blend_tiles_train_reference_fwd(
    tile_lists: torch.Tensor,
    tile_counts: torch.Tensor,
    packed: torch.Tensor,
    tile_size: int,
    tiles_x: int,
    chunk: int = 128,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
    stats: Optional[dict] = None,
    stop: str = "tile",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain float32 version of the TPU training forward. Returns ``(out
    (B, T, P, 8), ckpt (B, T, n_chunks, P))``: ckpt holds the log T entering
    each chunk, which the backward recomputes from.

    ``stats``, when given, receives ``pairs``: the (pixel, entry) pairs
    before each pixel's own log T falls below ``LOG_T_EPS`` -- the work a
    per-pixel early stop has to do --, ``blended``, those whose weight
    passes the min_alpha test, and ``reached``, the (B, T, P) count of them
    for each pixel (a prefix of its tile's list)."""
    B, T, _ = tile_lists.shape
    tile_lists, C, n_chunks = _chunked(tile_lists, packed.shape[1], chunk)
    panels = _gather(packed, tile_lists)
    tiles_y = T // tiles_x
    pix = _tile_pixel_centres(tiles_x, tiles_y, tile_size, packed.device)
    px, py = pix[..., 0:1], pix[..., 1:2]                 # (T, P, 1)
    P = pix.shape[1]
    counts = tile_counts.long()
    log_t = torch.zeros((B, T, P), device=packed.device)
    acc = torch.zeros((B, T, P, 8), device=packed.device)
    ckpt = torch.empty((B, T, n_chunks, P), device=packed.device)
    pairs = blended = 0
    reached = torch.zeros((B, T, P), dtype=torch.long, device=packed.device)
    for k in range(n_chunks):
        ckpt[:, :, k] = log_t
        a = panels[:, :, k * C:(k + 1) * C]               # (B, T, C, 16)
        live = (k * C < counts) & (log_t.amax(-1) > LOG_T_EPS)   # (B, T)
        _, _, _, _, w = _weights(a, px, py, alpha_clip, min_alpha)
        w = torch.where(live[..., None, None], w, torch.zeros_like(w))
        excl, total, w = _exclusive_log_t(w, log_t, stop)
        contrib = torch.exp(excl) * w
        acc = acc + contrib @ a[..., 8:16]
        if stats is not None:
            pos = k * C + torch.arange(C, device=packed.device)
            use = live[..., None, None] & (pos < counts[..., None, None])
            before_stop = (excl > LOG_T_EPS) & use
            pairs += int(before_stop.sum())
            blended += int((before_stop & (w > 0)).sum())
            reached += before_stop.sum(-1)
        log_t = log_t + total
    if stats is not None:
        stats["pairs"] = pairs
        stats["blended"] = blended
        stats["reached"] = reached
    return acc, ckpt


def blend_tiles_train_reference_bwd(
    tile_lists: torch.Tensor,
    tile_counts: torch.Tensor,
    packed: torch.Tensor,
    ckpt: torch.Tensor,
    g_out: torch.Tensor,
    tile_size: int,
    tiles_x: int,
    chunk: int = 128,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
    stop: str = "tile",
) -> torch.Tensor:
    """Plain float32 version of the TPU training backward: chunks in
    reverse, ``contrib`` recomputed from the checkpoint, and

        G = g . vals,  dvals = sum_p contrib g,
        dw = G T - (S + R) / max(1 - w, 1e-6)   (zero outside ``active``),

    S the in-chunk suffix sum of G * contrib and R the suffix carried from
    later chunks, then dw chained to d(mean, conic, opacity). g_out: (B, T,
    P, 8). Returns the (B, T, K, 16) per-entry gradient panel."""
    B, T, K = tile_lists.shape
    tile_lists, C, n_chunks = _chunked(tile_lists, packed.shape[1], chunk)
    panels = _gather(packed, tile_lists)
    tiles_y = T // tiles_x
    pix = _tile_pixel_centres(tiles_x, tiles_y, tile_size, packed.device)
    px, py = pix[..., 0:1], pix[..., 1:2]
    P = pix.shape[1]
    counts = tile_counts.long()
    d_panels = torch.zeros((B, T, n_chunks * C, 16), device=packed.device)
    suffix = torch.zeros((B, T, P), device=packed.device)
    for k in reversed(range(n_chunks)):
        log_t = ckpt[:, :, k]
        a = panels[:, :, k * C:(k + 1) * C]
        live = ((k * C < counts) & (log_t.amax(-1) > LOG_T_EPS))[..., None, None]
        dx, dy, q, w_raw, w = _weights(a, px, py, alpha_clip, min_alpha)
        w = torch.where(live, w, torch.zeros_like(w))
        excl, _, w = _exclusive_log_t(w, log_t, stop)
        active = (w > 0) & (w_raw <= alpha_clip)
        t_excl = torch.exp(excl)
        contrib = t_excl * w                               # (B, T, P, C)
        vals = a[..., 8:16]                                # (B, T, C, 8)
        G = g_out @ vals.transpose(-1, -2)                 # (B, T, P, C)
        Gc = G * contrib
        d_vals = contrib.transpose(-1, -2) @ g_out         # (B, T, C, 8)
        # strict suffix within the chunk, plus the later chunks' sum
        S = torch.flip(torch.cumsum(torch.flip(Gc, [-1]), -1), [-1]) - Gc \
            + suffix[..., None]
        dw = G * t_excl - S / torch.clamp(1.0 - w, min=1e-6)
        dw = torch.where(active, dw, torch.zeros_like(dw))
        dq = dw * w * (-0.5)
        op = a[..., None, :, 5]
        ca, cb, cc = a[..., None, :, 2], a[..., None, :, 3], a[..., None, :, 4]
        d_op = torch.where(op > 0, dw * w / torch.clamp(op, min=1e-12),
                           torch.zeros_like(dw)).sum(-2)
        dqdx = 2.0 * ca * dx + 2.0 * cb * dy
        dqdy = 2.0 * cc * dy + 2.0 * cb * dx
        z = torch.zeros_like(d_op)
        d_attrs = torch.stack([
            (-dq * dqdx).sum(-2), (-dq * dqdy).sum(-2), (dq * dx * dx).sum(-2),
            (dq * 2.0 * dx * dy).sum(-2), (dq * dy * dy).sum(-2), d_op, z, z],
            -1)                                            # (B, T, C, 8)
        d_panels[:, :, k * C:(k + 1) * C] = torch.cat([d_attrs, d_vals], -1)
        suffix = suffix + Gc.sum(-1)
    return d_panels[:, :, :K]


def blend_tiles_eval_reference(
    tile_lists: torch.Tensor,
    tile_counts: torch.Tensor,
    packed: torch.Tensor,
    tile_size: int,
    tiles_x: int,
    chunk: int = 128,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
    stop: str = "tile",
) -> torch.Tensor:
    """Plain version of the TPU eval forward (B3): the training forward
    without the checkpoint. Returns (B, T, P, 8)."""
    out, _ = blend_tiles_train_reference_fwd(
        tile_lists, tile_counts, packed, tile_size, tiles_x, chunk=chunk,
        alpha_clip=alpha_clip, min_alpha=min_alpha, stop=stop)
    return out


def blend_tiles_train_stop_envelope(
    tile_lists: torch.Tensor,
    tile_counts: torch.Tensor,
    packed: torch.Tensor,
    ckpt: torch.Tensor,
    g_out: torch.Tensor,
    tile_size: int,
    tiles_x: int,
    chunk: int = 128,
    alpha_clip: float = 0.999,
    min_alpha: float = 1.0 / 255.0,
) -> torch.Tensor:
    """Bound, entry by entry, on how far the tile stop's gradient panel
    (``blend_tiles_train_reference_bwd``) parts from the pixel stop's on the
    same inputs and upstream gradient; ``ckpt`` is the tile-stop forward's.
    Returns a (B, T, K, 16) panel >= 0 in the gradient panel's lane layout;
    ``panel_grads`` of it bounds the per-Gaussian gap.

    For pixel p, let X_p be its pairs past its own stop (w > 0 under the
    tile stop and log T before them at or below LOG_T_EPS) and
    F_p = sum over X_p of |G| contrib. The pixel stop drops X_p, so:

    * every earlier active pair's suffix S loses at most F_p: its dw moves
      by at most F_p / max(1 - w, 1e-6), and its dvals not at all;
    * a pair of X_p loses its whole dw, at most
      |G| T + F_p / max(1 - w, 1e-6), and its dvals, contrib |g|.

    Each bound on dw goes through the absolute values of the chain to the
    mean, conic and opacity, and is summed over the tile's pixels."""
    B, T, K = tile_lists.shape
    tile_lists, C, n_chunks = _chunked(tile_lists, packed.shape[1], chunk)
    panels = _gather(packed, tile_lists)
    tiles_y = T // tiles_x
    pix = _tile_pixel_centres(tiles_x, tiles_y, tile_size, packed.device)
    px, py = pix[..., 0:1], pix[..., 1:2]
    counts = tile_counts.long()

    def pairs(k):
        log_t = ckpt[:, :, k]
        a = panels[:, :, k * C:(k + 1) * C]
        live = ((k * C < counts) & (log_t.amax(-1) > LOG_T_EPS))[..., None, None]
        dx, dy, _, w_raw, w = _weights(a, px, py, alpha_clip, min_alpha)
        w = torch.where(live, w, torch.zeros_like(w))
        excl, _, w = _exclusive_log_t(w, log_t)
        past = (w > 0) & (excl <= LOG_T_EPS)
        t_excl = torch.exp(excl)
        G = (g_out @ a[..., 8:16].transpose(-1, -2)).abs()    # (B, T, P, C)
        return a, dx, dy, w_raw, w, past, t_excl, G

    F = torch.zeros(ckpt.shape[:2] + ckpt.shape[3:], device=packed.device)
    for k in range(n_chunks):
        _, _, _, _, w, past, t_excl, G = pairs(k)
        F = F + torch.where(past, G * t_excl * w, torch.zeros_like(G)).sum(-1)
    env = torch.zeros((B, T, n_chunks * C, 16), device=packed.device)
    g_abs = g_out.abs()
    for k in range(n_chunks):
        a, dx, dy, w_raw, w, past, t_excl, G = pairs(k)
        e_dw = F[..., None] / torch.clamp(1.0 - w, min=1e-6) \
            + torch.where(past, G * t_excl, torch.zeros_like(G))
        e_dw = torch.where((w > 0) & (w_raw <= alpha_clip), e_dw,
                           torch.zeros_like(e_dw))
        e_dq = 0.5 * e_dw * w
        op = a[..., None, :, 5]
        ca, cb, cc = a[..., None, :, 2], a[..., None, :, 3], a[..., None, :, 4]
        e_op = torch.where(op > 0, e_dw * w / torch.clamp(op, min=1e-12),
                           torch.zeros_like(e_dw)).sum(-2)
        dqdx = (2.0 * ca * dx + 2.0 * cb * dy).abs()
        dqdy = (2.0 * cc * dy + 2.0 * cb * dx).abs()
        z = torch.zeros_like(e_op)
        e_attrs = torch.stack([
            (e_dq * dqdx).sum(-2), (e_dq * dqdy).sum(-2),
            (e_dq * dx * dx).sum(-2), (e_dq * 2.0 * (dx * dy).abs()).sum(-2),
            (e_dq * dy * dy).sum(-2), e_op, z, z], -1)        # (B, T, C, 8)
        dropped = torch.where(past, t_excl * w, torch.zeros_like(w))
        e_vals = dropped.transpose(-1, -2) @ g_abs            # (B, T, C, 8)
        env[:, :, k * C:(k + 1) * C] = torch.cat([e_attrs, e_vals], -1)
    return env[:, :, :K]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, tile_lists, tile_counts, packed, tile_size, tiles_x):
    """Device, dtype, shape and contiguity of the kernels' operands.
    Returns the device."""
    devs = {t.device for t in (tile_lists, tile_counts, packed)}
    if len(devs) != 1:
        raise ValueError(f"{name} inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if tile_lists.ndim != 3:
        raise ValueError(f"tile_lists must be (B, T, K), got "
                         f"{tuple(tile_lists.shape)}")
    B, T, _ = tile_lists.shape
    if tuple(tile_counts.shape) != (B, T):
        raise ValueError(f"tile_counts has shape {tuple(tile_counts.shape)}, "
                         f"expected {(B, T)}")
    if packed.ndim != 3 or packed.shape[0] != B or packed.shape[2] != 16:
        raise ValueError(f"packed must be (B, N + 1, 16), got "
                         f"{tuple(packed.shape)}")
    if T % tiles_x:
        raise ValueError(f"{T} tiles is not a multiple of {tiles_x} columns")
    if dev.type == "cuda":
        P = tile_size * tile_size
        if P > 1024 or P % 32:
            raise ValueError(f"tile_size {tile_size}: need a multiple of 32 "
                             "pixels per tile, at most 1024")
        for n, t, dtype in (("tile_lists", tile_lists, torch.int32),
                            ("tile_counts", tile_counts, torch.int32),
                            ("packed", packed, torch.float32)):
            if t.dtype != dtype:
                raise ValueError(f"{n} must be {dtype}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{n} must be contiguous")
        if packed.data_ptr() % 16:
            raise ValueError("packed must be 16-byte aligned")
    return dev


def _launch(fn_name, *args):
    fn = getattr(kernels.load("blend_train"), fn_name)
    dev = next(a.device for a in args if torch.is_tensor(a))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() if torch.is_tensor(a) else a for a in args],
                stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")


def blend_train_fwd(tile_lists, tile_counts, packed, tile_size: int,
                    tiles_x: int, chunk: int = 128, alpha_clip: float = 0.999,
                    min_alpha: float = 1.0 / 255.0):
    """B1 forward over (B, T, K) lists and (B, N + 1, 16) packed rows.
    Returns ``(out (B, T, P, 8), saved)``; ``saved`` is what
    ``blend_train_bwd`` needs: the plain version's log-T checkpoint on the
    CPU, each pixel's final transmittance and walked-entry count on the
    card (``chunk`` shapes only the plain version)."""
    dev = _check("blend_train_fwd", tile_lists, tile_counts, packed,
                 tile_size, tiles_x)
    if dev.type == "cpu":
        out, ckpt = blend_tiles_train_reference_fwd(
            tile_lists, tile_counts, packed, tile_size, tiles_x, chunk,
            alpha_clip, min_alpha, stop=PLAIN_STOP)
        return out, (ckpt,)
    B, T, K = tile_lists.shape
    P = tile_size * tile_size
    out = torch.empty((B, T, P, 8), dtype=torch.float32, device=dev)
    t_final = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    n_last = torch.empty((B, T, P), dtype=torch.int32, device=dev)
    _launch("blend_train_fwd_f32", packed, tile_lists, tile_counts, out,
            t_final, n_last, B, T, K, packed.shape[1], tiles_x, tile_size,
            alpha_clip, min_alpha, math.exp(LOG_T_EPS))
    blend_train_fwd.launches += 1
    return out, (t_final, n_last)


def blend_train_bwd(tile_lists, tile_counts, packed, saved, g_out,
                    tile_size: int, tiles_x: int, chunk: int = 128,
                    alpha_clip: float = 0.999,
                    min_alpha: float = 1.0 / 255.0) -> torch.Tensor:
    """B1 backward: (B, T, P, 8) upstream gradient -> (B, T, K, 16)
    per-entry gradient panel (slots past a tile's count are zero). On the
    card it allocates a (B, T, tile_size / BLOCK_ROWS, K, 16) float32
    scratch for the sub-tile blocks' sums, their walk lengths and the order
    in which the blocks take the tiles."""
    dev = _check("blend_train_bwd", tile_lists, tile_counts, packed,
                 tile_size, tiles_x)
    if dev.type == "cpu":
        (ckpt,) = saved
        return blend_tiles_train_reference_bwd(
            tile_lists, tile_counts, packed, ckpt, g_out, tile_size, tiles_x,
            chunk, alpha_clip, min_alpha, stop=PLAIN_STOP)
    B, T, K = tile_lists.shape
    P = tile_size * tile_size
    t_final, n_last = saved
    g_out = g_out.to(torch.float32).contiguous()
    if tuple(g_out.shape) != (B, T, P, 8):
        raise ValueError(f"g_out has shape {tuple(g_out.shape)}, expected "
                         f"{(B, T, P, 8)}")
    S = tile_size // BLOCK_ROWS
    # each sub-tile block's per-entry sums and its walk length, summed in
    # strip order by the second kernel
    parts = torch.empty((B, T, S, K, 16), dtype=torch.float32, device=dev)
    lens = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    order = torch.empty((B, T), dtype=torch.int32, device=dev)
    d_panels = torch.empty((B, T, K, 16), dtype=torch.float32, device=dev)
    _launch("blend_train_bwd_f32", packed, tile_lists, tile_counts, t_final,
            n_last, g_out, parts, lens, order, d_panels, B, T, K,
            packed.shape[1], tiles_x, tile_size, alpha_clip, min_alpha)
    blend_train_bwd.launches += 1
    return d_panels


def blend_tiles_eval_panels(tile_lists, tile_counts, packed, tile_size: int,
                            tiles_x: int, chunk: int = 128,
                            alpha_clip: float = 0.999,
                            min_alpha: float = 1.0 / 255.0) -> torch.Tensor:
    """B3: the forward without saved state. Returns (B, T, P, 8)."""
    dev = _check("blend_tiles_eval", tile_lists, tile_counts, packed,
                 tile_size, tiles_x)
    if dev.type == "cpu":
        return blend_tiles_eval_reference(tile_lists, tile_counts, packed,
                                          tile_size, tiles_x, chunk,
                                          alpha_clip, min_alpha,
                                          stop=PLAIN_STOP)
    B, T, K = tile_lists.shape
    P = tile_size * tile_size
    out = torch.empty((B, T, P, 8), dtype=torch.float32, device=dev)
    _launch("blend_tiles_eval_f32", packed, tile_lists, tile_counts, out,
            B, T, K, packed.shape[1], tiles_x, tile_size, alpha_clip,
            min_alpha, math.exp(LOG_T_EPS))
    blend_tiles_eval_panels.launches += 1
    return out


blend_train_fwd.launches = 0
blend_train_bwd.launches = 0
blend_tiles_eval_panels.launches = 0


# ---------------------------------------------------------------------------
# Image-level entry points
# ---------------------------------------------------------------------------

def _batched(tile_lists, tile_counts, means2d, conic, opacity, values):
    """Add the leading view dimension to unbatched operands."""
    if tile_lists.ndim == 2:
        return True, (tile_lists[None], tile_counts.reshape(1, -1),
                      means2d[None], conic[None], opacity[None], values[None])
    return False, (tile_lists, tile_counts.reshape(tile_lists.shape[:2]),
                   means2d, conic, opacity, values)


def _operands(tile_lists, tile_counts):
    """The kernels' integer operands: int32, contiguous."""
    return (tile_lists.to(torch.int32).contiguous(),
            tile_counts.to(torch.int32).contiguous())


def panel_grads(d_panels: torch.Tensor, tile_lists: torch.Tensor,
                n_rows: int, CV: int):
    """The per-tile gather's vjp: each (B, T, K, 16) panel entry summed
    into its Gaussian's row of its view in one fixed order, (tile, slot),
    so the same panels give the same bits from call to call. The sum is
    ``index_put_(accumulate=True)``: on a CUDA tensor PyTorch sorts the
    row ids with a stable radix sort and adds each row's entries one after
    another in that order (``index_add_`` adds with atomics there, in no
    fixed order). Empty slots name the sentinel row (n_rows - 1); each is
    sent to a spare row of its own and dropped, since the sorted sum walks
    a row's entries in series and the sentinel's run would be long.
    Returns the (B, N, ...) gradients of means2d, conic, opacity and
    values (CV lanes)."""
    B, T, K = tile_lists.shape
    dev = d_panels.device
    lists = tile_lists.long()
    rows = lists + n_rows * torch.arange(B, device=dev)[:, None, None]
    spare = B * n_rows + torch.arange(B * T * K, device=dev).reshape(B, T, K)
    rows = torch.where(lists == n_rows - 1, spare, rows)
    d_rows = torch.zeros((B * n_rows + B * T * K, 16), dtype=torch.float32,
                         device=dev)
    d_rows.index_put_((rows.reshape(-1),), d_panels.reshape(-1, 16),
                      accumulate=True)
    d_rows = d_rows[:B * n_rows].reshape(B, n_rows, 16)[:, :-1]
    return (d_rows[..., 0:2], d_rows[..., 2:5], d_rows[..., 5],
            d_rows[..., 8:8 + CV])


class BlendTilesTrain(torch.autograd.Function):
    """Differentiable table blend: B1 forward and backward.

    ``apply(tile_lists (B, T, K), tile_counts (B, T), means2d (B, N, 2),
    conic (B, N, 3), opacity (B, N) pre-masked, values (B, N, CV), H, W,
    tile_size, chunk, alpha_clip, min_alpha)`` -> (B, H, W, CV). Gradients
    flow to means2d, conic, opacity and values."""

    @staticmethod
    def forward(ctx, tile_lists, tile_counts, means2d, conic, opacity, values,
                image_height, image_width, tile_size=32, chunk=128,
                alpha_clip=0.999, min_alpha=1.0 / 255.0):
        tile_lists, tile_counts = _operands(tile_lists, tile_counts)
        packed = pack_rows(means2d, conic, opacity, values)
        tiles_x = -(-image_width // tile_size)
        kw = dict(chunk=chunk, alpha_clip=alpha_clip, min_alpha=min_alpha)
        out, saved = blend_train_fwd(tile_lists, tile_counts, packed,
                                     tile_size, tiles_x, **kw)
        ctx.save_for_backward(tile_lists, tile_counts, packed, *saved)
        ctx.meta = (tile_size, tiles_x, kw, values.shape[-1])
        return _untile(out, values.shape[-1], image_height, image_width,
                       tile_size)

    @staticmethod
    def backward(ctx, g_img):
        tile_lists, tile_counts, packed, *saved = ctx.saved_tensors
        tile_size, tiles_x, kw, CV = ctx.meta
        with record_function("blend_train.backward"):
            d_panels = blend_train_bwd(tile_lists, tile_counts, packed,
                                       saved, _tile(g_img, tile_size),
                                       tile_size, tiles_x, **kw)
            grads = panel_grads(d_panels, tile_lists, packed.shape[1], CV)
        return (None, None, *grads, None, None, None, None, None, None)


def blend_tiles_train(tile_lists, tile_counts, means2d, conic, opacity,
                      values, image_height: int, image_width: int,
                      tile_size: int = 32, chunk: int = 128,
                      alpha_clip: float = 0.999,
                      min_alpha: float = 1.0 / 255.0) -> torch.Tensor:
    """Differentiable table blend. Unbatched operands ((T, K) lists, (N, ...)
    attributes) give (H, W, CV); batched ones (B, ...) give (B, H, W, CV)."""
    squeeze, args = _batched(tile_lists, tile_counts, means2d, conic,
                             opacity, values)
    out = BlendTilesTrain.apply(*args, image_height, image_width, tile_size,
                                chunk, alpha_clip, min_alpha)
    return out[0] if squeeze else out


def blend_tiles_eval(tile_lists, tile_counts, means2d, conic, opacity,
                     values, image_height: int, image_width: int,
                     tile_size: int = 32, chunk: int = 128,
                     alpha_clip: float = 0.999,
                     min_alpha: float = 1.0 / 255.0) -> torch.Tensor:
    """Forward-only table blend (B3); not differentiable. Shapes as
    ``blend_tiles_train``."""
    squeeze, (tl, tc, m, c, o, v) = _batched(tile_lists, tile_counts,
                                             means2d, conic, opacity, values)
    tl, tc = _operands(tl, tc)
    with torch.no_grad():
        out = blend_tiles_eval_panels(
            tl, tc, pack_rows(m, c, o, v), tile_size,
            -(-image_width // tile_size), chunk=chunk, alpha_clip=alpha_clip,
            min_alpha=min_alpha)
    out = _untile(out, v.shape[-1], image_height, image_width, tile_size)
    return out[0] if squeeze else out

"""Tile binning for the surfel rasterizer (port of envgs_tpu/ops/binning.py,
render layout).

Splats are depth-sorted once (index order == blend order), expanded into
(splat, tile) pairs over their snug AABB, pairs outside the splat's per-row
alpha-floor footprint are retargeted to the sentinel tile, and one sort by
(tile, depth rank) orders the pairs. Only the unaligned render layout is
ported: the chunk-aligned training layout needs the fill-forward kernel
(K5) and arrives with the train step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import PreparedSplats, snug_row_interval

LANES = 128
BROWS = 256
_ALIGN_N = LANES * BROWS  # pair-cap granularity of the JAX layout


class BinnedPairs(NamedTuple):
    gauss_idx: torch.Tensor  # (pair_cap + align,) int32 depth-order splat
    #   per pair, sentinel P past each tile's range and in the tail
    order: torch.Tensor  # (P,) int64 depth order -> pool index
    tile_bounds: torch.Tensor  # (num_tiles + 1,) int32 pair range offsets
    num_pairs: torch.Tensor  # () int32 requested pairs (before the cap)
    tiles_x: int
    tiles_y: int
    tile: int


def tile_dims(H: int, W: int, tile: int):
    return -(-W // tile), -(-H // tile)


def _round_up(n, m):
    return -(-n // m) * m


def tile_stable_sort(tid: torch.Tensor, gid: torch.Tensor, P: int):
    """Sort (tid, gid) pairs tile-major keeping gid order within a tile.

    gid is non-decreasing along the input, so the stable order by tid is
    the order by the packed key (tid << gbits | gid). The key is built in
    int64, which needs none of the sign-bit trick the JAX package plays to
    fit it into int32; equal keys are equal pairs, so the order is the
    JAX package's order exactly."""
    gbits = max(int(P).bit_length(), 1)
    key = (tid.to(torch.int64) << gbits) | gid.to(torch.int64)
    key_s = torch.sort(key).values
    return (key_s >> gbits).to(torch.int32), (key_s & ((1 << gbits) - 1)).to(torch.int32)


def bin_splats(
    prep: PreparedSplats, H: int, W: int, tile: int, pair_cap: int,
    align: int = 64, lowpass_r: float = 0.0, aligned: bool = False,
) -> BinnedPairs:
    """Expand splats into (splat, tile) pairs sorted by (tile, depth).

    Pairs beyond `pair_cap` (rounded up to the JAX layout's granularity)
    drop deterministically, farthest splats first; `num_pairs` reports the
    count before the cap."""
    if aligned:
        raise NotImplementedError(
            "the chunk-aligned training layout needs the fill-forward "
            "kernel (K5); it is ported with the train-step slice")
    dev = prep.depth.device
    tx_n, ty_n = tile_dims(H, W, tile)
    num_tiles = tx_n * ty_n
    P = prep.depth.shape[0]
    pair_cap = _round_up(pair_cap, _ALIGN_N)

    # ---- depth-sort the splats (index order becomes blend order) ----
    key = torch.where(prep.valid, prep.depth,
                      torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    cx, cy = prep.center_pix[order, 0], prep.center_pix[order, 1]
    rx, ry = prep.ext[order, 0], prep.ext[order, 1]
    valid = prep.valid[order]
    rowcull = prep.rowcull[order]

    def tcoord(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    x0 = tcoord(cx - rx, tx_n - 1)
    x1 = tcoord(cx + rx, tx_n - 1)
    y0 = tcoord(cy - ry, ty_n - 1)
    y1 = tcoord(cy + ry, ty_n - 1)
    zero = torch.zeros_like(x0)
    nx = torch.where(valid, x1 - x0 + 1, zero)
    ny = torch.where(valid & (y1 >= y0), y1 - y0 + 1, zero)
    counts = nx * ny
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts
    total = ends[-1] if P > 0 else torch.zeros((), dtype=torch.int32,
                                                device=dev)

    # ---- broadcast per-splat values to pair slots: the splat id at each
    # run start, a running max (ids ascend in depth order), one gather.
    # Slot `pair_cap` is a spare that takes the starts beyond the cap. ----
    sel = counts > 0
    pos = torch.where(sel, starts, torch.full_like(starts, pair_cap))
    pos = torch.clamp(pos, max=pair_cap).to(torch.int64)
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    sid = torch.zeros(pair_cap + 1, dtype=torch.int32, device=dev)
    sid[pos] = ids
    gid = torch.cummax(sid[:pair_cap], 0).values.to(torch.int64)
    start_s = starts[gid]
    t0_s = (y0 * tx_n + x0)[gid]
    nx_s = torch.clamp(nx, min=1)[gid]

    slots = torch.arange(pair_cap, dtype=torch.int32, device=dev)
    in_range = slots < torch.clamp(total, max=pair_cap)
    k = slots - start_s  # >= 0: every slot lies at or past its run start
    ty_s = t0_s // tx_n + k // nx_s
    xt_s = t0_s % tx_n + k % nx_s
    sentinel = torch.full_like(slots, num_tiles)
    tid = torch.where(in_range, ty_s * tx_n + xt_s, sentinel)
    # row-cull: retarget pairs outside the per-row footprint interval
    ctr = torch.stack([cx, cy], dim=-1)[gid]
    yb0 = (ty_s * tile).to(torch.float32)
    yb1 = yb0 + (tile - 1)
    x_lo, x_hi = snug_row_interval(ctr, rowcull[gid], yb0, yb1, lowpass_r)
    xt_f = xt_s.to(torch.float32) * tile
    keep = (xt_f + (tile - 1) >= x_lo) & (xt_f <= x_hi)
    tid = torch.where(keep, tid, sentinel)

    tid_s, gauss_s = tile_stable_sort(tid, gid.to(torch.int32), P)
    bounds = torch.searchsorted(
        tid_s, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    gauss_pad = torch.cat(
        [gauss_s, torch.full((align,), P, dtype=torch.int32, device=dev)])
    return BinnedPairs(
        gauss_idx=gauss_pad,
        order=order,
        tile_bounds=bounds,
        num_pairs=total.to(torch.int32),
        tiles_x=tx_n,
        tiles_y=ty_n,
        tile=tile,
    )

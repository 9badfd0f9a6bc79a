"""Tile binning for the surfel rasterizer (port of envgs_tpu/ops/binning.py).

Splats are depth-sorted once (index order == blend order), expanded into
(splat, tile) pairs over their snug AABB, pairs outside the splat's per-row
alpha-floor footprint are retargeted to the sentinel tile, and one sort by
(tile, depth rank) orders the pairs. Two layouts:

- unaligned (render): raw per-tile pair ranges, the blend masks each
  window's rows outside its tile;
- aligned (training): each tile's range padded to a multiple of `align`
  (padding -> sentinel P), built with the fill-forward kernel K5 and one
  near-identity gather, as the JAX package builds it.

The JAX training layout also carries a pre-sort transpose plan (`pre_idx`,
`seg_starts`, `seg_counts`) for its pair-gradient transpose
(segsum.presort_transpose). The port's backward kernels add each pair's
gradient row straight into the per-splat table with atomics, so the plan
is not built; without it the pre-sort slot payload of the JAX sort is not
needed either (it does not change the order of the splat indices).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import PreparedSplats, snug_row_interval
from envgs_tpu_torch.ops.fill_forward import fill_forward
from envgs_tpu_torch.utils.timer import count, span

LANES = 128
BROWS = 256
_ALIGN_N = LANES * BROWS  # pair-cap granularity of the JAX layout


class BinnedPairs(NamedTuple):
    gauss_idx: torch.Tensor  # int32 depth-order splat per pair slot,
    #   sentinel P in padding: (pair_cap + align,) unaligned, (cap_aligned,)
    #   aligned
    order: torch.Tensor  # (P,) int64 depth order -> pool index
    tile_bounds: torch.Tensor  # (num_tiles + 1,) int32 pair range offsets
    #   (multiples of `align` in the aligned layout)
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
    row_window: tuple | None = None,
) -> BinnedPairs:
    """Expand splats into (splat, tile) pairs sorted by (tile, depth); with
    `aligned`, each tile's range is padded to a multiple of `align`.

    Pairs beyond `pair_cap` (rounded up to the JAX layout's granularity)
    drop deterministically, farthest splats first; `num_pairs` reports the
    count before the cap.

    row_window = (ty0, n_tile_rows): bin only the tiles of one horizontal
    band of tile rows, with band-local tile ids (the band row-crop: `prep`
    comes from the full camera, so every float is the full image's; the
    band is integer tile arithmetic alone)."""
    with span("render.bin"):
        dev = prep.depth.device
        tx_n, ty_full = tile_dims(H, W, tile)
        ty0, ty_n = (0, ty_full) if row_window is None else row_window
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
        y0 = tcoord(cy - ry, ty_full - 1)
        y1 = tcoord(cy + ry, ty_full - 1)
        if row_window is not None:  # the tile-row span clipped to the band
            y0 = torch.clamp(y0, min=ty0) - ty0
            y1 = torch.clamp(y1, max=ty0 + ty_n - 1) - ty0
        zero = torch.zeros_like(x0)
        nx = torch.where(valid, x1 - x0 + 1, zero)
        ny = torch.where(valid & (y1 >= y0), y1 - y0 + 1, zero)
        counts = nx * ny
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        starts = ends - counts
        total = ends[-1] if P > 0 else torch.zeros((), dtype=torch.int32,
                                                    device=dev)
        count("bin.pairs", total)
        count("bin.slots", pair_cap)

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
        yb0 = ((ty_s + ty0) * tile).to(torch.float32)  # global pixel rows
        yb1 = yb0 + (tile - 1)
        x_lo, x_hi = snug_row_interval(ctr, rowcull[gid], yb0, yb1, lowpass_r)
        xt_f = xt_s.to(torch.float32) * tile
        keep = (xt_f + (tile - 1) >= x_lo) & (xt_f <= x_hi)
        tid = torch.where(keep, tid, sentinel)

        tid_s, gauss_s = tile_stable_sort(tid, gid.to(torch.int32), P)
        bounds = torch.searchsorted(
            tid_s, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
            side="left").to(torch.int32)
        # the pairs the blend reads: those the row cull and the cap left
        count("bin.kept", bounds, at=-1)
        if aligned:
            gauss_idx, bounds = _align_tiles(gauss_s, bounds, P, pair_cap,
                                             num_tiles, align)
        else:
            # one sentinel window of padding absorbs the last tile's overrun
            gauss_idx = torch.cat(
                [gauss_s, torch.full((align,), P, dtype=torch.int32,
                                     device=dev)])
        return BinnedPairs(
            gauss_idx=gauss_idx,
            order=order,
            tile_bounds=bounds,
            num_pairs=total.to(torch.int32),
            tiles_x=tx_n,
            tiles_y=ty_n,
            tile=tile,
        )


def aligned_markers(bounds: torch.Tensor, pair_cap: int, num_tiles: int,
                    align: int):
    """The fill-forward input of the aligned layout: (marks (3, cap_aligned)
    int32, valid (cap_aligned,) int32, poffs (T+1,) int32). Each tile's
    marker (source start, aligned start, source end) sits at its aligned
    start; empty tiles share an aligned start with the next tile, and the
    scatter keeps the largest marker there (the last such tile's), as the
    JAX package's scatter-max does. pair_cap: the rounded cap of the
    sorted pairs."""
    dev = bounds.device
    counts = bounds[1:] - bounds[:-1]
    padded = (counts + (align - 1)) // align * align
    poffs = torch.cat([bounds.new_zeros(1),
                       torch.cumsum(padded, 0, dtype=torch.int32)])
    cap_aligned = _round_up(pair_cap + num_tiles * align, _ALIGN_N)
    at = poffs[:-1].to(torch.int64)
    marks = torch.zeros((3, cap_aligned), dtype=torch.int32, device=dev)
    marks.scatter_reduce_(1, at.expand(3, -1),
                          torch.stack([bounds[:-1], poffs[:-1], bounds[1:]]),
                          reduce="amax")
    valid = torch.zeros(cap_aligned, dtype=torch.int32, device=dev)
    valid[at] = 1
    return marks, valid, poffs


def _align_tiles(gauss_s: torch.Tensor, bounds: torch.Tensor, P: int,
                 pair_cap: int, num_tiles: int, align: int):
    """Chunk-aligned layout: (gauss_idx (cap_aligned,), poffs (T+1,)):
    fill-forward (K5) broadcasts each tile's marker over its aligned slots,
    and one near-identity gather reads the sorted pairs."""
    marks, valid, poffs = aligned_markers(bounds, pair_cap, num_tiles, align)
    tstart, pstart, limit = fill_forward(marks, valid)
    j = torch.arange(marks.shape[1], dtype=torch.int32, device=bounds.device)
    src = tstart + (j - pstart)
    valid_dst = src < limit
    src = torch.where(valid_dst, torch.clamp(src, 0, pair_cap - 1), 0)
    gauss_idx = torch.where(valid_dst, gauss_s[src.to(torch.int64)], P)
    return gauss_idx.to(torch.int32), poffs

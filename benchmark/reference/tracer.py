"""The env pass of EnvGS in plain PyTorch: 2D Gaussian surfels traced along
a grid of rays (the rays reflected off the base pass), written from the
definitions, with its own uncapped cull.

Semantics (EnvGS, Xie et al. 2024, as the repository defines them):
- a surfel of centre p, rotation R (tangents t_u, t_v, normal n) and
  scales s_u, s_v is hit by the ray o + t d where the ray meets its plane,
  at local coordinates (u, v) = ((x - p).t_u / s_u, (x - p).t_v / s_v);
  alpha = min(0.99, opacity exp(-(u^2 + v^2) / 2)), kept from 1/255, for
  t > 1e-4 and |d.n| >= 1e-9;
- the image is cut into 16x16 tiles of rays (edge-padded); each tile's
  rays form a cone: its apex the mean origin, its axis the mean unit
  direction, its half-angle the widest ray's, thickened by the origins'
  largest distance from the apex;
- a tile keeps every surfel that one of its rays meets with alpha at or
  above the floor (the blend's own test, `trace_blend._ray_terms`): no
  chunks and no cap, so nothing a ray of the tile can take is left out,
  and nothing is kept that none can. It finds them among the surfels
  whose 3-sigma bounding sphere (radius 3 max(s_u, s_v), the extent the
  repository's cull gives a surfel) meets that thickened cone;
- each tile blends its kept surfels front to back in the order of their
  centres' distance from the apex (ties in pool order), in 64-slot chunks
  (`trace_blend.py`, the frozen K3 and K4). That per-tile order is the
  repository's documented blend order; the published tracer (OptiX) blends
  each ray's hits in its own depth order, which this reference, like the
  program, departs from.

The cone test runs `BLOCK_ELEMS` (tile, surfel) tests at a time, the ray
test `BLOCK_ELEMS` (ray, surfel) tests at a time over tiles of similar
list lengths.
"""
from __future__ import annotations

import torch

from benchmark.reference.geometry import rotation
from benchmark.reference.raster_blend import CHUNK, LO
from benchmark.reference.trace_blend import (
    _ray_terms,
    rows,
    trace_blend_train,
)

TILE = 16
BLOCK_ELEMS = 1 << 25  # (tile or ray, surfel) tests of one cull block


def ray_tiles(o: torch.Tensor, d: torch.Tensor):
    """(H, W, 3) origins and directions -> ((T, 8, 256) ray tiles, rows ox
    oy oz dx dy dz 0 0, the image edge-padded to whole tiles; tiles_x,
    tiles_y). Differentiable in both."""
    H, W = o.shape[:2]
    ty, tx = -(-H // TILE), -(-W // TILE)
    r = torch.clamp(torch.arange(ty * TILE, device=o.device), max=H - 1)
    c = torch.clamp(torch.arange(tx * TILE, device=o.device), max=W - 1)
    od = torch.cat([o, d], -1)[r][:, c]
    planes = (od.reshape(ty, TILE, tx, TILE, 6).permute(0, 2, 4, 1, 3)
              .reshape(ty * tx, 6, TILE * TILE))
    return torch.cat([planes, planes.new_zeros((ty * tx, 2, TILE * TILE))],
                     1), tx, ty


def cones(rays: torch.Tensor):
    """Each tile's cone of rays -> (apex (T, 3), axis (T, 3), cos and sin
    of the half-angle (T,), spread (T,): the origins' largest distance
    from the apex)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    u = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    apex = o.mean(-1)
    axis = u.mean(-1)
    axis = axis / torch.linalg.vector_norm(axis, dim=1, keepdim=True)
    cos = torch.clamp((u * axis[..., None]).sum(1).amin(-1), -1.0, 1.0)
    sin = torch.sqrt(1.0 - cos * cos)
    spread = torch.linalg.vector_norm(o - apex[..., None], dim=1).amax(-1)
    return apex, axis, cos, sin, spread


def cone_pairs(rays: torch.Tensor, mean: torch.Tensor,
               radius: torch.Tensor):
    """Every (tile, surfel) whose bounding sphere meets the tile's
    thickened cone -> (tile (N,), surfel (N,), distance from the tile's
    apex (N,)).

    A point at distance L from the apex, at angle phi from the axis, lies
    L sin(phi - theta) from a cone of half-angle theta where theta < phi <=
    theta + 90 degrees, on it below, and L from its apex beyond."""
    T, P = rays.shape[0], mean.shape[0]
    apex, axis, cos, sin, spread = cones(rays)
    B = max(1, BLOCK_ELEMS // max(P, 1))
    tiles, surfels, keys = [], [], []
    for b0 in range(0, T, B):
        sl = slice(b0, min(b0 + B, T))
        v = [mean[None, :, i] - apex[sl, i, None] for i in range(3)]
        proj = sum(v[i] * axis[sl, i, None] for i in range(3))
        L = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
        off = torch.sqrt(torch.clamp(L * L - proj * proj, min=0.0))
        s = off * cos[sl, None] - proj * sin[sl, None]
        c = proj * cos[sl, None] + off * sin[sl, None]
        dist = torch.where(s <= 0, 0.0, torch.where(c >= 0, s, L))
        t, p = torch.nonzero(dist <= spread[sl, None] + radius[None, :],
                             as_tuple=True)
        tiles.append(t + b0)
        surfels.append(p)
        keys.append(L[t, p])
    return tuple(torch.cat(x) for x in (tiles, surfels, keys))


def met_by_a_ray(rays: torch.Tensor, table: torch.Tensor, tile, surfel):
    """(N,) bool: whether any ray of the pair's tile meets the pair's
    surfel with alpha at or above the floor (t > T_MIN, |d.n| >= 1e-9),
    by the blend's own terms. `tile` sorted; tiles go through in blocks
    of similar pair counts."""
    T, R = rays.shape[0], rays.shape[-1]
    count = torch.bincount(tile, minlength=T)
    start = torch.cumsum(count, 0) - count
    order = torch.argsort(count).tolist()
    counts = count.tolist()
    met = torch.zeros(tile.numel(), dtype=torch.bool, device=tile.device)
    i = 0
    while i < T:
        j = i + 1
        while j < T and (j + 1 - i) * max(counts[order[j]], 1) * R \
                <= BLOCK_ELEMS:
            j += 1
        blk = torch.tensor(order[i:j], device=tile.device)
        k = torch.arange(max(counts[order[j - 1]], 1), device=tile.device)
        live = k[None] < count[blk, None]
        at = torch.clamp(start[blk, None] + k[None], max=tile.numel() - 1)
        col = table[torch.where(live, surfel[at], table.shape[0] - 1)]
        s = _ray_terms([col[..., c, None] for c in range(col.shape[-1])],
                       [rays[blk, c, None, :] for c in range(6)])
        met[at[s["amask"].any(-1) & live]] = True
        i = j
    return met


def cull(rays: torch.Tensor, table: torch.Tensor, radius: torch.Tensor):
    """The surfels some ray of each tile meets (module docstring), by
    tile, then distance from the tile's apex -> (slots (S,) int32 surfel
    indices, each tile's range whole CHUNK-slot chunks padded with the
    sentinel P, bounds (T + 1,) int32)."""
    T, P = rays.shape[0], table.shape[0] - 1
    dev = table.device
    tile, surfel, key = cone_pairs(rays, table[:P, :3], radius)
    o = torch.argsort(tile, stable=True)
    tile, surfel, key = tile[o], surfel[o], key[o]
    keep = met_by_a_ray(rays, table, tile, surfel)
    tile, surfel, key = tile[keep], surfel[keep], key[keep]
    o = torch.argsort(key, stable=True)
    o = o[torch.argsort(tile[o], stable=True)]
    tile, surfel = tile[o], surfel[o]
    count = torch.bincount(tile, minlength=T)
    padded = (count + CHUNK - 1) // CHUNK * CHUNK
    bounds = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    first = torch.cumsum(count, 0) - count
    at = bounds[tile] + torch.arange(tile.numel(), device=dev) - first[tile]
    slots = torch.full((int(bounds[-1]) + CHUNK,), P, dtype=torch.int32,
                       device=dev)
    slots[at] = surfel.to(torch.int32)
    return slots, bounds.to(torch.int32)


def scene_table(xyz, quat, scale2, opacity, colors) -> torch.Tensor:
    """(P + 1, LO) per-surfel table in the traced blend's columns: centre,
    t_u / s_u, t_v / s_v, normal, opacity, colour; the last row the zero
    sentinel. Differentiable in every input."""
    Rm = rotation(quat)
    table = torch.cat([xyz, Rm[..., 0] / scale2[:, :1],
                       Rm[..., 1] / scale2[:, 1:], Rm[..., 2],
                       opacity[:, None], colors], 1)
    return torch.nn.functional.pad(table, (0, LO - table.shape[1], 0, 1))


def trace(xyz, quat, scale2, opacity, colors, o, d) -> dict:
    """Trace the surfels along the rays o, d (H, W, 3) -> {rgb (H, W, 3),
    acc, depth (the ray parameter, acc-normalised)}, differentiable in the
    surfels and the rays (the blend's through K4's plain version); rays
    that meet nothing are black."""
    H, W = o.shape[:2]
    rays, tx, ty = ray_tiles(o, d)
    table = scene_table(xyz, quat, scale2, opacity, colors)
    with torch.no_grad():
        slots, bounds = cull(rays.detach(), table.detach(),
                             3.0 * scale2.detach().amax(1))
    planes = trace_blend_train(table, rays, slots, bounds, tx,
                               ty)[:, :H, :W]
    r = rows(0)
    acc = planes[r["acc"]]
    return dict(rgb=planes[r["color"]:r["color"] + 3].permute(1, 2, 0),
                acc=acc, depth=torch.where(acc > 1e-8, planes[r["dpt"]]
                                           / torch.clamp(acc, min=1e-8), 0.0))

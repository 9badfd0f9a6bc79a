"""The base pass of EnvGS in plain PyTorch: 2D Gaussian surfels projected
to the screen, binned to 16x16 tiles and blended front to back.

Semantics (2DGS, Huang et al. 2024, as the repository defines them):
- a surfel of centre p, rotation R (tangents t_u, t_v, normal t_w) and
  scales s_u, s_v is the plane patch p + u s_u t_u + v s_v t_v; the
  pixel matrix M maps it to homogeneous screen points H (u, v, 1), H the
  3x3 "screen transform" whose rows give x w, y w and w;
- its screen footprint is the 3-sigma ellipse u^2 + v^2 = 9 seen through
  H; the box around it is read off the dual conic H diag(9, 9, -1) H^T,
  each half-width at least the 2D low-pass filter's 3-sigma radius
  3 / sqrt(2) and rounded up to whole pixels;
- a surfel is drawn where its view depth exceeds the near plane 0.2, the
  ellipse is proper and its box meets the image;
- it reaches every pixel of every tile that its box overlaps, in view-
  depth order (ties in pool order); the blend itself, K1's plain version
  (`raster_blend.py`), evaluates the response at each pixel and keeps the
  blend rule of the model (alpha = min(0.99, o G) from 1/255, a pixel done
  once T (1 - alpha) < 1e-4, 64-pair windows from each tile's start).

The pair list is built here from those rules alone: every (tile, surfel)
of every box, sorted by tile, then depth. It is not the program's binning,
which keeps fewer pairs (a tighter per-row footprint) in another layout.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.geometry import Cam, rotation, sh_colors
from benchmark.reference.raster_blend import (
    CHUNK,
    LO,
    TILE,
    blend_tiles_train,
    rows,
)

NEAR = 0.2  # the near plane of the splats' view depth
LOWPASS_R = 3.0 / math.sqrt(2.0)  # 3 sigma of the 2D low-pass filter


def tiles_of(H: int, W: int):
    return -(-W // TILE), -(-H // TILE)


def screen_transform(xyz, quat, scale2, cam: Cam) -> torch.Tensor:
    """(P, 3, 3) H: columns s_u M t_u, s_v M t_v, M p (M the camera's
    pixel matrix)."""
    Rm = rotation(quat)
    M = cam.pixel_matrix()
    A, b = M[:, :3], M[:, 3]
    col_u = (Rm[..., 0] * scale2[:, :1]) @ A.T
    col_v = (Rm[..., 1] * scale2[:, 1:]) @ A.T
    col_1 = xyz @ A.T + b
    return torch.stack([col_u, col_v, col_1], -1)


def footprint(Hm: torch.Tensor, H: int, W: int):
    """-> (centre (P, 2), half-widths (P, 2) in whole pixels, drawn (P,)),
    the box of the 3-sigma ellipse from the dual conic."""
    D = Hm.new_tensor([9.0, 9.0, -1.0])
    dual = torch.einsum("pik,k,pjk->pij", Hm, D, Hm)
    d = dual[:, 2, 2]
    ds = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
    c = torch.stack([dual[:, 0, 2], dual[:, 1, 2]], -1) / ds[:, None]
    diag = torch.stack([dual[:, 0, 0], dual[:, 1, 1]], -1) / ds[:, None]
    half = torch.sqrt(torch.clamp(c * c - diag, min=1e-4))
    drawn = ((Hm[:, 2, 2] > NEAR) & (d < 0)
             & (c[:, 0] + half[:, 0] >= 0) & (c[:, 0] - half[:, 0] <= W - 1)
             & (c[:, 1] + half[:, 1] >= 0) & (c[:, 1] - half[:, 1] <= H - 1))
    return c, torch.ceil(torch.clamp(half, min=LOWPASS_R)), drawn


def tile_box(c, half, tx: int, ty: int):
    """(x0, x1, y0, y1) tile ranges of each box, clamped into the image."""
    lo = torch.floor((c - half) / TILE)
    hi = torch.floor((c + half) / TILE)
    top = c.new_tensor([tx - 1, ty - 1])
    lo = torch.minimum(torch.clamp(lo, min=0), top).long()
    hi = torch.minimum(torch.clamp(hi, min=0), top).long()
    return lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]


def bin_pairs(depth, drawn, box, tx: int, ty: int):
    """Every (tile, splat) of the boxes, by tile, then depth (ties in pool
    order) -> (order (P,) depth rank -> pool index, slots (S,) int32 depth
    ranks with the sentinel P, bounds (tiles + 1,) int32). Each tile's
    range starts at a multiple of CHUNK, the rest of its last window the
    sentinel."""
    P = depth.shape[0]
    dev = depth.device
    order = torch.argsort(torch.where(drawn, depth, float("inf")),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=dev)
    x0, x1, y0, y1 = box
    nx = x1 - x0 + 1
    n = torch.where(drawn, nx * (y1 - y0 + 1), 0)
    splat = torch.repeat_interleave(torch.arange(P, device=dev), n)
    k = torch.arange(splat.numel(), device=dev) - (torch.cumsum(n, 0)
                                                   - n)[splat]
    tile = (y0[splat] + k // nx[splat]) * tx + x0[splat] + k % nx[splat]
    key = torch.sort(tile * P + rank[splat]).values
    tile, r = key // P, key % P
    count = torch.bincount(tile, minlength=tx * ty)
    padded = (count + CHUNK - 1) // CHUNK * CHUNK
    bounds = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    first = torch.cumsum(count, 0) - count
    at = bounds[tile] + torch.arange(tile.numel(), device=dev) - first[tile]
    slots = torch.full((int(bounds[-1]) + CHUNK,), P, dtype=torch.int32,
                       device=dev)
    slots[at] = r.to(torch.int32)
    return order, slots, bounds.to(torch.int32)


def render(xyz, quat, scale2, opacity, colors, cam: Cam):
    """Rasterize the surfels -> dict of (H, W) maps: `color` (H, W, C),
    `depth` (alpha-weighted view depth), `alpha`, `normal` (view space,
    alpha-weighted, each surfel's normal turned to the camera),
    differentiable in every input (the blend's through K2's plain
    version)."""
    H, W = cam.H, cam.W
    tx, ty = tiles_of(H, W)
    P, C = xyz.shape[0], colors.shape[1]
    Hm = screen_transform(xyz, quat, scale2, cam)
    centre, half, drawn = footprint(Hm, H, W)
    with torch.no_grad():
        order, slots, bounds = bin_pairs(
            Hm[:, 2, 2], drawn, tile_box(centre, half, tx, ty), tx, ty)
    n_view = rotation(quat)[..., 2] @ cam.R.T
    facing = torch.where((cam.to_view(xyz) * n_view).sum(-1, keepdim=True)
                         > 0, -1.0, 1.0)
    table = torch.cat([Hm.reshape(P, 9), centre,
                       (opacity * drawn)[:, None], n_view * facing, colors],
                      1)[order]
    table = torch.nn.functional.pad(table, (0, LO - table.shape[1], 0, 1))
    img, _ = blend_tiles_train(table, None, slots, bounds, C, tx, ty)
    img, r = img[:, :H, :W], rows(C)
    return dict(color=img[:C].permute(1, 2, 0), depth=img[r["depth"]],
                alpha=img[r["alpha"]],
                normal=img[r["normal"]:r["normal"] + 3].permute(1, 2, 0))


def depth_normals(cam: Cam, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world normal of the depth map's surface: the cross
    product of the central differences of its points, back-projected
    through pixel (i, j) at (j, i) in K's frame; zero on the border."""
    pts = cam.center + depth[..., None] * cam.pixel_directions(0.0)
    n = torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1],
                           pts[1:-1, 2:] - pts[1:-1, :-2])
    n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-16)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def base_pass(pool: dict, cam: Cam, degree: int) -> dict:
    """EnvGS's base pass: the rasterized surfels with rgb, specular and
    roughness channels, decoded -> rgb, spec, alpha, depth (the
    alpha-normalised view depth), normal (world, alpha-weighted),
    surf_normal (the depth map's normal times alpha)."""
    sh = torch.cat([pool["features_dc"], pool["features_rest"]], 1)
    colors = torch.cat([
        sh_colors(sh, pool["xyz"], cam.center, degree),
        torch.sigmoid(pool["specular"]), torch.sigmoid(pool["roughness"])],
        1)
    m = render(pool["xyz"], pool["rotation"], torch.exp(pool["scaling"]),
               torch.sigmoid(pool["opacity"][:, 0]), colors, cam)
    alpha = m["alpha"]
    depth = torch.nan_to_num(
        m["depth"] / torch.where(alpha == 0, torch.ones_like(alpha), alpha))
    return dict(rgb=m["color"][..., :3], spec=m["color"][..., 3:4],
                alpha=alpha[..., None], depth=depth[..., None],
                normal=m["normal"] @ cam.R,
                surf_normal=depth_normals(cam, depth)
                * alpha.detach()[..., None])


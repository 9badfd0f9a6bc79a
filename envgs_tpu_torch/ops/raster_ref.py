"""Reference 2D-surfel rasterizer in plain PyTorch, exact and slow (port of
envgs_tpu/ops/raster_ref.py): the raw output container and
`rasterize_reference`, the oracle the `ref` raster backend runs.

A depth-ordered walk over every splat with full-image accumulators, the
reference CUDA pipeline's per-pixel blend loop:

  rgb      = sum_i w_i c_i + T_final * bg
  depth_e  = sum_i w_i z_i                (premultiplied by alpha)
  alpha    = sum_i w_i
  normal   = sum_i w_i n_i                (view space, unnormalized)
  depth_m  = z of the last contributor with T > 0.5
  dist     = the 2DGS distortion accumulator
  wet      = per-splat sum over pixels of w_i

with w_i = alpha_i T_i, T_{i+1} = T_i (1 - alpha_i), alpha_i =
min(0.99, o_i G_i), skipping alpha < 1/255, and a pixel done for good
once T (1 - alpha) < 1e-4. Differentiable by autograd; O(P H W), for small
scenes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import (
    ALPHA_MAX,
    ALPHA_MIN,
    NEAR_PLANE,
    T_CUTOFF,
    PreparedSplats,
    map_depth,
    splat_response,
)
from envgs_tpu_torch.utils.camera import Camera

TILE = 16  # the tile kernel's tile: a splat reaches the pixels of the tiles
#            its AABB overlaps


class RasterOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, C) includes the bg blend
    depth_expected: torch.Tensor  # (H, W) premultiplied by alpha
    alpha: torch.Tensor  # (H, W)
    normal: torch.Tensor  # (H, W, 3) view space, unnormalized
    depth_median: torch.Tensor  # (H, W) zeros on the render path, detached
    distortion: torch.Tensor  # (H, W) zeros on the render path
    wet: torch.Tensor  # (P,) zeros (training: wet is the wet_zero gradient)
    radii: torch.Tensor  # (P,) screen radii (0 = culled)
    trans: torch.Tensor  # (H, W) final transmittance
    num_pairs: torch.Tensor | None = None  # () requested (splat, tile) pairs
    #   before the pair_cap clamp (num_pairs > pair_cap: far splats dropped;
    #   None on the reference rasterizer, which has no pair budget)
    d1: torch.Tensor | None = None  # (H, W) sum w m, training path only
    d2: torch.Tensor | None = None  # (H, W) sum w m^2, training path only


def tile_window(center, ext, px, py, ntx, nty):
    """Whether each pixel's 16-pixel tile lies in the tile range of the
    AABB center +- ext of one splat, both ends clamped into the image's
    tiles."""
    top = center.new_tensor([ntx - 1.0, nty - 1.0])
    lo = torch.clamp(torch.floor((center - ext) / TILE), min=0.0)
    hi = torch.clamp(torch.floor((center + ext) / TILE), min=0.0)
    lo, hi = torch.minimum(lo, top), torch.minimum(hi, top)
    tpx, tpy = torch.floor(px / TILE), torch.floor(py / TILE)
    return (tpx >= lo[0]) & (tpx <= hi[0]) & (tpy >= lo[1]) & (tpy <= hi[1])


def rasterize_reference(prep: PreparedSplats, cam: Camera,
                        bg_color: torch.Tensor) -> RasterOutput:
    """Rasterize prepared splats, every valid splat in view-depth order (a
    global order gives each pixel the per-tile sorted sequence)."""
    P = prep.depth.shape[0]
    H, W = cam.H, cam.W
    C = prep.color.shape[-1]
    dev = prep.depth.device
    order = torch.argsort(torch.where(prep.valid, prep.depth, float("inf")),
                          stable=True)
    n_valid = int(prep.valid.sum())
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    ntx, nty = -(-W // TILE), -(-H // TILE)
    zeros = lambda *s: torch.zeros((H, W) + s, device=dev)  # noqa: E731
    T = torch.ones((H, W), device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    acc_rgb, acc_n = zeros(C), zeros(3)
    acc_d, acc_a, med, dist, d1, d2 = (zeros() for _ in range(6))
    wet_sorted = []
    for i in order[:n_valid].tolist():  # invalid splats take no pixel
        G, z = splat_response(prep.tmat[i], prep.center_pix[i], px, py)
        inside = tile_window(prep.center_pix[i], prep.ext[i], px, py, ntx,
                             nty)
        alpha = torch.clamp(prep.opacity[i] * G, max=ALPHA_MAX)
        live = inside & (alpha >= ALPHA_MIN) & (z >= NEAR_PLANE) & ~done
        test_T = T * (1.0 - alpha)
        kill = live & (test_T < T_CUTOFF)
        done = done | kill
        contrib = live & ~kill
        w = torch.where(contrib, alpha * T, 0.0)
        m = map_depth(z)
        # 2DGS distortion: m_i^2 A + D2 - 2 m_i D1 before the update
        dist = dist + w * (m * m * acc_a + d2 - 2.0 * m * d1)
        d1 = d1 + w * m
        d2 = d2 + w * m * m
        acc_rgb = acc_rgb + w[..., None] * prep.color[i]
        acc_d = acc_d + w * z
        acc_a = acc_a + w
        acc_n = acc_n + w[..., None] * prep.normal[i]
        med = torch.where(contrib & (T > 0.5), z, med)
        T = torch.where(contrib, test_T, T)
        wet_sorted.append(w.sum())
    wet = torch.zeros(P, device=dev)
    if wet_sorted:
        wet = wet.index_put((order[:n_valid],), torch.stack(wet_sorted))
    bg = torch.zeros(C, device=dev)
    bg[: bg_color.shape[0]] = bg_color
    return RasterOutput(
        rgb=acc_rgb + T[..., None] * bg,
        depth_expected=acc_d,
        alpha=acc_a,
        normal=acc_n,
        depth_median=med,
        distortion=dist,
        wet=wet,
        radii=prep.radius,
        trans=T,
        d1=d1,
        d2=d2,
    )

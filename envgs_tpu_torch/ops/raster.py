"""Rasterizer API (port of envgs_tpu/ops/raster.py, render path).

`rasterize` runs binning (unaligned render layout) and the tile blend —
kernel K1 on CUDA tensors, its plain PyTorch version on CPU tensors — and
decodes to the JAX package's RasterOutput contract. The training outputs
(distortion, median depth, per-splat wet) and their autodiff arrive with
the train-step slice: asking for them raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.binning import bin_splats
from envgs_tpu_torch.ops.common import ROWCULL_LOWPASS_R, PreparedSplats
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    TILE,
    blend_tiles,
    out_rows,
)
from envgs_tpu_torch.ops.raster_ref import RasterOutput
from envgs_tpu_torch.utils.camera import Camera


def _pack_table(prep: PreparedSplats,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-splat packed table (P+1, LO) f32, last row the zero sentinel;
    with `order`, rows are permuted once to the depth-sorted splat order
    (the binning contract)."""
    P = prep.depth.shape[0]
    packed = torch.cat(
        [
            prep.tmat.reshape(P, 9),
            prep.center_pix,
            (prep.opacity * prep.valid)[:, None],
            prep.normal,
            prep.color,
        ],
        dim=1,
    )
    if order is not None:
        packed = packed[order]
    return torch.nn.functional.pad(packed, (0, LO - packed.shape[1], 0, 1))


def rasterize(
    prep: PreparedSplats,
    cam: Camera,
    bg_color: torch.Tensor,
    pair_cap: int = 2 ** 21,
    needs: tuple = (False, False, False),
) -> RasterOutput:
    """Rasterize prepared splats into the raw output maps (render path:
    needs = (need_dist, need_med, need_wet) all False)."""
    if any(needs):
        raise NotImplementedError(
            f"rasterize needs={needs}: distortion, median depth and wet are "
            "training outputs, ported with the train-step slice")
    C = prep.color.shape[-1]
    H, W = cam.H, cam.W
    bins = bin_splats(prep, H, W, TILE, pair_cap, align=CHUNK,
                      lowpass_r=ROWCULL_LOWPASS_R, aligned=False)
    packed = _pack_table(prep, bins.order)
    img = blend_tiles(packed, bins.gauss_idx, bins.tile_bounds, C,
                      bins.tiles_x, bins.tiles_y)[:, :H, :W]
    r = out_rows(C)
    trans = img[r["trans"]]
    bg = torch.zeros(C, dtype=torch.float32, device=img.device)
    bg[: bg_color.shape[0]] = bg_color
    rgb = img[:C].permute(1, 2, 0) + trans[..., None] * bg
    zeros = torch.zeros_like(trans)
    P = prep.depth.shape[0]
    return RasterOutput(
        rgb=rgb,
        depth_expected=img[r["depth"]],
        alpha=img[r["alpha"]],
        normal=img[r["normal"]:r["normal"] + 3].permute(1, 2, 0),
        depth_median=zeros,
        distortion=zeros,
        wet=torch.zeros(P, dtype=torch.float32, device=img.device),
        radii=prep.radius,
        trans=trans,
        num_pairs=bins.num_pairs,
    )


class RenderOutput(NamedTuple):
    """Decoded render products (reference render() output contract)."""

    rgb: torch.Tensor  # (H, W, 3)
    specular: torch.Tensor | None  # (H, W, S)
    roughness: torch.Tensor | None  # (H, W, 1)
    alpha: torch.Tensor  # (H, W, 1)
    normal_world: torch.Tensor  # (H, W, 3) unnormalized, alpha-weighted
    depth_expected: torch.Tensor  # (H, W, 1) alpha-normalized
    depth_median: torch.Tensor  # (H, W, 1)
    surf_depth: torch.Tensor  # (H, W, 1) expected/median blend
    surf_normal: torch.Tensor  # (H, W, 3) from depth finite differences
    distortion: torch.Tensor  # (H, W, 1)
    wet: torch.Tensor  # (P,)
    radii: torch.Tensor  # (P,)
    visibility: torch.Tensor  # (P,) bool
    num_pairs: torch.Tensor | None = None  # () pre-clamp pair count


def depth_to_normal(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Pseudo surface normal from a z-depth map: cross product of central
    differences of the backprojected point map, zero on the 1px border."""
    H, W = cam.H, cam.W
    dev = depth.device
    i = torch.arange(H, dtype=torch.float32, device=dev)
    j = torch.arange(W, dtype=torch.float32, device=dev)
    ii, jj = torch.meshgrid(i, j, indexing="ij")
    pix = torch.stack([jj, ii, torch.ones_like(ii)], -1)
    Kinv = torch.linalg.inv(cam.K)
    d_world = (pix @ Kinv.T) @ cam.R
    xyz = cam.center[None, None] + depth[..., None] * d_world
    dx = xyz[2:, 1:-1] - xyz[:-2, 1:-1]
    dy = xyz[1:-1, 2:] - xyz[1:-1, :-2]
    n = torch.linalg.cross(dx, dy)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-16)
    out = torch.zeros_like(xyz)
    out[1:-1, 1:-1] = n
    return out


def render_decode(
    out: RasterOutput,
    cam: Camera,
    specular_channels: int = 0,
    depth_ratio: float = 0.0,
) -> RenderOutput:
    """Decode raw maps into the reference's post-processed products."""
    rgb = out.rgb[..., :3]
    spec = rough = None
    if specular_channels:
        spec = out.rgb[..., 3:3 + specular_channels]
        rough = out.rgb[..., 3 + specular_channels:3 + specular_channels + 1]
    alpha = out.alpha[..., None]
    normal_world = out.normal @ cam.R  # view -> world (R^T, row form)
    safe_alpha = torch.where(out.alpha == 0, torch.ones_like(out.alpha),
                             out.alpha)
    depth_e = torch.nan_to_num(out.depth_expected / safe_alpha)[..., None]
    depth_m = torch.nan_to_num(out.depth_median)[..., None]
    surf_depth = depth_e * (1.0 - depth_ratio) + depth_m * depth_ratio
    surf_normal = depth_to_normal(cam, surf_depth[..., 0]) * alpha
    return RenderOutput(
        rgb=rgb,
        specular=spec,
        roughness=rough,
        alpha=alpha,
        normal_world=normal_world,
        depth_expected=depth_e,
        depth_median=depth_m,
        surf_depth=surf_depth,
        surf_normal=surf_normal,
        distortion=out.distortion[..., None],
        wet=out.wet,
        radii=out.radii,
        visibility=out.radii > 0,
        num_pairs=out.num_pairs,
    )

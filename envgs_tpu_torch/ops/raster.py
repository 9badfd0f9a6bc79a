"""Rasterizer API (port of envgs_tpu/ops/raster.py).

`rasterize` runs binning and the tile blend — kernel K1 (forward) and K2
(backward) on CUDA tensors, their plain PyTorch versions on CPU tensors —
and decodes to the JAX package's RasterOutput contract. Three paths:

- render (`needs` all False): the unaligned layout, no training outputs;
- render with the median depth (`needs` = (False, True, False), what
  `render_mode` with `depth_ratio > 0` asks for): the unaligned layout
  through the blend's training variant, of whose extra planes only the
  median depth is kept (detached); distortion and wet stay zeros;
- training (`needs` all True): the chunk-aligned layout, distortion,
  median depth (detached), the distortion moments d1/d2, and autodiff
  through the blend's reverse walk. Screen-space densification gradients
  arrive as the gradient of `means2d_zero`. Per-splat wet arrives as the
  gradient of the `wet_zero` hook when one is given (RasterOutput.wet is
  then zeros); without it, K1 writes each pair's wet and a per-splat sum
  (`index_add_`) gives RasterOutput.wet, as the JAX package's segment sum.

The JAX package's other partial `needs` are not ported: they raise.
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
    blend_tiles_train,
    out_rows,
    rows,
)
from envgs_tpu_torch.ops.raster_ref import RasterOutput
from envgs_tpu_torch.utils.camera import Camera


def _shift_tmat(prep: PreparedSplats,
                means2d_zero: torch.Tensor | None) -> PreparedSplats:
    """Shift splats on screen by means2d_zero pixels (zero in practice: the
    hook's gradient is d(loss)/d(pixel-space splat translation))."""
    if means2d_zero is None:
        return prep
    z = means2d_zero
    row2 = prep.tmat[:, 2, :]
    tmat = torch.stack([prep.tmat[:, 0, :] + z[:, 0:1] * row2,
                        prep.tmat[:, 1, :] + z[:, 1:2] * row2, row2], dim=1)
    return prep._replace(tmat=tmat, center_pix=prep.center_pix + z)


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


def splat_wet(wet_pairs: torch.Tensor, gauss_idx: torch.Tensor,
              order: torch.Tensor) -> torch.Tensor:
    """Per-pair forward wet -> (P,) per-splat sums in pool order (the JAX
    package's segment sum over the depth-sorted splat ids, scattered back
    through the depth order)."""
    P = order.shape[0]
    sums = torch.zeros(P + 1, dtype=torch.float32, device=wet_pairs.device)
    sums.index_add_(0, gauss_idx.to(torch.int64), wet_pairs)
    wet = torch.zeros(P, dtype=torch.float32, device=wet_pairs.device)
    wet[order] = sums[:P]
    return wet


def rasterize(
    prep: PreparedSplats,
    cam: Camera,
    bg_color: torch.Tensor,
    pair_cap: int = 2 ** 21,
    means2d_zero: torch.Tensor | None = None,
    needs: tuple = (False, False, False),
    wet_zero: torch.Tensor | None = None,
) -> RasterOutput:
    """Rasterize prepared splats into the raw output maps.

    needs = (need_dist, need_med, need_wet): all False is the render path,
    need_med alone the render path with the median depth, all True the
    training path. With the (P,) zeros hook `wet_zero` the
    per-splat wet is the hook's gradient and RasterOutput.wet is exact
    zeros; without it RasterOutput.wet is the forward wet (detached)."""
    train = all(needs)
    med_only = tuple(map(bool, needs)) == (False, True, False)
    if any(needs) and not (train or med_only):
        raise NotImplementedError(
            f"rasterize needs={needs}: only none, need_med alone or all "
            "three training outputs")
    prep = _shift_tmat(prep, means2d_zero)
    C = prep.color.shape[-1]
    H, W = cam.H, cam.W
    P = prep.depth.shape[0]
    bins = bin_splats(prep, H, W, TILE, pair_cap, align=CHUNK,
                      lowpass_r=ROWCULL_LOWPASS_R, aligned=train)
    packed = _pack_table(prep, bins.order)
    wet = torch.zeros(P, dtype=torch.float32, device=packed.device)
    if train:
        wz = (None if wet_zero is None
              else torch.nn.functional.pad(wet_zero[bins.order], (0, 1)))
        img, wet_pairs = blend_tiles_train(
            packed, wz, bins.gauss_idx, bins.tile_bounds, C, bins.tiles_x,
            bins.tiles_y, fwd_wet=wet_zero is None)
        if wet_zero is None:
            wet = splat_wet(wet_pairs, bins.gauss_idx, bins.order)
        r = rows(C)
    else:
        img = blend_tiles(packed, bins.gauss_idx, bins.tile_bounds, C,
                          bins.tiles_x, bins.tiles_y, train=med_only)
        r = rows(C) if med_only else out_rows(C)
    img = img[:, :H, :W]
    trans = img[r["trans"]]
    bg = torch.zeros(C, dtype=torch.float32, device=img.device)
    bg[: bg_color.shape[0]] = bg_color
    rgb = img[:C].permute(1, 2, 0) + trans[..., None] * bg
    zeros = torch.zeros_like(trans)
    return RasterOutput(
        rgb=rgb,
        depth_expected=img[r["depth"]],
        alpha=img[r["alpha"]],
        normal=img[r["normal"]:r["normal"] + 3].permute(1, 2, 0),
        depth_median=(img[r["med"]].detach() if train or med_only
                      else zeros),
        distortion=img[r["dist"]] if train else zeros,
        wet=wet,
        radii=prep.radius,
        trans=trans,
        num_pairs=bins.num_pairs,
        d1=img[r["d1"]] if train else None,
        d2=img[r["d2"]] if train else None,
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
    surf_normal = depth_to_normal(cam, surf_depth[..., 0]) * alpha.detach()
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

"""Rasterizer API (port of envgs_tpu/ops/raster.py).

`rasterize` runs binning and the tile blend — kernel K1 (forward) and K2
(backward) on CUDA tensors, their plain PyTorch versions on CPU tensors —
and decodes to the JAX package's RasterOutput contract, taking the JAX
package's switches as it does (`envgs_tpu/ops/raster.py::rasterize`):

- `needs` = (need_dist, need_med, need_wet) picks K1's configuration:
  need_dist the distortion and its moments d1 / d2, need_med the median
  depth (detached), need_wet the forward per-splat wet (K1's per-pair wet
  summed per splat by `index_add_`, as the JAX package's segment sum). A
  stripped output is a zero plane (zero wet), as JAX leaves it. All off is
  the render path; need_med alone what `render_mode` with `depth_ratio > 0`
  asks for.
- the layout: chunk-aligned where need_wet or the `wet_zero` hook asks for
  it, else the unaligned render layout.
- `wet_zero`, the (P,) zeros hook: the per-splat wet arrives as its
  gradient (RasterOutput.wet is zeros; the forward's wet is stripped).
- autograd: an aligned call whose inputs require gradients under
  `torch.is_grad_enabled()` runs the blend's differentiable form, need_dist
  forced on (its backward, K2, reads d1, d2 and `last`), the caller's
  need_med and forward wet kept, as the JAX package's custom VJP does; the
  distortion and d1 / d2 are then the blend's. Screen-space densification
  gradients arrive as the gradient of `means2d_zero`. Elsewhere the blend
  runs exactly `needs`, outside autograd (the JAX package refuses autodiff
  on the unaligned layout).

`backend="ref"` runs the reference rasterizer instead
(`ops/raster_ref.py::rasterize_reference`), whatever the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.binning import bin_splats
from envgs_tpu_torch.ops.common import (
    ROWCULL_LOWPASS_R,
    PreparedSplats,
    check_backend,
)
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    TILE,
    blend_tiles,
    blend_tiles_train,
    plane_rows,
    rows,
)
from envgs_tpu_torch.ops.raster_ref import RasterOutput, rasterize_reference
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
    backend: str = "pallas",
    row_window: tuple | None = None,
) -> RasterOutput:
    """Rasterize prepared splats into the raw output maps.

    needs = (need_dist, need_med, need_wet) strips the outputs not asked
    for (zero planes, zero wet) from K1's work; an aligned call (need_wet,
    or the hook) under autograd computes the distortion whatever need_dist
    says (the module's docstring). With the (P,) zeros hook `wet_zero` the
    per-splat wet is the hook's gradient and RasterOutput.wet is exact
    zeros; without it, need_wet gives the forward wet (detached).
    backend: "pallas" (the kernels on a CUDA tensor, the plain versions on
    a CPU tensor) or "ref" (the reference rasterizer: every output, the
    forward wet, gradients by autograd; `needs` and `wet_zero` not read).

    row_window = (row0, band_h): rasterize only the rows [row0, row0 +
    band_h) of cam's full pixel grid (whole tile rows; H a multiple of the
    tile). prep and the blend's floats are the full camera's, the band is
    integer tile arithmetic and the blend's row offset, so the band's
    output equals the same rows of a full render to the bit (the
    band-parallel row-crop)."""
    check_backend("raster", backend)
    if backend == "ref":
        return rasterize_reference(_shift_tmat(prep, means2d_zero), cam,
                                   bg_color)
    need_dist, need_med, need_wet = map(bool, needs)
    prep = _shift_tmat(prep, means2d_zero)
    C = prep.color.shape[-1]
    H, W = cam.H, cam.W
    P = prep.depth.shape[0]
    H_out, row_off, bin_window = H, 0, None
    if row_window is not None:
        row0, H_out = map(int, row_window)
        if H % TILE or H_out % TILE or row0 % TILE:
            raise ValueError(f"row_window {row_window} of H={H}: whole "
                             f"{TILE}-pixel tile rows only")
        row_off, bin_window = row0, (row0 // TILE, H_out // TILE)
    # the per-pair wet needs the aligned layout; with the hook the gradient
    # lane carries the wet, the forward's is stripped and the layout stays
    # aligned (the backward walks whole windows)
    grad_wet = wet_zero is not None
    aligned = need_wet or grad_wet
    fwd_needs = (need_dist, need_med, need_wet and not grad_wet)
    bins = bin_splats(prep, H, W, TILE, pair_cap, align=CHUNK,
                      lowpass_r=ROWCULL_LOWPASS_R, aligned=aligned,
                      row_window=bin_window)
    packed = _pack_table(prep, bins.order)
    grad = aligned and torch.is_grad_enabled() and (
        packed.requires_grad or (grad_wet and wet_zero.requires_grad))
    if grad:
        wz = (None if wet_zero is None
              else torch.nn.functional.pad(wet_zero[bins.order], (0, 1)))
        img, wet_pairs = blend_tiles_train(
            packed, wz, bins.gauss_idx, bins.tile_bounds, C, bins.tiles_x,
            bins.tiles_y, fwd_wet=fwd_needs[2], row_off=row_off,
            need_med=need_med)
        r = rows(C)
    else:
        with torch.no_grad():
            img = blend_tiles(packed, bins.gauss_idx, bins.tile_bounds, C,
                              bins.tiles_x, bins.tiles_y, row_off, fwd_needs,
                              aligned=aligned)
        img, wet_pairs = img if fwd_needs[2] else (img, None)
        r = plane_rows(C, fwd_needs)
    img = img[:, :H_out, :W]
    trans = img[r["trans"]]
    bg = torch.zeros(C, dtype=torch.float32, device=img.device)
    bg[: bg_color.shape[0]] = bg_color
    rgb = img[:C].permute(1, 2, 0) + trans[..., None] * bg
    zeros = torch.zeros_like(trans)
    plane = lambda k: img[r[k]] if k in r else zeros  # noqa: E731
    wet = (splat_wet(wet_pairs, bins.gauss_idx, bins.order)
           if fwd_needs[2] else torch.zeros(P, dtype=torch.float32,
                                            device=packed.device))
    return RasterOutput(
        rgb=rgb,
        depth_expected=img[r["depth"]],
        alpha=img[r["alpha"]],
        normal=img[r["normal"]:r["normal"] + 3].permute(1, 2, 0),
        depth_median=plane("med").detach(),
        distortion=plane("dist"),
        wet=wet,
        radii=prep.radius,
        trans=trans,
        num_pairs=bins.num_pairs,
        d1=plane("d1"),
        d2=plane("d2"),
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


def depth_to_normal(cam: Camera, depth: torch.Tensor,
                    i0=None) -> torch.Tensor:
    """Pseudo surface normal from a z-depth map: cross product of central
    differences of the backprojected point map, zero on the 1px border.

    i0: the global row of depth row 0 (a band's halo recompute: cam holds
    the full image's K, so every pixel ray is the full image's)."""
    H, W = cam.H, cam.W
    dev = depth.device
    i = torch.arange(H, dtype=torch.float32, device=dev)
    if i0 is not None:
        i = i + i0
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
    i0=None,
) -> RenderOutput:
    """Decode raw maps into the reference's post-processed products.

    i0: the global pixel row of row 0 (a band of the row-crop: cam holds
    the full image's K with H the band's height). The band's boundary rows
    of the surface normal still read the local zero border; the band step
    replaces them from a halo."""
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
    surf_normal = (depth_to_normal(cam, surf_depth[..., 0], i0=i0)
                   * alpha.detach())
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

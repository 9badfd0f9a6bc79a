"""Differentiable 3DGS (EWA) rasterizer (port of envgs_tpu/ops/raster3d.py,
the `diff_gauss` contract of the reference's GaussianTSampler).

The binning of the surfel pipeline (aligned layout, so K5 builds it) and
the tile blend in gauss3d mode: kernel K1 forward with its per-pair wet,
kernel K2 backward on CUDA tensors, their plain versions on CPU tensors.
As in the JAX package, every call runs the training forward: distortion
and median depth are computed and dropped, and the per-splat wet is the
forward's (detached). Screen-space position gradients for densification
come back through the `means2d_zero` hook, which shifts the projected
center. `backend="ref"` runs the reference rasterizer
(`ops/raster3d_ref.py::rasterize3d_reference`) instead, whatever the device.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch.ops.binning import bin_splats
from envgs_tpu_torch.ops.common import check_backend
from envgs_tpu_torch.ops.raster import splat_wet
from envgs_tpu_torch.ops.raster3d_ref import (
    Prepared3DSplats,
    Raster3DOutput,
    prepare_splats3d,
    rasterize3d_reference,
)
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    TILE,
    blend_tiles_train,
    rows,
)
from envgs_tpu_torch.utils.camera import Camera


def _pack_table3d(prep: Prepared3DSplats,
                  order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-splat table (P+1, LO) f32, last row the zero sentinel, in the
    gauss3d layout: conic (a, b, c) at 0-2, view depth at 3, zeros at 4-8,
    center at 9-10, opacity at 11, zeros (normal columns) at 12-14, colors
    from 15; with `order`, rows permuted to the depth order."""
    P = prep.depth.shape[0]
    zeros = prep.depth.new_zeros((P, 5))
    packed = torch.cat([prep.conic, prep.depth[:, None], zeros,
                        prep.center_pix, (prep.opacity * prep.valid)[:, None],
                        zeros[:, :3], prep.color], dim=1)
    if order is not None:
        packed = packed[order]
    return torch.nn.functional.pad(packed, (0, LO - packed.shape[1], 0, 1))


def bin_and_pack(prep: Prepared3DSplats, cam: Camera, pair_cap: int):
    """The blend's inputs: the aligned binning of the prepared splats (K5
    builds it on a CUDA tensor) and the depth-ordered gauss3d table ->
    (packed (P+1, LO), bins)."""
    bins = bin_splats(prep, cam.H, cam.W, TILE, pair_cap, align=CHUNK,
                      aligned=True)
    return _pack_table3d(prep, bins.order), bins


def rasterize3d(
    prep: Prepared3DSplats,
    cam: Camera,
    bg_color: torch.Tensor,
    pair_cap: int = 2 ** 21,
    means2d_zero: torch.Tensor | None = None,
    backend: str = "pallas",
) -> Raster3DOutput:
    """Rasterize prepared 3D Gaussians: rgb (with the background), expected
    depth (premultiplied by alpha), alpha, per-splat wet, radii, final T.
    backend: "pallas" (the kernels on a CUDA tensor, the plain versions on
    a CPU tensor) or "ref" (the reference rasterizer, gradients by
    autograd)."""
    check_backend("raster", backend)
    if means2d_zero is not None:
        prep = prep._replace(center_pix=prep.center_pix + means2d_zero)
    if backend == "ref":
        return rasterize3d_reference(prep, cam, bg_color)
    C = prep.color.shape[-1]
    H, W = cam.H, cam.W
    packed, bins = bin_and_pack(prep, cam, pair_cap)
    img, wet_pairs = blend_tiles_train(
        packed, None, bins.gauss_idx, bins.tile_bounds, C, bins.tiles_x,
        bins.tiles_y, mode="gauss3d", fwd_wet=True)
    r = rows(C)
    img = img[:, :H, :W]
    trans = img[r["trans"]]
    bg = torch.zeros(C, dtype=torch.float32, device=img.device)
    bg[: bg_color.shape[0]] = bg_color
    rgb = img[:C].permute(1, 2, 0) + trans[..., None] * bg
    return Raster3DOutput(
        rgb=rgb,
        depth=img[r["depth"]],
        alpha=img[r["alpha"]],
        wet=splat_wet(wet_pairs, bins.gauss_idx, bins.order),
        radii=prep.radius,
        trans=trans,
        num_pairs=bins.num_pairs,
    )


def prepare_gaussians3d(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales3: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
    active: torch.Tensor | None = None,
    filter3d: torch.Tensor | None = None,
    mip: bool = False,
) -> Prepared3DSplats:
    """render_gaussians3d's preparation: the 0.3-dilation 2D filter, or
    with mip=True the mip-splatting pipeline (the 3D smoothing filter
    `filter3d` plus the 0.1-dilation 2D filter with opacity compensation)."""
    return prepare_splats3d(means3d, quats, scales3, opacities, colors, cam,
                            scale_modifier, active, filter3d=filter3d,
                            lowpass2d=0.1 if mip else 0.3, compensate2d=mip)


def render_gaussians3d(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales3: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    cam: Camera,
    bg_color: torch.Tensor | float = 0.0,
    pair_cap: int = 2 ** 21,
    scale_modifier: float = 1.0,
    active: torch.Tensor | None = None,
    means2d_zero: torch.Tensor | None = None,
    filter3d: torch.Tensor | None = None,
    mip: bool = False,
    backend: str = "pallas",
) -> Raster3DOutput:
    """One-call 3DGS render (prepare_gaussians3d + rasterize3d)."""
    prep = prepare_gaussians3d(means3d, quats, scales3, opacities, colors,
                               cam, scale_modifier, active, filter3d, mip)
    bg = torch.broadcast_to(
        torch.as_tensor(bg_color, dtype=torch.float32, device=colors.device),
        (colors.shape[-1],))
    return rasterize3d(prep, cam, bg, pair_cap, means2d_zero, backend)

"""3D Gaussian splatting (EWA) projection and the reference 3DGS
rasterizer (port of envgs_tpu/ops/raster3d_ref.py): full 3D covariance
Gaussians (3 scales + quaternion) projected to screen-space conics, the
`diff_gauss` contract of the reference's GaussianTSampler.

Sigma_3D = R S S^T R^T; Sigma_2D = J W Sigma_3D W^T J^T + lowpass2d I with J
the perspective Jacobian at the frustum-clamped view-space center. The
production blend is the tile kernel in gauss3d mode (`ops/raster3d.py`);
`rasterize3d_reference` is the exact oracle the `ref` backend runs, and
`compute_filter3d` the mip-splatting 3D filter's per-splat std.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import (
    ALPHA_MAX,
    ALPHA_MIN,
    NEAR_PLANE,
    T_CUTOFF,
)
from envgs_tpu_torch.ops.project3d import (
    LOWPASS_2D,
    Prepared3DSplats,
    project3d,
)
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.timer import span


class Raster3DOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, C) includes the background blend
    depth: torch.Tensor  # (H, W) expected depth, premultiplied by alpha
    alpha: torch.Tensor  # (H, W)
    wet: torch.Tensor  # (P,) per-splat accumulated blend weight
    radii: torch.Tensor  # (P,)
    trans: torch.Tensor  # (H, W) final transmittance
    num_pairs: torch.Tensor | None = None  # () pairs before the cap


def prepare_splats3d(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales3: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
    active: torch.Tensor | None = None,
    filter3d: torch.Tensor | None = None,
    lowpass2d: float = LOWPASS_2D,
    compensate2d: bool = False,
) -> Prepared3DSplats:
    """EWA-project 3D Gaussians to screen conics.

    means3d (P, 3), quats (P, 4) wxyz, scales3 (P, 3) post-activation,
    opacities (P,), colors (P, C); active (P,) bool pool mask. filter3d
    (P,): the mip-splatting 3D smoothing-filter std, which convolves the 3D
    covariance and scales opacity to keep the splat's mass; lowpass2d: the
    screen-space dilation (0.3 classic 3DGS, 0.1 mip-splatting with
    compensate2d, which scales opacity by sqrt(det2 / det2_dilated)). On
    CUDA tensors the projection's kernels run, on CPU tensors the plain
    version (ops/project3d.py)."""
    with span("render.project"):
        return project3d(means3d, quats, scales3, opacities, colors, cam,
                         scale_modifier, active, filter3d, lowpass2d,
                         compensate2d)


def compute_filter3d(means3d: torch.Tensor, cams: list,
                     guard: float = 1.3) -> torch.Tensor:
    """Per-splat mip-splatting 3D smoothing-filter std (world units):
    sqrt(0.2) times the smallest depth / focal over the cameras that see the
    point (in front of the near plane, inside a `guard`-dilated frustum);
    points no camera sees get the largest interval any point has."""
    P = means3d.shape[0]
    best = torch.full((P,), float("inf"), device=means3d.device)
    for cam in cams:
        t = means3d @ cam.R.T + cam.T[None, :]
        z = t[:, 2]
        f = 0.5 * (cam.K[0, 0] + cam.K[1, 1])
        x = t[:, 0] / torch.clamp(z, min=1e-6) * cam.K[0, 0] + cam.K[0, 2]
        y = t[:, 1] / torch.clamp(z, min=1e-6) * cam.K[1, 1] + cam.K[1, 2]
        inside = ((z > NEAR_PLANE)
                  & (torch.abs(x - cam.W / 2) < guard * cam.W / 2)
                  & (torch.abs(y - cam.H / 2) < guard * cam.H / 2))
        best = torch.minimum(best, torch.where(inside, z / f, float("inf")))
    fallback = torch.where(torch.isinf(best), 0.0, best).max()
    best = torch.where(torch.isinf(best), torch.clamp(fallback, min=1e-4),
                       best)
    return best * torch.sqrt(best.new_tensor(0.2))


def rasterize3d_reference(prep: Prepared3DSplats, cam: Camera,
                          bg_color: torch.Tensor) -> Raster3DOutput:
    """Rasterize prepared 3D Gaussians, every valid one in view-depth
    order: rgb, expected depth (premultiplied), alpha, per-splat wet, radii,
    final T. A pixel takes a Gaussian where its 16-pixel tile overlaps the
    Gaussian's AABB, the power is <= 0, alpha >= 1/255 and T > 1e-4.
    Differentiable by autograd; O(P H W), for small scenes."""
    from envgs_tpu_torch.ops.raster_ref import TILE

    P = prep.depth.shape[0]
    H, W = cam.H, cam.W
    C = prep.color.shape[-1]
    dev = prep.depth.device
    order = torch.argsort(torch.where(prep.valid, prep.depth, float("inf")),
                          stable=True)
    n_valid = int(prep.valid.sum())
    ii, jj = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    tpx, tpy = torch.floor(jj / TILE), torch.floor(ii / TILE)
    rgb = torch.zeros((H, W, C), device=dev)
    dpt = torch.zeros((H, W), device=dev)
    alp = torch.zeros((H, W), device=dev)
    T = torch.ones((H, W), device=dev)
    wet_sorted = []
    for i in order[:n_valid].tolist():  # invalid Gaussians take no pixel
        cn, ce, ex = prep.conic[i], prep.center_pix[i], prep.ext[i]
        dx = jj - ce[0]
        dy = ii - ce[1]
        power = -0.5 * (cn[0] * dx * dx + cn[2] * dy * dy) - cn[1] * dx * dy
        G = torch.exp(torch.clamp(power, max=0.0))
        a_px = torch.clamp(prep.opacity[i] * G, max=ALPHA_MAX)
        lo = torch.floor((ce - ex) / TILE)
        hi = torch.floor((ce + ex) / TILE)
        in_tile = ((tpx >= lo[0]) & (tpx <= hi[0]) & (tpy >= lo[1])
                   & (tpy <= hi[1]))
        use = (a_px >= ALPHA_MIN) & (T > T_CUTOFF) & in_tile & (power <= 0)
        a_px = torch.where(use, a_px, 0.0)
        w = a_px * T
        rgb = rgb + w[..., None] * prep.color[i]
        dpt = dpt + w * prep.depth[i]
        alp = alp + w
        T = T * (1.0 - a_px)
        wet_sorted.append(w.sum())
    wet = torch.zeros(P, device=dev)
    if wet_sorted:
        wet = wet.index_put((order[:n_valid],), torch.stack(wet_sorted))
    bg = torch.broadcast_to(bg_color, (C,))
    return Raster3DOutput(rgb=rgb + T[..., None] * bg, depth=dpt, alpha=alp,
                          wet=wet, radii=prep.radius, trans=T)

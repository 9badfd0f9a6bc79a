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
    ROWCULL_LEVEL,
    T_CUTOFF,
    rowcull_params,
)
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.timer import span
from envgs_tpu_torch.utils.transforms import quat_to_rotmat

# 3DGS screen-space low-pass: += 0.3 px^2 on the 2D covariance diagonal
LOWPASS_2D = 0.3
CUTOFF = 3.0  # 3-sigma extent


class Prepared3DSplats(NamedTuple):
    """Per-splat screen-space data for the 3DGS pipeline (padded pool)."""

    conic: torch.Tensor  # (P, 3) inverse 2D covariance (a, b, c)
    center_pix: torch.Tensor  # (P, 2) projected center (pixel coords)
    depth: torch.Tensor  # (P,) view-space z of the center
    radius: torch.Tensor  # (P,) conservative screen radius (0 if culled)
    color: torch.Tensor  # (P, C) per-splat channels
    opacity: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,) bool
    ext: torch.Tensor  # (P, 2) 3-sigma ellipse AABB half-extents (pixels)
    rowcull: torch.Tensor  # (P, 6) per-tile-row interval params of the conic
    #   at the alpha-floor level (ops/common.rowcull_params)


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
    compensate2d, which scales opacity by sqrt(det2 / det2_dilated))."""
    with span("render.project"):
        R = quat_to_rotmat(quats)
        S = scales3 * scale_modifier
        M = R * S[:, None, :]  # columns scaled: M = R diag(S)
        cov3 = M @ M.transpose(1, 2)

        if filter3d is not None:
            f2 = filter3d[:, None] ** 2
            det_raw = (S[:, 0] * S[:, 1] * S[:, 2]) ** 2
            det_flt = (S ** 2 + f2).prod(dim=-1)
            opacities = opacities * torch.sqrt(torch.clamp(
                det_raw / torch.clamp(det_flt, min=1e-30), 0.0, 1.0))
            cov3 = cov3 + f2[..., None] * torch.eye(
                3, device=cov3.device)[None]

        # view-space center; frustum-clamped for the Jacobian (3DGS convention)
        t = means3d @ cam.R.T + cam.T[None, :]
        tz = torch.clamp(t[:, 2], min=1e-6)
        fx, fy = cam.K[0, 0], cam.K[1, 1]
        lim_x = 1.3 * (0.5 * cam.W / fx)
        lim_y = 1.3 * (0.5 * cam.H / fy)
        txc = torch.clamp(t[:, 0] / tz, -lim_x, lim_x) * tz
        tyc = torch.clamp(t[:, 1] / tz, -lim_y, lim_y) * tz

        z = torch.zeros_like(tz)
        J = torch.stack([
            torch.stack([fx / tz, z, -fx * txc / (tz * tz)], -1),
            torch.stack([z, fy / tz, -fy * tyc / (tz * tz)], -1),
        ], -2)  # (P, 2, 3)
        JW = J @ cam.R[None]
        cov2 = JW @ cov3 @ JW.transpose(1, 2)
        a = cov2[:, 0, 0] + lowpass2d
        b = cov2[:, 0, 1]
        c = cov2[:, 1, 1] + lowpass2d

        det = a * c - b * b
        if compensate2d:
            det_raw2 = torch.clamp(
                cov2[:, 0, 0] * cov2[:, 1, 1] - cov2[:, 0, 1] ** 2, min=0.0)
            opacities = opacities * torch.sqrt(torch.clamp(
                det_raw2 / torch.clamp(det, min=1e-30), 0.0, 1.0))
        det_safe = torch.where(det <= 0, 1.0, det)
        conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

        # conservative radius from the largest eigenvalue; snug per-axis
        # extents: the 3-sigma ellipse's exact AABB
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(CUTOFF * torch.sqrt(lam))
        bx = torch.ceil(CUTOFF * torch.sqrt(torch.clamp(a, min=0.0)))
        by = torch.ceil(CUTOFF * torch.sqrt(torch.clamp(c, min=0.0)))

        Mp = cam.pix_from_world
        ph = means3d @ Mp[:, :3].T + Mp[:, 3]
        w_c = ph[:, 2]
        center_pix = ph[:, :2] / torch.where(w_c == 0, 1.0, w_c)[:, None]

        valid = (t[:, 2] > NEAR_PLANE) & (det > 0)
        if active is not None:
            valid = valid & active
        in_img = ((center_pix[:, 0] + radius >= 0)
                  & (center_pix[:, 0] - radius <= cam.W - 1)
                  & (center_pix[:, 1] + radius >= 0)
                  & (center_pix[:, 1] - radius <= cam.H - 1))
        valid = valid & in_img
        radius = torch.where(valid, radius, 0.0)
        ext = torch.stack([bx, by], dim=-1) * valid[:, None]
        # the footprint quadratic is the conic itself
        rowcull = rowcull_params(center_pix[:, 0], center_pix[:, 1],
                                 conic[:, 0], conic[:, 1], conic[:, 2],
                                 torch.full_like(conic[:, 0], ROWCULL_LEVEL))
        return Prepared3DSplats(conic=conic, center_pix=center_pix,
                                depth=t[:, 2], radius=radius, color=colors,
                                opacity=opacities, valid=valid, ext=ext,
                                rowcull=rowcull)


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

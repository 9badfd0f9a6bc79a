"""3D Gaussian splatting (EWA) projection (port of the projection half of
envgs_tpu/ops/raster3d_ref.py): full 3D covariance Gaussians (3 scales +
quaternion) projected to screen-space conics, the `diff_gauss` contract of
the reference's GaussianTSampler.

Sigma_3D = R S S^T R^T; Sigma_2D = J W Sigma_3D W^T J^T + lowpass2d I with J
the perspective Jacobian at the frustum-clamped view-space center. The
blend itself is the tile kernel in gauss3d mode (`ops/raster3d.py`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import (
    NEAR_PLANE,
    ROWCULL_LEVEL,
    rowcull_params,
)
from envgs_tpu_torch.utils.camera import Camera
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
        cov3 = cov3 + f2[..., None] * torch.eye(3, device=cov3.device)[None]

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
    rowcull = rowcull_params(center_pix[:, 0], center_pix[:, 1], conic[:, 0],
                             conic[:, 1], conic[:, 2],
                             torch.full_like(conic[:, 0], ROWCULL_LEVEL))
    return Prepared3DSplats(conic=conic, center_pix=center_pix, depth=t[:, 2],
                            radius=radius, color=colors, opacity=opacities,
                            valid=valid, ext=ext, rowcull=rowcull)

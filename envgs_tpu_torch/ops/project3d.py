"""The 3DGS EWA projection: the plain PyTorch version and the wrapper of
its CUDA kernels (csrc/project3d.cu), forward and backward.

Sigma_3D = R S S^T R^T; Sigma_2D = J W Sigma_3D W^T J^T + lowpass2d I with J
the perspective Jacobian at the frustum-clamped view-space center (the
JAX package's envgs_tpu/ops/raster3d_ref.py::prepare_splats3d). The plain
version runs on CPU tensors, and is the kernels' oracle on the card. On
CUDA tensors one kernel launch projects the pool, and under autograd one
more gives the gradients of the means, quaternions, scales and opacities;
radius, extents, validity and the row-cull parameters feed only integer
decisions and carry none. An input on the card that the kernels do not
take (a tensor off the card or not float32, a mask that is not bool, a
camera tensor or filter3d that asks for a gradient) raises
UnsupportedProjection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.common import (
    NEAR_PLANE,
    ROWCULL_LEVEL,
    rowcull_params,
)
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.timer import count
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


def project3d_torch(
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
    """Plain version: the projection in batched 3x3 products and
    elementwise ops, differentiable by autograd (project3d's contract)."""
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


class UnsupportedProjection(ValueError):
    """An input on the card that the projection's kernels do not take."""


def use_kernel(means3d, quats, scales3, opacities, cam: Camera,
               active=None, filter3d=None) -> bool:
    """The dispatch rule: False (the plain version) where every tensor is
    on the CPU, True (the kernels) where every one is on the card; raises
    UnsupportedProjection for a mix of the two, or on the card for a float
    tensor that is not float32, a mask that is not bool, or a camera
    tensor or filter3d that asks for a gradient."""
    floats = {"means3d": means3d, "quats": quats, "scales3": scales3,
              "opacities": opacities, "cam.R": cam.R, "cam.T": cam.T,
              "cam.K": cam.K}
    if filter3d is not None:
        floats["filter3d"] = filter3d
    tensors = dict(floats, active=active) if active is not None else floats
    off = [k for k, t in tensors.items() if not t.is_cuda]
    if len(off) == len(tensors):
        return False
    if off:
        raise UnsupportedProjection(
            f"the projection's tensors are on two devices: {off} on the "
            "CPU, the rest on the card")
    bad = [k for k, t in floats.items() if t.dtype != torch.float32]
    if bad:
        raise UnsupportedProjection(
            f"the projection's kernels take float32; {bad} are not")
    if active is not None and active.dtype != torch.bool:
        raise UnsupportedProjection(
            f"the projection's kernels take a bool mask, not {active.dtype}")
    if torch.is_grad_enabled():
        bad = [k for k in ("cam.R", "cam.T", "cam.K", "filter3d")
               if k in floats and floats[k].requires_grad]
        if bad:
            raise UnsupportedProjection(
                f"the projection's kernels give no gradient of {bad}")
    return True


def camera_buffer(cam: Camera) -> torch.Tensor:
    """(33,) f32 on the camera's device: R, T, K, pix_from_world, as the
    kernels read it."""
    return torch.cat([cam.R.reshape(-1), cam.T.reshape(-1),
                      cam.K.reshape(-1), cam.pix_from_world.reshape(-1)])


def _aligned(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """t contiguous, and copied where its data is not n_bytes-aligned."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % n_bytes else t


class _Project3d(torch.autograd.Function):
    """The kernels under autograd: saves the inputs; the backward kernel
    recomputes the forward's intermediates."""

    @staticmethod
    def forward(ctx, means3d, quats, scales3, opacities, active, filter3d,
                cam_buf, W, H, scale_modifier, lowpass2d, compensate2d):
        conf = (W, H, scale_modifier, lowpass2d, compensate2d)
        out = kernels.project3d_fwd(means3d, quats, scales3, opacities,
                                    active, filter3d, cam_buf, *conf)
        ctx.save_for_backward(means3d, quats, scales3, opacities, filter3d,
                              cam_buf)
        ctx.conf = conf
        ctx.mark_non_differentiable(*out[3:7])
        ctx.set_materialize_grads(False)
        return out if out[7] is not None else out[:7]

    @staticmethod
    def backward(ctx, g_conic, g_center, g_depth, *g_rest):
        g_opac = g_rest[4] if len(g_rest) > 4 else None
        means3d, quats, scales3, opacities, filter3d, cam_buf = (
            ctx.saved_tensors)
        d_means, d_quats, d_scales, d_opac = kernels.project3d_bwd(
            means3d, quats, scales3, opacities, filter3d, cam_buf, *ctx.conf,
            None if g_conic is None else g_conic.contiguous(),
            None if g_center is None else _aligned(g_center, 8),
            None if g_depth is None else g_depth.contiguous(),
            None if g_opac is None else g_opac.contiguous())
        need = ctx.needs_input_grad
        return (d_means if need[0] else None, d_quats if need[1] else None,
                d_scales if need[2] else None,
                d_opac if need[3] else None) + (None,) * 8


def project3d(
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
    """EWA-project 3D Gaussians to screen conics: the kernels on CUDA
    tensors, the plain version on CPU ones (`use_kernel`).

    means3d (P, 3), quats (P, 4) wxyz, scales3 (P, 3) post-activation,
    opacities (P,), colors (P, C); active (P,) bool pool mask. filter3d
    (P,): the mip-splatting 3D smoothing-filter std, which convolves the 3D
    covariance and scales opacity to keep the splat's mass; lowpass2d: the
    screen-space dilation (0.3 classic 3DGS, 0.1 mip-splatting with
    compensate2d, which scales opacity by sqrt(det2 / det2_dilated)). The
    opacity is the input tensor itself unless a filter changes it."""
    if not use_kernel(means3d, quats, scales3, opacities, cam, active,
                      filter3d):
        return project3d_torch(means3d, quats, scales3, opacities, colors,
                               cam, scale_modifier, active, filter3d,
                               lowpass2d, compensate2d)
    count("project.fused", means3d.shape[0])
    out = _Project3d.apply(
        means3d.contiguous(), _aligned(quats, 16), scales3.contiguous(),
        opacities.contiguous(),
        None if active is None else active.contiguous(),
        None if filter3d is None else filter3d.contiguous(),
        camera_buffer(cam), cam.W, cam.H, float(scale_modifier),
        float(lowpass2d), bool(compensate2d))
    conic, center_pix, depth, radius, valid, ext, rowcull = out[:7]
    return Prepared3DSplats(conic=conic, center_pix=center_pix, depth=depth,
                            radius=radius, color=colors,
                            opacity=out[7] if len(out) > 7 else opacities,
                            valid=valid, ext=ext, rowcull=rowcull)

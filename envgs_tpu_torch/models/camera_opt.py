"""Optimizable camera residuals: per-view SE(3) extrinsic and intrinsic
deltas (port of envgs_tpu/models/camera_opt.py).

A per-view se(3) tangent residual is applied to R/T through the exponential
map, plus a clipped focal / principal-point residual; both live in a small
NamedTuple keyed by view index and are applied inside the train step, which
optimizes them with the pools.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.utils.camera import Camera


class CameraResiduals(NamedTuple):
    se3: torch.Tensor  # (V, 6) [rotation tangent | translation]
    intr: torch.Tensor  # (V, 4) [dfx, dfy, dcx, dcy]


def init_camera_residuals(n_views: int, device=None) -> CameraResiduals:
    return CameraResiduals(
        se3=torch.zeros((n_views, 6), dtype=torch.float32, device=device),
        intr=torch.zeros((n_views, 4), dtype=torch.float32, device=device))


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = w.new_zeros(())
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(3,) tangent -> (3, 3) rotation (Rodrigues), gradient-safe at w = 0:
    A = sin(t)/t and B = (1 - cos(t))/t^2 with their Taylor forms below
    |w|^2 = 1e-12, the square root taken of a safe value so the branch not
    taken yields no NaN gradient."""
    t2 = torch.sum(w * w)
    small = t2 < 1e-12
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)
    K = _skew(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def apply_residual(cam: Camera, res: CameraResiduals, view_idx: int,
                   intr_clip: float = 0.05) -> Camera:
    """Apply the view's residual: R' = exp(w) R, T' = exp(w) T + t,
    K' = K * (1 + clip(d)) on the focal lengths, + clip(d) * f on the
    principal point."""
    se3 = res.se3[view_idx]
    dR = so3_exp(se3[:3])
    R = dR @ cam.R
    T = dR @ cam.T + se3[3:]
    d = torch.clamp(res.intr[view_idx], -intr_clip, intr_clip)
    K = cam.K
    fx = K[0, 0] * (1.0 + d[0])
    fy = K[1, 1] * (1.0 + d[1])
    cx = K[0, 2] + d[2] * K[0, 0]
    cy = K[1, 2] + d[3] * K[1, 1]
    # rebuilt out of place, so the residual's gradient flows through autograd
    K = torch.stack([torch.stack([fx, K[0, 1], cx]),
                     torch.stack([K[1, 0], fy, cy]),
                     K[2]])
    return cam._replace(K=K, R=R, T=T)

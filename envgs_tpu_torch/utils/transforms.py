"""Quaternion / rotation / normalization helpers (port of
envgs_tpu/utils/transforms.py)."""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    """L2 normalization along `dim`, finite at v = 0 (the smooth
    v / sqrt(|v|^2 + eps^2) form of the JAX package)."""
    return v * torch.rsqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps * eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (unnormalized ok) -> (..., 3, 3) rotation."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction d about the (normalized) normal n: d - 2 (d.n) n."""
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n

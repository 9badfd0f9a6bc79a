"""Cameras, rotations and colours of the reference, written from their
definitions.

Conventions of the model (the EnvGS / 3DGS papers' and the repository's):
a camera maps a world point x to view space as R x + T; K holds the
focal lengths and the principal point, and pixel (i, j) of an image has
its centre at (j + 0.5, i + 0.5) in K's frame, which the splats' screen
coordinates place at the integers (j, i). Colours are real spherical
harmonics of degree 3 with the 3DGS basis, shifted by 0.5 and clamped
at zero.
"""
from __future__ import annotations

import math

import torch

# the real SH basis of degree <= 3 (Sloan's normalisation, 3DGS's signs)
_S0 = 0.5 * math.sqrt(1.0 / math.pi)
_S1 = math.sqrt(3.0 / (4.0 * math.pi))
_S2 = (0.5 * math.sqrt(15.0 / math.pi), 0.25 * math.sqrt(5.0 / math.pi),
       0.25 * math.sqrt(15.0 / math.pi))
_S3 = (0.25 * math.sqrt(35.0 / (2.0 * math.pi)),
       0.5 * math.sqrt(105.0 / math.pi),
       0.25 * math.sqrt(21.0 / (2.0 * math.pi)),
       0.25 * math.sqrt(7.0 / math.pi))


def unit(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v / |v| along the last axis, smoothed at zero: v / sqrt(|v|^2 +
    eps^2) (the model's normalisation, finite at a zero vector)."""
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps * eps)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions w, x, y, z (any length) -> (..., 3, 3)."""
    w, x, y, z = unit(q).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).unflatten(-1, (3, 3))


class Cam:
    """A pinhole camera of H x W pixels."""

    def __init__(self, H: int, W: int, K, R, T):
        self.H, self.W, self.K, self.R, self.T = H, W, K, R, T

    @property
    def center(self) -> torch.Tensor:
        return -(self.R.T @ self.T)

    def to_view(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.R.T + self.T

    def pixel_matrix(self) -> torch.Tensor:
        """(3, 4): world point -> (x w, y w, w), w the view depth and (x,
        y) the screen position, pixel centres on the integers."""
        K = self.K.clone()
        K[0, 2] = K[0, 2] - 0.5
        K[1, 2] = K[1, 2] - 0.5
        return K @ torch.cat([self.R, self.T[:, None]], 1)

    def pixel_directions(self, offset: float) -> torch.Tensor:
        """(H, W, 3) world directions through pixel (i, j) taken at (j +
        offset, i + offset) in K's frame, scaled to view depth 1."""
        dev = self.K.device
        i = torch.arange(self.H, dtype=torch.float32, device=dev) + offset
        j = torch.arange(self.W, dtype=torch.float32, device=dev) + offset
        ii, jj = torch.meshgrid(i, j, indexing="ij")
        pix = torch.stack([jj, ii, torch.ones_like(ii)], -1)
        return pix @ torch.linalg.inv(self.K).T @ self.R

    def rays(self):
        """The camera's rays through the pixel centres: (origin (3,),
        directions (H, W, 3) at view depth 1)."""
        return self.center, self.pixel_directions(0.5)


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., 16) basis values of degree <= 3."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, _S0),
        -_S1 * y, _S1 * z, -_S1 * x,
        _S2[0] * x * y, -_S2[0] * y * z, _S2[1] * (2 * zz - xx - yy),
        -_S2[0] * x * z, _S2[2] * (xx - yy),
        -_S3[0] * y * (3 * xx - yy), _S3[1] * x * y * z,
        -_S3[2] * y * (4 * zz - xx - yy), _S3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        -_S3[2] * x * (4 * zz - xx - yy), 0.5 * _S3[1] * z * (xx - yy),
        -_S3[0] * x * (xx - 3 * yy),
    ], -1)


def sh_colors(sh: torch.Tensor, xyz: torch.Tensor, origin: torch.Tensor,
              degree: int) -> torch.Tensor:
    """(P, 16, 3) coefficients -> (P, 3) colours seen from `origin`, the
    coefficients above the active `degree` left out."""
    k = sh.shape[1]
    keep = (torch.arange(k, device=sh.device) < (degree + 1) ** 2)
    basis = sh_basis(unit(xyz - origin)) * keep
    return torch.clamp((basis[..., None] * sh).sum(1) + 0.5, min=0.0)

"""Real spherical-harmonics evaluation, degrees 0..4 (port of
envgs_tpu/utils/sh.py; standard 3DGS basis and constants), and the 4D
(view + time) SH of the dynamic families."""
from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real-SH basis values at unit directions: (..., (deg+1)^2)."""
    assert 0 <= deg <= 4
    one = torch.ones_like(dirs[..., :1])
    cols = [C0 * one]
    if deg > 0:
        x, y, z = dirs[..., :1], dirs[..., 1:2], dirs[..., 2:3]
        cols += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            cols += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                     C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                cols += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                         C3[2] * y * (4 * zz - xx - yy),
                         C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                         C3[4] * x * (4 * zz - xx - yy),
                         C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
                if deg > 3:
                    cols += [C4[0] * xy * (xx - yy),
                             C4[1] * yz * (3 * xx - yy),
                             C4[2] * xy * (7 * zz - 1),
                             C4[3] * yz * (7 * zz - 3),
                             C4[4] * (zz * (35 * zz - 30) + 3),
                             C4[5] * xz * (7 * zz - 3),
                             C4[6] * (xx - yy) * (7 * zz - 1),
                             C4[7] * xz * (xx - 3 * yy),
                             C4[8] * (xx * (xx - 3 * yy)
                                      - yy * (3 * xx - yy))]
    return torch.cat(cols, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., C, (deg+1)^2) at unit dirs (..., 3) -> (..., C).

    The terms are summed in the JAX package's order (`result + c_i * b_i`,
    one basis function at a time) so the two round alike."""
    assert 0 <= deg <= 4
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., :1], dirs[..., 1:2], dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16]
                        + C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + C4[8] * (
                            xx * (xx - 3 * yy) - yy * (3 * xx - yy)
                        ) * sh[..., 24]
                    )
    return result


def eval_sh_color(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB with the 3DGS +0.5 shift and clamp-min-0 (`deg` is the
    maximum degree; the caller masks coefficients above the active one).
    At a color of exactly 0 (a black SfM point: rgb2sh0(0) comes back as
    0.0) the gradient is halved, as the JAX package's `jnp.clip` gives it:
    the mean of relu's (0 there) and clamp's (1)."""
    x = eval_sh(deg, sh, dirs) + 0.5
    return 0.5 * (torch.relu(x) + torch.clamp(x, min=0.0))


def rgb2sh0(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh02rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def num_sh_coeffs_4d(deg: int, deg_t: int) -> int:
    return (deg + 1) ** 2 * (deg_t + 1)


def eval_sh_4d(deg: int, deg_t: int, sh: torch.Tensor, dirs: torch.Tensor,
               dirs_t: torch.Tensor, l: float = 1.0) -> torch.Tensor:
    """4D SH: the spatial basis of degree `deg` times a temporal cosine
    basis; block k of (deg+1)^2 coefficients is weighted by
    cos(2 pi k t / l), k = 0..deg_t (block 0 is the static SH).

    sh (..., C, (deg+1)^2 (deg_t+1)); dirs (..., 3); dirs_t (...,) or
    (..., 1) time offsets; l the temporal period. -> (..., C)."""
    K = num_sh_coeffs(deg)
    t = dirs_t[..., 0] if dirs_t.dim() == dirs.dim() else dirs_t
    t = t[..., None]  # broadcast over channels
    result = eval_sh(deg, sh[..., :K], dirs)
    for k in range(1, deg_t + 1):
        tk = torch.cos(2.0 * math.pi * k * t / l)
        result = result + tk * eval_sh(deg, sh[..., k * K:(k + 1) * K], dirs)
    return result

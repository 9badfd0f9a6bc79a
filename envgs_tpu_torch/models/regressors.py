"""Output regressors (port of envgs_tpu/models/regressors.py, the
reference's regressor zoo): `MLP` (the MlpRegressor), `SplitRegressor`
(density + feature, then view-dependent color), `spherical_harmonics_apply`,
`contract` (mip-NeRF 360), the empty / noop / zero regressors,
`DisplacementRegressor`, `ResidualRegressor`, `se3_exp_rt` and
`SE3Regressor`, `ImageBasedRegressor` and `ImageBasedSphericalHarmonics`.

The weights keep the JAX package's layout: layer i computes h @ w_i + b_i
with w_i of shape (din, dout), so a JAX parameter list [(w, b), ...]
crosses by `load_jax` / `jax_params` (a module of several MLPs: the JAX
dict of their lists).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def jmax(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo): half the gradient where x equals lo."""
    return torch.maximum(x, x.new_tensor(lo))


def jclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): half the gradient where x equals a bound (a
    depth that is exactly `far`, a softmax gone one-hot on the last plane,
    is such a tie); torch.clamp passes all of it."""
    return torch.minimum(jmax(x, lo), x.new_tensor(hi))


class MLP(nn.Module):
    """`depth` hidden ReLU layers of `width`, a linear head of `out_dim`
    with an optional activation (none | sigmoid | relu | softplus | tanh),
    the input concatenated again before the layers in `skips` (as the JAX
    package: the widths of those layers include it, and layer 0 never
    takes it). Hidden weights start at N(0, 2 / din), the head's at
    N(0, 1 / d), biases at 0 (drawn from `generator`; not the JAX
    package's draws)."""

    def __init__(self, in_dim: int, width: int = 256, depth: int = 8,
                 out_dim: int = 4, skips: tuple = (4,),
                 out_actvn: str = "none",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.in_dim, self.width, self.depth = in_dim, width, depth
        self.out_dim, self.skips = out_dim, tuple(skips)
        self.out_actvn = out_actvn
        ws, bs = [], []
        d = in_dim
        for i in range(depth + 1):
            head = i == depth
            din = d + (in_dim if i in self.skips and not head else 0)
            dout = out_dim if head else width
            scale = math.sqrt((1.0 if head else 2.0) / din)
            ws.append(nn.Parameter(torch.randn(
                (din, dout), generator=generator, device=device) * scale))
            bs.append(nn.Parameter(torch.zeros(dout, device=device)))
            d = width
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            if i in self.skips and i > 0:
                h = torch.cat([h, x], dim=-1)
            h = torch.relu(h @ self.weights[i] + self.biases[i])
        out = h @ self.weights[self.depth] + self.biases[self.depth]
        if self.out_actvn == "sigmoid":
            out = torch.sigmoid(out)
        elif self.out_actvn == "relu":
            out = torch.relu(out)
        elif self.out_actvn == "softplus":
            out = nn.functional.softplus(out)
        elif self.out_actvn == "tanh":
            out = torch.tanh(out)
        return out

    def jax_params(self) -> list:
        """[(w, b), ...] of the layers: the JAX package's parameter list
        (the module's own tensors)."""
        return list(zip(self.weights, self.biases))

    @torch.no_grad()
    def load_jax(self, params: list):
        """Copy a JAX parameter list [(w, b), ...] (arrays or tensors) into
        the layers."""
        for (w, b), tw, tb in zip(params, self.weights, self.biases):
            tw.copy_(torch.as_tensor(w, dtype=torch.float32))
            tb.copy_(torch.as_tensor(b, dtype=torch.float32))


class SplitRegressor(nn.Module):
    """Geometry MLP -> (density, feature); color MLP([feature, dir]) ->
    rgb. The geometry head's first channel is the density, through
    softplus(x - 1); the color head has `color_depth` layers of
    `color_width` and a sigmoid. JAX's parameters: dict(geo=..., rgb=...)."""

    def __init__(self, xyz_dim: int, dir_dim: int, width: int = 256,
                 depth: int = 8, feat_dim: int = 256, color_width: int = 128,
                 color_depth: int = 2,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.feat_dim = feat_dim
        self.geo = MLP(xyz_dim, width, depth, 1 + feat_dim,
                       generator=generator, device=device)
        self.rgb = MLP(feat_dim + dir_dim, color_width, color_depth, 3,
                       skips=(), out_actvn="sigmoid", generator=generator,
                       device=device)

    def density(self, xyz_feat: torch.Tensor):
        out = self.geo(xyz_feat)
        return nn.functional.softplus(out[..., 0] - 1.0), out[..., 1:]

    def forward(self, xyz_feat: torch.Tensor, dir_feat: torch.Tensor):
        sigma, feat = self.density(xyz_feat)
        return self.rgb(torch.cat([feat, dir_feat], dim=-1)), sigma

    def jax_params(self) -> dict:
        return dict(geo=self.geo.jax_params(), rgb=self.rgb.jax_params())

    def load_jax(self, params: dict):
        self.geo.load_jax(params["geo"])
        self.rgb.load_jax(params["rgb"])


def spherical_harmonics_apply(sh_coeffs: torch.Tensor, dirs: torch.Tensor,
                              deg: int) -> torch.Tensor:
    """(..., 3, (deg+1)^2) coefficients at (..., 3) dirs -> (..., 3) rgb,
    sigmoid of the SH color."""
    from envgs_tpu_torch.utils.sh import eval_sh_color

    return torch.sigmoid(eval_sh_color(deg, sh_coeffs, dirs))


def contract(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """mip-NeRF 360's contraction: points beyond `radius` map into the
    [radius, 2 radius) shell. (At x = 0 the norm's gradient is NaN in the
    JAX package, 0 here.)"""
    n = torch.linalg.norm(x, dim=-1, keepdim=True) / radius
    return torch.where(n <= 1.0, x, (2.0 - 1.0 / n) * x / n)


def empty_regressor(feat: torch.Tensor) -> torch.Tensor:
    """An output of width 0."""
    return feat.new_zeros((*feat.shape[:-1], 0))


def noop_regressor(feat: torch.Tensor) -> torch.Tensor:
    """The input itself."""
    return feat


def zero_regressor(feat: torch.Tensor, out_dim: int = 3) -> torch.Tensor:
    """Zeros of width out_dim."""
    return feat.new_zeros((*feat.shape[:-1], out_dim))


class _MLPHead(nn.Module):
    """A module that is one MLP: JAX's parameters are its list."""

    def jax_params(self) -> list:
        return self.mlp.jax_params()

    def load_jax(self, params: list):
        self.mlp.load_jax(params)


class DisplacementRegressor(_MLPHead):
    """dxyz = scale * tanh-MLP(feat); with zero_canonical, 0 where t == 0
    (the canonical frame of a deformation field)."""

    def __init__(self, in_dim: int, out_dim: int = 3, width: int = 256,
                 depth: int = 8, scale: float = 0.15,
                 zero_canonical: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.scale, self.zero_canonical = scale, zero_canonical
        self.mlp = MLP(in_dim, width, depth, out_dim, skips=(),
                       out_actvn="tanh", generator=generator, device=device)

    def forward(self, feat: torch.Tensor, t=None) -> torch.Tensor:
        dxyz = self.mlp(feat) * self.scale
        if self.zero_canonical and t is not None:
            tb = torch.broadcast_to(torch.as_tensor(
                t, dtype=feat.dtype, device=feat.device),
                dxyz.shape[:-1])[..., None]
            dxyz = torch.where(tb == 0.0, torch.zeros_like(dxyz), dxyz)
        return dxyz


class ResidualRegressor(_MLPHead):
    """cat([feat, relu-MLP(feat)]), the MLP's width out_dim (default
    in_dim)."""

    def __init__(self, in_dim: int, width: int = 256, depth: int = 2,
                 out_dim: int | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.mlp = MLP(in_dim, width, depth, out_dim or in_dim, skips=(),
                       out_actvn="relu", generator=generator, device=device)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.cat([feat, self.mlp(feat)], dim=-1)


def se3_exp_rt(screw: torch.Tensor) -> torch.Tensor:
    """The SE(3) exponential of a (..., 6) screw (v, w) -> (..., 6) rt =
    (axis-angle w, translation V(w) v), V the left Jacobian of SO(3):
    t = v + B w x v + C w x (w x v), B and C by their Taylor forms below
    |w|^2 = 1e-12 (the square root taken of a safe value)."""
    v, w = screw[..., :3], screw[..., 3:]
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = t2 < 1e-12
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    Cc = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                     (th - torch.sin(th)) / (t2s * th))
    wxv = torch.cross(w, v, dim=-1)
    wxwxv = torch.cross(w, wxv, dim=-1)
    return torch.cat([w, v + B * wxv + Cc * wxwxv], dim=-1)


class SE3Regressor(_MLPHead):
    """MLP -> screw -> se3_exp_rt, the head scaled by 1e-4 at start (near
    the identity)."""

    def __init__(self, in_dim: int, width: int = 256, depth: int = 8,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.mlp = MLP(in_dim, width, depth, 6, skips=(),
                       generator=generator, device=device)
        with torch.no_grad():
            self.mlp.weights[-1].mul_(1e-4)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return se3_exp_rt(self.mlp(feat))


def _blend_sources(mlp: MLP, geo_feat: torch.Tensor,
                   src_feat: torch.Tensor) -> torch.Tensor:
    """The sources' colors (src_feat's last 3 channels, (S, ..., C))
    blended by softmax over S of mlp([geo_feat, src_feat])."""
    g = torch.broadcast_to(geo_feat[None],
                           (src_feat.shape[0], *geo_feat.shape))
    bw = torch.softmax(mlp(torch.cat([g, src_feat], dim=-1)), dim=0)
    return torch.sum(src_feat[..., -3:] * bw, dim=0)


class ImageBasedRegressor(_MLPHead):
    """sigmoid of the sources' colors blended by a learned softmax over
    the sources (src_feat (S, ..., C), rgb in its last 3 channels)."""

    def __init__(self, geo_dim: int, src_dim: int, width: int = 64,
                 depth: int = 1, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.mlp = MLP(geo_dim + src_dim, width, depth, 1, skips=(),
                       generator=generator, device=device)

    def forward(self, geo_feat: torch.Tensor,
                src_feat: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(_blend_sources(self.mlp, geo_feat, src_feat))


class ImageBasedSphericalHarmonics(nn.Module):
    """The blended source colors (no sigmoid) plus a specular residual
    tanh(SH(sh_mlp(xyz_feat), dirs)) * resd_limit, clipped to [0, 1]. JAX's
    parameters: dict(blend=[...], sh=[...])."""

    def __init__(self, xyz_dim: int, src_dim: int, sh_deg: int = 2,
                 resd_limit: float = 0.25, width: int = 64, depth: int = 1,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        from envgs_tpu_torch.utils.sh import num_sh_coeffs

        self.sh_deg, self.resd_limit = sh_deg, resd_limit
        self.blend = ImageBasedRegressor(xyz_dim, src_dim, width, depth,
                                         generator, device)
        self.sh_mlp = MLP(xyz_dim, width, depth, 3 * num_sh_coeffs(sh_deg),
                          skips=(), generator=generator, device=device)

    def forward(self, xyz_feat: torch.Tensor, src_feat: torch.Tensor,
                dirs: torch.Tensor) -> torch.Tensor:
        from envgs_tpu_torch.utils.sh import eval_sh, num_sh_coeffs

        rgb = _blend_sources(self.blend.mlp, xyz_feat, src_feat)
        sh = self.sh_mlp(xyz_feat)
        sh = sh.reshape(*sh.shape[:-1], 3, num_sh_coeffs(self.sh_deg))
        resd = torch.tanh(eval_sh(self.sh_deg, sh, dirs)) * self.resd_limit
        return jclip(rgb + resd, 0.0, 1.0)

    def jax_params(self) -> dict:
        return dict(blend=self.blend.jax_params(),
                    sh=self.sh_mlp.jax_params())

    def load_jax(self, params: dict):
        self.blend.load_jax(params["blend"])
        self.sh_mlp.load_jax(params["sh"])

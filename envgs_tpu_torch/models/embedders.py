"""Coordinate embedders (port of envgs_tpu/models/embedders.py, the
reference's embedder zoo):

- `positional_encoding` / `pe_dim`: NeRF Fourier features, per frequency
  [sin of the coordinates, cos of the coordinates] after the input, with
  the annealing window `alpha`;
- `HashEmbedder`: the multiresolution hash grid (iNGP), trilinear over 8
  hashed corners a level; the hash wraps in 32 bits as the JAX package's
  uint32 arithmetic does;
- `LatentCodeEmbedder`, `composed_xyzt`, `SpacetimeEmbedder`: learned
  per-frame / per-view codes and their concatenation;
- `KPlanesEmbedder`: the K-Planes factored spatio-temporal grid. One 2D
  feature plane per coordinate pair — (xy, xz, yz), plus (xt, yt, zt) when
  `n_frames` > 1 — bilinearly interpolated and multiplied across planes
  (the Hadamard combination), the multiscale levels concatenated;
- `DeformationEmbedder`: the D-NeRF warp x + MLP(PE(x), PE(t));
- `empty_embedder`, `noop_embedder`, `sh_dir_encoding`, `depth_embedder`,
  `ibr_embedder`: functions of the inputs alone.

Modules keep the JAX package's parameter layout: `jax_params()` gives the
JAX parameter tree holding the module's own tensors, `load_jax` copies one
in (K-Planes' planes under the JAX keys `l<level>_s<a><b>` /
`l<level>_t<a>`, in its (R0, R1, F) layout). Initial values come from a
`torch.Generator`, not the JAX package's draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from envgs_tpu_torch.models.regressors import MLP, jclip, jmax

SPATIAL_PAIRS = ((0, 1), (0, 2), (1, 2))


def positional_encoding(x: torch.Tensor, n_freqs: int = 10,
                        include_input: bool = True,
                        alpha=None) -> torch.Tensor:
    """NeRF Fourier features: [x, sin(2^k x), cos(2^k x)], k < n_freqs, the
    sines and cosines of one frequency side by side ((..., L, 2D) flattened:
    the order the carried weights expect). `alpha` in [0, n_freqs] weights
    frequency k by (1 - cos(pi clamp(alpha - k, 0, 1))) / 2 (the annealed
    coarse-to-fine window)."""
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # (..., L, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # (..., L, 2D)
    if alpha is not None:
        k = torch.arange(n_freqs, dtype=torch.float32, device=x.device)
        a = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
        w = (1.0 - torch.cos(math.pi * torch.clamp(a - k, 0.0, 1.0))) / 2.0
        enc = enc * w[:, None]
    enc = enc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])
    return torch.cat([x, enc], dim=-1) if include_input else enc


def pe_dim(in_dim: int, n_freqs: int, include_input: bool = True) -> int:
    return in_dim * (2 * n_freqs + (1 if include_input else 0))


# iNGP's primes; the products wrap at 2^32 (the JAX package's uint32)
_PRIMES = (1, 2654435761, 805459861)
_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


class HashEmbedder(nn.Module):
    """x (..., 3) in `bounds` -> (..., n_levels * n_features): per level a
    table of 2^log2_hashmap_size feature rows, the 8 corners of the cell
    about x hashed ((c0 * 1) ^ (c1 * 2654435761) ^ (c2 * 805459861), each
    product taken modulo 2^32, then modulo the table size), trilinearly
    weighted. Tables start at U(-1e-4, 1e-4) (iNGP)."""

    def __init__(self, n_levels: int = 16, n_features: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 finest_resolution: int = 2048,
                 bounds: tuple = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_levels, self.n_features = n_levels, n_features
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.finest_resolution = finest_resolution
        self.bounds = bounds
        T = 1 << log2_hashmap_size
        self.tables = nn.Parameter(
            torch.rand((n_levels, T, n_features), generator=generator,
                       device=device) * 2e-4 - 1e-4)

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def resolutions(self) -> np.ndarray:
        b = np.exp((np.log(self.finest_resolution)
                    - np.log(self.base_resolution))
                   / max(self.n_levels - 1, 1))
        return np.floor(self.base_resolution * b ** np.arange(self.n_levels)
                        ).astype(np.int64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        T = 1 << self.log2_hashmap_size
        lo = torch.tensor(self.bounds[0], dtype=torch.float32, device=dev)
        hi = torch.tensor(self.bounds[1], dtype=torch.float32, device=dev)
        u = jclip((x - lo) / (hi - lo), 0.0, 1.0).reshape(-1, 3)
        corners = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)
        primes = torch.tensor(_PRIMES, dtype=torch.int64, device=dev)
        feats = []
        for li, res in enumerate(self.resolutions):
            p = u * float(res)
            p0 = torch.floor(p)
            w = p - p0  # (N, 3)
            cell = p0.to(torch.int64)[:, None, :] + corners[None]  # (N, 8, 3)
            idx = (cell * primes) & 0xFFFFFFFF
            h = (idx[..., 0] ^ idx[..., 1] ^ idx[..., 2]) % T
            cf = self.tables[li][h]  # (N, 8, F)
            wc = torch.stack([
                torch.where(corners[None, :, d] == 1, w[:, None, d],
                            1.0 - w[:, None, d]) for d in range(3)],
                -1).prod(-1)  # (N, 8)
            feats.append(torch.sum(cf * wc[..., None], dim=1))
        out = torch.cat(feats, dim=-1)
        return out.reshape(*x.shape[:-1], self.out_dim)

    def jax_params(self) -> torch.Tensor:
        return self.tables

    @torch.no_grad()
    def load_jax(self, tables):
        self.tables.copy_(torch.tensor(np.asarray(tables)))


class LatentCodeEmbedder(nn.Module):
    """A learned code per frame: t_idx -> codes[t_idx]; codes start at
    0.01 N(0, 1)."""

    def __init__(self, n_codes: int = 1, out_dim: int = 8,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_codes, self.out_dim = n_codes, out_dim
        self.codes = nn.Parameter(torch.randn(
            (n_codes, out_dim), generator=generator, device=device) * 0.01)

    def forward(self, t_idx) -> torch.Tensor:
        return self.codes[torch.as_tensor(t_idx, dtype=torch.int64,
                                          device=self.codes.device)]

    def jax_params(self) -> torch.Tensor:
        return self.codes

    @torch.no_grad()
    def load_jax(self, codes):
        self.codes.copy_(torch.tensor(np.asarray(codes)))


def composed_xyzt(xyz_feat: torch.Tensor, t_feat: torch.Tensor
                  ) -> torch.Tensor:
    """xyz features with the time features broadcast beside them."""
    t_feat = torch.broadcast_to(t_feat,
                                (*xyz_feat.shape[:-1], t_feat.shape[-1]))
    return torch.cat([xyz_feat, t_feat], dim=-1)


class KPlanesEmbedder(nn.Module):
    """x (..., 3) in `bounds`, t in [0, 1] -> (..., out_dim) features.

    Planes start at 1 + 0.1 N(0, 1) (drawn from `generator`; not the JAX
    package's draws) so that the product starts informative."""

    def __init__(self, n_features: int = 8, resolutions: tuple = (64, 128),
                 time_resolution: int = 25, n_frames: int = 1,
                 bounds: tuple = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_features = n_features
        self.resolutions = tuple(resolutions)
        self.time_resolution = time_resolution
        self.n_frames = n_frames
        self.bounds = bounds
        planes = {}
        for li, res in enumerate(self.resolutions):
            shapes = [(f"l{li}_s{a}{b}", (res, res)) for a, b in SPATIAL_PAIRS]
            if n_frames > 1:
                shapes += [(f"l{li}_t{a}", (res, time_resolution))
                           for a in range(3)]
            for name, (r0, r1) in shapes:
                planes[name] = nn.Parameter(1.0 + 0.1 * torch.randn(
                    (r0, r1, n_features), generator=generator,
                    device=device))
        self.planes = nn.ParameterDict(planes)

    @property
    def out_dim(self) -> int:
        return len(self.resolutions) * self.n_features

    @staticmethod
    def _interp2(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """plane (R0, R1, F); u / v (...,) in [0, 1] -> (..., F) bilinear."""
        R0, R1 = plane.shape[:2]
        x = u * (R0 - 1)
        y = v * (R1 - 1)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, R0 - 2)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, R1 - 2)
        wx = (x - x0)[..., None]
        wy = (y - y0)[..., None]
        return (plane[x0, y0] * (1 - wx) * (1 - wy)
                + plane[x0 + 1, y0] * wx * (1 - wy)
                + plane[x0, y0 + 1] * (1 - wx) * wy
                + plane[x0 + 1, y0 + 1] * wx * wy)

    def forward(self, x: torch.Tensor, t=0.0) -> torch.Tensor:
        """x (..., 3); t a scalar or (...,) in [0, 1] -> (..., out_dim)."""
        lo = torch.tensor(self.bounds[0], dtype=torch.float32,
                          device=x.device)
        hi = torch.tensor(self.bounds[1], dtype=torch.float32,
                          device=x.device)
        u = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
        t = torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32,
                                               device=x.device), x.shape[:-1])
        outs = []
        for li in range(len(self.resolutions)):
            f = torch.ones((*x.shape[:-1], self.n_features), device=x.device)
            for a, b in SPATIAL_PAIRS:
                f = f * self._interp2(self.planes[f"l{li}_s{a}{b}"],
                                      u[..., a], u[..., b])
            if self.n_frames > 1:
                for a in range(3):
                    f = f * self._interp2(self.planes[f"l{li}_t{a}"],
                                          u[..., a], t)
            outs.append(f)
        return torch.cat(outs, dim=-1)


class DeformationEmbedder(nn.Module):
    """The D-NeRF warp: x (..., 3), t -> x + MLP(PE(x), PE(t)), `depth`
    hidden ReLU layers of `width`, the head zero at start (the identity
    warp). JAX's parameter list [(w, b), ...] is the MLP's."""

    def __init__(self, xyz_freqs: int = 6, t_freqs: int = 4, width: int = 64,
                 depth: int = 3, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.xyz_freqs, self.t_freqs = xyz_freqs, t_freqs
        self.width, self.depth = width, depth
        din = pe_dim(3, xyz_freqs) + pe_dim(1, t_freqs)
        self.mlp = MLP(din, width, depth, 3, skips=(), generator=generator,
                       device=device)
        with torch.no_grad():
            self.mlp.weights[-1].zero_()

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        t = torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32,
                                               device=x.device), x.shape[:-1])
        h = torch.cat([positional_encoding(x, self.xyz_freqs),
                       positional_encoding(t[..., None], self.t_freqs)], -1)
        return x + self.mlp(h)

    def jax_params(self) -> list:
        return self.mlp.jax_params()

    def load_jax(self, params: list):
        self.mlp.load_jax(params)


def empty_embedder(x: torch.Tensor) -> torch.Tensor:
    """A feature of width 0."""
    return x.new_zeros((*x.shape[:-1], 0))


def noop_embedder(x: torch.Tensor) -> torch.Tensor:
    """The input itself."""
    return x


def sh_dir_encoding(dirs: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """The real-SH basis of degree - 1 at the (unit) dirs: degree^2
    features (the reference's TcnnDirEmbedder)."""
    from envgs_tpu_torch.utils.sh import sh_basis

    return sh_basis(degree - 1, dirs)


class SpacetimeEmbedder(nn.Module):
    """A per-view and a per-frame latent code, concatenated. JAX's
    parameters: dict(space=codes, time=codes)."""

    def __init__(self, n_views: int = 4, n_frames: int = 1,
                 space_dim: int = 8, time_dim: int = 8,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.space = LatentCodeEmbedder(n_views, space_dim, generator, device)
        self.time = LatentCodeEmbedder(n_frames, time_dim, generator, device)

    @property
    def out_dim(self) -> int:
        return self.space.out_dim + self.time.out_dim

    def forward(self, v_idx, t_idx) -> torch.Tensor:
        return torch.cat([self.space(v_idx), self.time(t_idx)], dim=-1)

    def jax_params(self) -> dict:
        return dict(space=self.space.codes, time=self.time.codes)

    def load_jax(self, params: dict):
        self.space.load_jax(params["space"])
        self.time.load_jax(params["time"])


def depth_embedder(xyz: torch.Tensor, K, R, T,
                   normalize: bool = False) -> torch.Tensor:
    """Camera-space depth of world points, (..., 1); `normalize`
    standardizes it over the points (axis -2, the population std)."""
    z = xyz @ R.T[:, 2:3] + T[2]
    if normalize:
        mu = torch.mean(z, dim=-2, keepdim=True)
        sd = torch.std(z, dim=-2, keepdim=True, unbiased=False)
        z = (z - mu) / jmax(sd, 1e-8)
    return z


def ibr_embedder(xyz: torch.Tensor, src_feats: torch.Tensor, src_cams: list,
                 agg: str = "meanvar") -> torch.Tensor:
    """Image-based features of world points: each point projected into
    every source view (src_feats (S, H, W, C), src_cams S cameras) and its
    feature map sampled bilinearly. agg "meanvar" -> (..., 2C), the mean
    and variance over the sources that see the point; "stack" -> (S, ...,
    C + 1), each source's feature and its inside flag."""
    from envgs_tpu_torch.models.enerf import _bilinear, _project

    feats, insides = [], []
    for feat, cam in zip(src_feats, src_cams):
        Hs, Ws = feat.shape[0], feat.shape[1]
        x, y, z = _project(xyz, cam.K, cam.R, cam.T)
        inside = ((z > 1e-6) & (x >= 0) & (x <= Ws - 1)
                  & (y >= 0) & (y <= Hs - 1))
        feats.append(_bilinear(feat, jclip(x, 0, Ws - 1),
                               jclip(y, 0, Hs - 1)))
        insides.append(inside)
    F = torch.stack(feats)  # (S, ..., C)
    M = torch.stack(insides)[..., None].to(F.dtype)  # (S, ..., 1)
    if agg == "stack":
        return torch.cat([F, M], dim=-1)
    n = jmax(M.sum(0), 1.0)
    mean = (F * M).sum(0) / n
    var = ((F - mean) ** 2 * M).sum(0) / n
    return torch.cat([mean, var], dim=-1)

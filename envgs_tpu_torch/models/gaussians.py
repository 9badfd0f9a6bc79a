"""Fixed-capacity padded Gaussian-surfel pool (port of the render-path part
of envgs_tpu/models/gaussians.py).

The pool keeps the JAX package's layout: raw (pre-activation) parameter
tensors of a static capacity `cap` plus an `active` mask, so masked arrays
compare one to one and weights cross between the packages through
`pool_from_numpy` / `pool_to_numpy` under the JAX field names.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.utils.knn import init_scales_from_dist
from envgs_tpu_torch.utils.sh import num_sh_coeffs, rgb2sh0


def scaling_activation(x):
    return torch.exp(x)


def sigmoid(x):
    return torch.sigmoid(x)


def logit(x):
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), 1e-6, 1 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


class GaussianParams(NamedTuple):
    """Learnable raw parameters (leading dim = pool capacity)."""

    xyz: torch.Tensor  # (N, 3)
    features_dc: torch.Tensor  # (N, 1, 3) SH degree-0
    features_rest: torch.Tensor  # (N, K-1, 3) higher SH
    scaling: torch.Tensor  # (N, 2) log-scale
    rotation: torch.Tensor  # (N, 4) wxyz, unnormalized
    opacity: torch.Tensor  # (N, 1) logit
    specular: torch.Tensor  # (N, S) logit
    roughness: torch.Tensor  # (N, 1) logit


class GaussianStats(NamedTuple):
    """Non-learnable pool state."""

    active: torch.Tensor  # (N,) bool
    max_radii2d: torch.Tensor  # (N,)
    grad_accum: torch.Tensor  # (N,)
    weight_accum: torch.Tensor  # (N,)
    denom: torch.Tensor  # (N,)
    sh_degree: torch.Tensor  # () int32 active SH degree


class GaussianPool(NamedTuple):
    params: GaussianParams
    stats: GaussianStats
    max_sh_degree: int

    @property
    def cap(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def get_scaling(self):
        return scaling_activation(self.params.scaling)

    @property
    def get_opacity(self):
        return sigmoid(self.params.opacity)

    @property
    def get_specular(self):
        return sigmoid(self.params.specular)

    @property
    def get_roughness(self):
        return sigmoid(self.params.roughness)

    @property
    def get_features(self):
        return torch.cat([self.params.features_dc, self.params.features_rest],
                         dim=1)


def pool_from_numpy(params: dict, stats: dict, max_sh_degree: int,
                    device: torch.device | str | None = None) -> GaussianPool:
    """Build a pool from numpy arrays keyed by the JAX field names
    (GaussianParams / GaussianStats of envgs_tpu). Keys the port does not
    have (the temporal fields, None in the static families) must be absent
    or None."""
    extra = [k for k, v in params.items()
             if v is not None and k not in GaussianParams._fields]
    if extra:
        raise ValueError(f"parameters the port does not carry: {extra}")

    def t(x, dtype):  # a copy: the pool never aliases the caller's arrays
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    p = GaussianParams(**{k: t(params[k], torch.float32)
                          for k in GaussianParams._fields})
    s = GaussianStats(
        active=t(stats["active"], torch.bool),
        max_radii2d=t(stats["max_radii2d"], torch.float32),
        grad_accum=t(stats["grad_accum"], torch.float32),
        weight_accum=t(stats["weight_accum"], torch.float32),
        denom=t(stats["denom"], torch.float32),
        sh_degree=t(stats["sh_degree"], torch.int32),
    )
    return GaussianPool(p, s, int(max_sh_degree))


def pool_to_numpy(pool: GaussianPool) -> tuple[dict, dict]:
    """(params, stats) numpy dicts under the JAX field names."""
    return ({k: v.detach().cpu().numpy() for k, v in pool.params._asdict().items()},
            {k: v.detach().cpu().numpy() for k, v in pool.stats._asdict().items()})


def create_pool(
    xyz: np.ndarray,
    colors: np.ndarray | None,
    cap: int,
    sh_degree: int = 3,
    init_sh_degree: int = 0,
    init_opacity: float = 0.1,
    init_scales: np.ndarray | None = None,
    specular_channels: int = 1,
    init_specular: float = 1e-3,
    init_roughness: float = 0.5,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> GaussianPool:
    """Build a pool from an initial point cloud (host-side numpy, then moved
    to `device`): 3-NN scales, random rotations from
    `np.random.default_rng(seed)`, constant opacity/specular/roughness —
    the same draws as envgs_tpu's create_pool."""
    P = int(xyz.shape[0])
    assert P <= cap, f"init points {P} exceed pool capacity {cap}"
    K = num_sh_coeffs(sh_degree)
    rng = np.random.default_rng(seed)

    f_dc = np.zeros((cap, 1, 3), np.float32)
    if colors is not None:
        f_dc[:P, 0] = rgb2sh0(torch.as_tensor(colors, dtype=torch.float32)).numpy()
    f_rest = np.zeros((cap, K - 1, 3), np.float32)

    scales = np.zeros((cap, 2), np.float32)
    if init_scales is not None:
        scales[:P] = init_scales
    elif P > 1:
        scales[:P] = np.repeat(init_scales_from_dist(xyz)[:, :1], 2, axis=-1)

    xyz_full = np.zeros((cap, 3), np.float32)
    xyz_full[:P] = xyz
    rots = rng.random((cap, 4)).astype(np.float32)

    def const(v, width):
        return np.full((cap, width), float(logit(v)), np.float32)

    active = np.zeros((cap,), bool)
    active[:P] = True
    params = dict(xyz=xyz_full, features_dc=f_dc, features_rest=f_rest,
                  scaling=scales, rotation=rots,
                  opacity=const(init_opacity, 1),
                  specular=const(init_specular, specular_channels),
                  roughness=const(init_roughness, 1))
    zeros = np.zeros((cap,), np.float32)
    stats = dict(active=active, max_radii2d=zeros, grad_accum=zeros,
                 weight_accum=zeros, denom=zeros,
                 sh_degree=np.asarray(init_sh_degree, np.int32))
    return pool_from_numpy(params, stats, sh_degree, device)


def sh_degree_mask(active_deg: torch.Tensor, max_deg: int) -> torch.Tensor:
    """(K,) 0/1 mask enabling SH coefficients of degree <= active_deg."""
    K = num_sh_coeffs(max_deg)
    idx = torch.arange(K, device=active_deg.device)
    deg_of = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return (deg_of <= active_deg).to(torch.float32)

"""Fixed-capacity padded Gaussian pool (port of envgs_tpu/models/
gaussians.py without the EnvGS-only resets): the pool, its weight bridge,
densification-statistic accumulation, the SH degree bump, adaptive density
control (`densify_and_prune`) and the opacity reset.

The pool keeps the JAX package's layout: raw (pre-activation) parameter
tensors of a static capacity `cap` plus an `active` mask, so masked arrays
compare one to one and weights cross between the packages through
`pool_from_numpy` / `pool_to_numpy` under the JAX field names. Surfel pools
carry 2 scale axes, 3DGS pools 3 (`create_pool(scale_axes=...)`).

Maintenance keeps the shapes static as the JAX package does: children are
written into free (inactive) slots, parents are deactivated, and the Adam
moments of every slot that receives a child are zeroed. The split offsets
are drawn from a `torch.Generator` (or handed in as `eps`), so they are not
the JAX package's draws.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.utils.knn import init_scales_from_dist
from envgs_tpu_torch.utils.sh import num_sh_coeffs, rgb2sh0
from envgs_tpu_torch.utils.transforms import quat_to_rotmat


def scaling_activation(x):
    return torch.exp(x)


def scaling_inverse(x):
    return torch.log(torch.clamp(x, 1e-6, 1e6))


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
    scaling: torch.Tensor  # (N, 2) log-scale; (N, 3) in 3DGS pools
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
    scale_axes: int = 2,
    device: torch.device | str | None = None,
) -> GaussianPool:
    """Build a pool from an initial point cloud (host-side numpy, then moved
    to `device`): 3-NN scales, random rotations from
    `np.random.default_rng(seed)`, constant opacity/specular/roughness —
    the same draws as envgs_tpu's create_pool. scale_axes: 2 = surfels
    (2DGS), 3 = full 3D Gaussians (the 3DGS family)."""
    P = int(xyz.shape[0])
    assert P <= cap, f"init points {P} exceed pool capacity {cap}"
    K = num_sh_coeffs(sh_degree)
    rng = np.random.default_rng(seed)

    f_dc = np.zeros((cap, 1, 3), np.float32)
    if colors is not None:
        f_dc[:P, 0] = rgb2sh0(torch.as_tensor(colors, dtype=torch.float32)).numpy()
    f_rest = np.zeros((cap, K - 1, 3), np.float32)

    scales = np.zeros((cap, scale_axes), np.float32)
    if init_scales is not None:
        scales[:P] = init_scales
    elif P > 1:
        scales[:P] = np.repeat(init_scales_from_dist(xyz)[:, :1], scale_axes,
                               axis=-1)

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


def oneup_sh_degree(pool: GaussianPool) -> GaussianPool:
    new = torch.clamp(pool.stats.sh_degree + 1, max=pool.max_sh_degree)
    return pool._replace(stats=pool.stats._replace(sh_degree=new))


def accumulate_stats(
    stats: GaussianStats,
    screen_grad: torch.Tensor,  # (N, 2 or 3) gradient of the position hook
    visibility: torch.Tensor,  # (N,) bool
    weight: torch.Tensor | None = None,  # (N,) per-splat blend weight sums
    radii: torch.Tensor | None = None,  # (N,) screen radii
) -> GaussianStats:
    """add_densification_stats: visible active splats count one more view
    and add their position-gradient norm, blend weight and max radius."""
    vis = visibility & stats.active
    gnorm = torch.linalg.vector_norm(screen_grad, dim=-1)
    stats = stats._replace(
        denom=stats.denom + vis.to(torch.float32),
        grad_accum=stats.grad_accum + torch.where(vis, gnorm, 0.0),
    )
    if weight is not None:
        stats = stats._replace(
            weight_accum=stats.weight_accum + torch.where(vis, weight, 0.0))
    if radii is not None:
        stats = stats._replace(max_radii2d=torch.where(
            vis, torch.maximum(stats.max_radii2d, radii), stats.max_radii2d))
    return stats


def _avg(accum, denom):
    return torch.where(denom > 0, accum / torch.clamp(denom, min=1.0), 0.0)


def _masked_quantile(x, mask, q):
    """Quantile of x over mask=True entries (linear interpolation)."""
    xs = torch.sort(torch.where(mask, x, float("inf"))).values
    n = mask.sum()
    pos = q * torch.clamp(n - 1, min=0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    v = xs[lo] * (1 - frac) + xs[hi] * frac
    return torch.where(n > 0, v, 0.0)


class DensifyConfig(NamedTuple):
    densify_grad_threshold: float = 0.0002
    densify_size_threshold: float = 0.01
    min_opacity: float = 0.05
    min_gradient: float | None = None
    split_screen_threshold: float | None = None
    max_scene_threshold: float | None = 0.1
    max_screen_threshold: float | None = None
    min_weight_threshold: float | None = None
    prune_large_gs: bool = True
    prune_visibility: bool = False
    spatial_scale: float = 1.0
    max_gs: int = 2_000_000
    max_gs_threshold: float = 0.9
    split_ratio: float = 0.8  # children scale divisor = ratio * N
    split_n: int = 2
    # the weight-quantile split (too big, not low weight): the reference's
    # split(mask, N=5, ratio=0.5)
    weight_split_n: int = 5
    weight_split_ratio: float = 0.5


def _write_children(params: GaussianParams, adam_tree, child: GaussianParams,
                    want: torch.Tensor, slots: torch.Tensor):
    """Copy the wanted rows of `child` into `slots` (slots == cap: no free
    slot, dropped) and zero the Adam moments there."""
    cap = params.xyz.shape[0]
    land = want & (slots < cap)
    dst, src = slots[land], land.nonzero()[:, 0]

    def put(t, rows):
        t = t.clone()
        t[dst] = rows
        return t

    params = type(params)(*(put(d, s[src]) for d, s in zip(params, child)))
    if adam_tree is not None:
        adam_tree = type(adam_tree)(
            type(m)(*(put(x, 0.0) for x in m)) for m in adam_tree)
    return params, adam_tree


def densify_and_prune(pool: GaussianPool, adam_tree, cfg: DensifyConfig,
                      generator: torch.Generator | None = None,
                      eps: list | None = None):
    """One adaptive-density-control step (envgs_tpu's densify_and_prune).

    Decision masks come from the pre-step statistics; clones, then the
    children of the gradient split (split_n of them) and of the
    weight-quantile split (weight_split_n), take the free slots in order
    (dropped when the pool is full); parents of splits and pruned splats
    are deactivated, and every statistic is reset. `adam_tree` is a tuple
    of GaussianParams of moments (mu, nu) or None; moments at slots that
    receive children are zeroed. The split offsets are
    R @ (eps_i * scales): eps, when given, is the list of split_n +
    weight_split_n (cap, 3) standard normals in that order, else they are
    drawn from `generator`. -> (pool, adam_tree)."""
    p, s = pool.params, pool.stats
    cap = pool.cap
    dev = p.xyz.device
    active = s.active
    grads = _avg(s.grad_accum, s.denom)
    weights = _avg(s.weight_accum, s.denom)
    scal = scaling_activation(p.scaling)
    max_scale = scal.amax(-1)
    high_grad = grads >= cfg.densify_grad_threshold

    size = cfg.densify_size_threshold * cfg.spatial_scale
    clone_mask = active & high_grad & (max_scale <= size)
    split_big = max_scale > size
    if cfg.split_screen_threshold is not None:
        split_big = split_big | (s.max_radii2d > cfg.split_screen_threshold)
    split_mask = active & high_grad & split_big

    prune = active & (sigmoid(p.opacity[:, 0]) < cfg.min_opacity)
    if cfg.min_gradient is not None:
        prune = prune | (active & (grads <= cfg.min_gradient) & (s.denom > 0))

    weight_split_mask = torch.zeros_like(active)
    if cfg.prune_large_gs:
        too_big = torch.zeros_like(active)
        if cfg.max_screen_threshold is not None:
            too_big = too_big | (s.max_radii2d > cfg.max_screen_threshold)
        if cfg.max_scene_threshold is not None:
            too_big = too_big | (
                max_scale > cfg.spatial_scale * cfg.max_scene_threshold)
        too_big = too_big & active
        if cfg.min_weight_threshold is not None:
            wq = _masked_quantile(weights, active, cfg.min_weight_threshold)
            low_w = weights < wq
            prune = prune | (too_big & low_w)
            weight_split_mask = too_big & ~low_w
        else:
            prune = prune | too_big
    # a gradient-split parent never splits under the weight recipe as well
    weight_split_mask = weight_split_mask & ~split_mask
    parents_gone = prune | split_mask | weight_split_mask

    # the k-th free slot, `cap` past the last one
    free = ~active
    free_slots = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
    free_slots[torch.where(free, torch.cumsum(free, 0) - 1, cap)] = (
        torch.arange(cap, device=dev))
    free_slots = free_slots[:cap]
    base = 0
    new_active = active & ~parents_gone

    def alloc(want):
        nonlocal base, new_active
        rank = torch.cumsum(want, 0) - 1
        slots = free_slots[torch.clamp(base + rank, 0, cap - 1)]
        base = base + want.sum()
        new_active = new_active.clone()
        new_active[slots[want & (slots < cap)]] = True
        return slots

    params, adam_tree = _write_children(p, adam_tree, p, clone_mask,
                                        alloc(clone_mask))
    R = quat_to_rotmat(p.rotation)
    stds3 = scal if scal.shape[-1] == 3 else torch.cat(
        [scal, torch.zeros_like(scal[:, :1])], dim=-1)
    groups = [(split_mask, cfg.split_n, cfg.split_ratio),
              (weight_split_mask, cfg.weight_split_n, cfg.weight_split_ratio)]
    k = 0
    for mask_g, n_g, ratio_g in groups:
        child_scaling = scaling_inverse(scal / (ratio_g * n_g))
        for _ in range(n_g):
            e = (eps[k].to(dev) if eps is not None else torch.randn(
                stds3.shape, generator=generator, device=dev))
            k += 1
            offs = torch.einsum("nij,nj->ni", R, e * stds3)
            child = p._replace(xyz=p.xyz + offs, scaling=child_scaling)
            params, adam_tree = _write_children(params, adam_tree, child,
                                                mask_g, alloc(mask_g))

    if cfg.prune_visibility:  # budget: drop the lowest-weight splats
        target = int(cfg.max_gs * cfg.max_gs_threshold)
        # children have no weight statistics yet: exempt
        w_eff = torch.where(active & new_active, weights, float("inf"))
        order = torch.argsort(w_eff, stable=True)
        kill_rank = torch.empty_like(order)
        kill_rank[order] = torch.arange(cap, device=dev)
        new_active = new_active & ~(kill_rank < new_active.sum() - target)

    zeros = torch.zeros((cap,), dtype=torch.float32, device=dev)
    stats = GaussianStats(active=new_active, max_radii2d=zeros,
                          grad_accum=zeros.clone(), weight_accum=zeros.clone(),
                          denom=zeros.clone(), sh_degree=s.sh_degree)
    return GaussianPool(params, stats, pool.max_sh_degree), adam_tree


def _zero_adam_for(adam_tree, field: str):
    """Zero the optimizer moments of one GaussianParams field."""
    if adam_tree is None:
        return None
    return type(adam_tree)(
        m._replace(**{field: torch.zeros_like(getattr(m, field))})
        for m in adam_tree)


def reset_opacity(pool: GaussianPool, adam_tree, value: float = 0.01):
    """Clamp the activated opacity to at most `value`; zero its moments."""
    new = torch.minimum(pool.params.opacity,
                        logit(value).to(pool.params.opacity.device))
    return (pool._replace(params=pool.params._replace(opacity=new)),
            _zero_adam_for(adam_tree, "opacity"))

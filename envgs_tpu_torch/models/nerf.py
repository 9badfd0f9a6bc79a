"""NeRF model family (port of envgs_tpu/models/nerf.py): stratified and
hierarchical (inverse-CDF) ray sampling, the PE-embedded SplitRegressor
field over the (rays, samples) batch, quadrature volume rendering, and the
ray-batch train step with optax's Adam written out.

The jitter of the samplers is a uniform draw per round: from a
`torch.Generator`, or handed in (`draws`, one (rays, samples) tensor a
round) so that a caller can replay another source's draws; with neither
the samplers take their evaluation positions (bin centres, an even grid of
the CDF). The importance samples are not detached: the gradient flows
through the inverse CDF into the coarse weights, as the JAX package's does.
The family launches no kernel of the repo: matmuls, cumprods and sorts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from envgs_tpu_torch.models.embedders import (
    pe_dim,
    positional_encoding,
    sh_dir_encoding,
)
from envgs_tpu_torch.models.regressors import SplitRegressor, jmax
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import (
    AdamState,
    adam_init,
    adam_update,
    grads_of,
)


def uniform_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                   generator: torch.Generator | None = None,
                   use_disparity: bool = False,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """Stratified z values: near / far (...,) -> (..., n_samples), each
    sample jittered within its stratum by `u` (..., n_samples) or a draw
    from `generator`; with neither, the strata's centres. use_disparity
    spaces the strata in inverse depth."""
    t = torch.linspace(0.0, 1.0, n_samples + 1, dtype=near.dtype,
                       device=near.device)
    lo, hi = t[:-1], t[1:]
    if u is None and generator is not None:
        u = torch.rand((*near.shape, n_samples), generator=generator,
                       dtype=near.dtype, device=near.device)
    if u is None:
        u = torch.full((*near.shape, n_samples), 0.5, dtype=near.dtype,
                       device=near.device)
    t = lo + (hi - lo) * u
    if use_disparity:
        return 1.0 / (1.0 / jmax(near[..., None], 1e-8) * (1 - t)
                      + 1.0 / jmax(far[..., None], 1e-8) * t)
    return near[..., None] * (1 - t) + far[..., None] * t


def importance_z_vals(z_vals: torch.Tensor, weights: torch.Tensor,
                      n_samples: int,
                      generator: torch.Generator | None = None,
                      eps: float = 1e-5,
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF resampling of the interior intervals' weights: z_vals
    (..., S) sorted and weights (..., S) -> (..., n_samples) sorted, at `u`
    (..., n_samples) or a draw from `generator`, else an even grid on
    [0, 1 - 1e-6]. The bin of u is the count of CDF entries <= u, less 1
    (searchsorted to the right), clipped to the interior."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])  # (..., S-1)
    w = weights[..., 1:-1] + eps
    cdf = torch.cumsum(w, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    cdf = cdf / jmax(cdf[..., -1:], eps)  # (..., S-1)
    shape = (*z_vals.shape[:-1], n_samples)
    if u is None and generator is not None:
        u = torch.rand(shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
    if u is None:
        u = torch.broadcast_to(torch.linspace(
            0.0, 1.0 - 1e-6, n_samples, dtype=z_vals.dtype,
            device=z_vals.device), shape)
    idx = torch.searchsorted(cdf.detach().contiguous(), u.contiguous(),
                             right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[-1] - 2)
    c0 = torch.gather(cdf, -1, idx)
    c1 = torch.gather(cdf, -1, idx + 1)
    m0 = torch.gather(mids, -1, idx)
    m1 = torch.gather(mids, -1, torch.clamp(idx + 1, 0, mids.shape[-1] - 1))
    t = torch.where(c1 > c0, (u - c0) / jmax(c1 - c0, eps),
                    torch.full_like(u, 0.5))
    return torch.sort(m0 + t * (m1 - m0), dim=-1).values


def volume_render(rgb: torch.Tensor, sigma: torch.Tensor,
                  z_vals: torch.Tensor, dists_scale=None,
                  bg_color: float = 0.0) -> dict:
    """Quadrature compositing: rgb (..., S, 3), sigma (..., S), z_vals
    (..., S) -> dict(rgb_map, dpt_map, acc_map, weights)."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    if dists_scale is not None:
        deltas = deltas * dists_scale[..., None]
    alpha = 1.0 - torch.exp(-sigma * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans
    acc = torch.sum(weights, -1)
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    rgb_map = rgb_map + (1.0 - acc[..., None]) * bg_color
    dpt = torch.sum(weights * z_vals, -1) / jmax(acc, 1e-8)
    return dict(rgb_map=rgb_map, dpt_map=dpt, acc_map=acc, weights=weights)


class NerfConfig(NamedTuple):
    """Static NeRF hyperparameters (the JAX package's defaults); one
    network per round with separate_levels (MultilevelNetwork). The
    direction branch: "pe" (dir_freqs) or "sh" (the SH basis of degree
    sh_dir_degree - 1)."""

    xyz_freqs: int = 10
    dir_freqs: int = 4
    width: int = 256
    depth: int = 8
    feat_dim: int = 256
    n_samples: tuple = (64, 64)  # per round; importance after round 0
    use_disparity: bool = False
    bg_brightness: float = 0.0
    separate_levels: bool = False
    dir_encoding: str = "pe"
    sh_dir_degree: int = 3

    @property
    def dir_dim(self) -> int:
        if self.dir_encoding == "sh":
            return self.sh_dir_degree ** 2
        return pe_dim(3, self.dir_freqs)

    @property
    def field_kwargs(self) -> dict:
        return dict(xyz_dim=pe_dim(3, self.xyz_freqs), dir_dim=self.dir_dim,
                    width=self.width, depth=self.depth,
                    feat_dim=self.feat_dim)

    def init(self, generator: torch.Generator | None = None,
             device=None) -> "NerfNetworks":
        return NerfNetworks(self, generator, device)


class NerfNetworks(nn.ModuleList):
    """The SplitRegressor fields: one, or one a round (separate_levels).
    JAX's parameters: the list of their dicts."""

    def __init__(self, cfg: NerfConfig,
                 generator: torch.Generator | None = None, device=None):
        n = len(cfg.n_samples) if cfg.separate_levels else 1
        super().__init__([SplitRegressor(**cfg.field_kwargs,
                                         generator=generator, device=device)
                          for _ in range(n)])

    def jax_params(self) -> list:
        return [f.jax_params() for f in self]


def nerf_params_from_jax(params: list, cfg: NerfConfig,
                         device=None) -> NerfNetworks:
    """JAX's parameter list (numpy or JAX arrays: one dict(geo=[(w, b),
    ...], rgb=[...]) a network) -> the port's networks."""
    nets = NerfNetworks(cfg, device=device)
    for net, p in zip(nets, params):
        net.load_jax(p)
    return nets


def eval_field(cfg: NerfConfig, net: SplitRegressor, xyz: torch.Tensor,
               viewdir: torch.Tensor):
    """xyz (..., 3), viewdir (..., 3) -> (rgb (..., 3), sigma (...,))."""
    xf = positional_encoding(xyz, cfg.xyz_freqs)
    if cfg.dir_encoding == "sh":
        df = sh_dir_encoding(viewdir, cfg.sh_dir_degree)
    else:
        df = positional_encoding(viewdir, cfg.dir_freqs)
    df = torch.broadcast_to(df, (*xf.shape[:-1], df.shape[-1]))
    return net(xf, df)


def render_rays_nerf(cfg: NerfConfig, nets: NerfNetworks,
                     ray_o: torch.Tensor, ray_d: torch.Tensor,
                     near: torch.Tensor, far: torch.Tensor,
                     generator: torch.Generator | None = None,
                     draws: list | None = None) -> dict:
    """Hierarchical rendering of a ray batch: ray_o / ray_d (P, 3), near /
    far (P,) -> a dict per round (`round<r>`) and the last round's maps at
    the top. `draws` (a (P, n) uniform tensor per round) or `generator`
    jitters the samples; with neither, the evaluation positions."""
    viewdir = ray_d / torch.clamp(
        torch.linalg.norm(ray_d, dim=-1, keepdim=True), min=1e-8)
    out_all: dict = {}
    z_vals = weights = None
    for rnd, n in enumerate(cfg.n_samples):
        u = None if draws is None else draws[rnd]
        if rnd == 0:
            z_vals = uniform_z_vals(near, far, n, generator,
                                    cfg.use_disparity, u=u)
        else:
            z_new = importance_z_vals(z_vals, weights, n, generator, u=u)
            z_vals = torch.sort(torch.cat([z_vals, z_new], -1), -1).values
        net = nets[rnd] if cfg.separate_levels else nets[0]
        xyz = ray_o[..., None, :] + z_vals[..., :, None] * ray_d[..., None, :]
        rgb, sigma = eval_field(cfg, net, xyz, viewdir[..., None, :])
        out = volume_render(rgb, sigma, z_vals, bg_color=cfg.bg_brightness)
        weights = out["weights"]
        out_all[f"round{rnd}"] = out
    out_all.update(out_all[f"round{len(cfg.n_samples) - 1}"])
    return out_all


def make_nerf_train_step(cfg: NerfConfig, lr: float = 5e-4):
    """-> (init, step): init(generator, device) -> (networks, AdamState);
    step(nets, state, ray_o, ray_d, near, far, target, generator=None,
    draws=None) -> (state, {"loss", "psnr"}), the networks updated in
    place: the rgb L2 of every round summed, one Adam step. `grads_out` (a
    dict) receives the gradients in the parameter tree's leaf order; `mark`
    is called with "forward", "backward" and "optimizer" as each stage is
    queued."""

    def init(generator=None, device=None):
        nets = cfg.init(generator, device)
        return nets, adam_init(tree_flatten(nets.jax_params()))

    def step(nets: NerfNetworks, state: AdamState, ray_o, ray_d, near, far,
             target, generator=None, draws=None, grads_out=None, mark=None):
        out = render_rays_nerf(cfg, nets, ray_o, ray_d, near, far, generator,
                               draws)
        loss = sum(torch.mean((out[f"round{r}"]["rgb_map"] - target) ** 2)
                   for r in range(len(cfg.n_samples)))
        if mark:
            mark("forward")
        params = tree_flatten(nets.jax_params())
        grads = grads_of(loss, params)
        if grads_out is not None:
            grads_out["grads"] = grads
        if mark:
            mark("backward")
        state = adam_update(params, grads, state, lr)
        if mark:
            mark("optimizer")
        mse = torch.mean((out["rgb_map"].detach() - target) ** 2)
        return state, dict(loss=loss.detach(),
                           psnr=-10.0 * torch.log10(mse + 1e-10))

    return init, step

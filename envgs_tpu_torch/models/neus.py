"""NeuS model family (port of envgs_tpu/models/neus.py): an SDF field
(PE-embedded MLP -> (sdf, feature)), normals as the autograd gradient of
the SDF at the samples, the section-CDF opacity of NeuS with one learnable
sharpness inv_s = exp(10 s_param), a color head on (feature, PE(dir),
normal), and the ray-batch step: rgb L2 + eikonal_weight * the eikonal
term mean((|grad| - 1)^2).

The normals are `torch.autograd.grad(..., create_graph=True)` inside the
forward, so the eikonal term and the color head's normal input send a
second-order gradient back to the SDF's weights, as JAX's `jax.grad`
inside the loss does. (At a gradient of exactly 0 the norm's gradient is
NaN in JAX, 0 here.) The family launches no kernel of the repo.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from envgs_tpu_torch.models.embedders import pe_dim, positional_encoding
from envgs_tpu_torch.models.nerf import uniform_z_vals
from envgs_tpu_torch.models.regressors import MLP, jclip, jmax
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import (
    AdamState,
    adam_init,
    adam_update,
    grads_of,
)


class NeusConfig(NamedTuple):
    xyz_freqs: int = 6
    dir_freqs: int = 4
    width: int = 128
    depth: int = 4
    feat_dim: int = 64
    color_width: int = 64
    n_samples: int = 48
    init_inv_s: float = 3.0  # s_param starts at init_inv_s / 10
    eikonal_weight: float = 0.1
    bg_brightness: float = 0.0

    def init(self, generator: torch.Generator | None = None,
             device=None) -> "NeusNetwork":
        return NeusNetwork(self, generator, device)


class NeusNetwork(nn.Module):
    """`sdf`: MLP(PE(x)) -> 1 + feat_dim, a skip at layer 2; `rgb`:
    MLP(feature, PE(dir), normal) -> sigmoid rgb, 2 layers of color_width;
    `s_param` a 0-d parameter. JAX's parameters: dict(sdf=[...],
    rgb=[...], s_param=())."""

    def __init__(self, cfg: NeusConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.sdf = MLP(pe_dim(3, cfg.xyz_freqs), cfg.width, cfg.depth,
                       1 + cfg.feat_dim, skips=(2,), generator=generator,
                       device=device)
        self.rgb = MLP(cfg.feat_dim + pe_dim(3, cfg.dir_freqs) + 3,
                       cfg.color_width, 2, 3, skips=(), out_actvn="sigmoid",
                       generator=generator, device=device)
        self.s_param = nn.Parameter(torch.tensor(
            cfg.init_inv_s / 10.0, dtype=torch.float32, device=device))

    def jax_params(self) -> dict:
        return dict(sdf=self.sdf.jax_params(), rgb=self.rgb.jax_params(),
                    s_param=self.s_param)

    @torch.no_grad()
    def load_jax(self, params: dict):
        self.sdf.load_jax(params["sdf"])
        self.rgb.load_jax(params["rgb"])
        self.s_param.copy_(torch.tensor(np.asarray(params["s_param"])))


def neus_params_from_jax(params: dict, cfg: NeusConfig,
                         device=None) -> NeusNetwork:
    """JAX's parameter dict (numpy or JAX arrays) -> the port's network
    (s_param a 0-d tensor)."""
    net = NeusNetwork(cfg, device=device)
    net.load_jax(params)
    return net


def sdf_fn(cfg: NeusConfig, net: NeusNetwork, x: torch.Tensor):
    """x (..., 3) -> (sdf (...,), feat (..., F))."""
    out = net.sdf(positional_encoding(x, cfg.xyz_freqs))
    return out[..., 0], out[..., 1:]


def _sdf_with_grad(cfg: NeusConfig, net: NeusNetwork, x: torch.Tensor):
    """(sdf, feat, d sdf / d x) from one evaluation. Under autograd the
    gradient keeps its graph (second order to the weights); under no_grad
    all three come back detached."""
    train = torch.is_grad_enabled()
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        sdf, feat = sdf_fn(cfg, net, x)
        grad, = torch.autograd.grad(sdf.sum(), x, create_graph=train)
    if not train:
        sdf, feat = sdf.detach(), feat.detach()
    return sdf, feat, grad


def sdf_grad(cfg: NeusConfig, net: NeusNetwork, x: torch.Tensor
             ) -> torch.Tensor:
    """The normals by autograd: (..., 3) -> (..., 3) = d sdf / d x."""
    return _sdf_with_grad(cfg, net, x)[2]


def neus_alpha(sdf_vals: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """Section-CDF opacity (NeuS eq. 13): sdf_vals (..., S) -> (..., S-1),
    clip((sig(s f_i) - sig(s f_i+1)) / max(sig(s f_i), 1e-6), 0, 1) (the
    clips halve the gradient at their bounds, as JAX's do)."""
    prev = torch.sigmoid(sdf_vals[..., :-1] * inv_s)
    nxt = torch.sigmoid(sdf_vals[..., 1:] * inv_s)
    return jclip((prev - nxt) / jmax(prev, 1e-6), 0.0, 1.0)


def render_rays_neus(cfg: NeusConfig, net: NeusNetwork, ray_o: torch.Tensor,
                     ray_d: torch.Tensor, near: torch.Tensor,
                     far: torch.Tensor,
                     generator: torch.Generator | None = None,
                     u: torch.Tensor | None = None) -> dict:
    """ray_o / ray_d (P, 3) (d normalized), near / far (P,) -> dict(rgb_map,
    dpt_map, acc_map, normal_map, eikonal, sdf_vals, inv_s); the samples
    jittered by `u` (P, n_samples) or a draw from `generator`, else the
    strata's centres."""
    z_vals = uniform_z_vals(near, far, cfg.n_samples, generator, u=u)
    pts = ray_o[:, None, :] + z_vals[..., None] * ray_d[:, None, :]
    sdf_vals, feat, grad = _sdf_with_grad(cfg, net, pts)
    gnorm = torch.linalg.norm(grad, dim=-1, keepdim=True)
    normal = grad / jmax(gnorm, 1e-6)

    inv_s = torch.exp(10.0 * net.s_param)
    alpha = neus_alpha(sdf_vals, inv_s)  # (P, S-1)
    trans = torch.cumprod(1.0 - alpha + 1e-7, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans

    dirs = positional_encoding(ray_d, cfg.dir_freqs)[:, None, :]
    dirs = torch.broadcast_to(dirs, (*feat.shape[:2], dirs.shape[-1]))
    rgb = net.rgb(torch.cat([feat, dirs, normal], -1))  # (P, S, 3)

    z_mid = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    acc = torch.sum(weights, -1)
    rgb_map = torch.sum(weights[..., None] * rgb[:, :-1], -2)
    rgb_map = rgb_map + (1.0 - acc[..., None]) * cfg.bg_brightness
    dpt = torch.sum(weights * z_mid, -1) / jmax(acc, 1e-6)
    n_map = torch.sum(weights[..., None] * normal[:, :-1], -2)
    eik = torch.mean((gnorm[..., 0] - 1.0) ** 2)
    return dict(rgb_map=rgb_map, dpt_map=dpt, acc_map=acc, normal_map=n_map,
                eikonal=eik, sdf_vals=sdf_vals, inv_s=inv_s)


def make_neus_train_step(cfg: NeusConfig, lr: float = 5e-4):
    """-> (init, step): init(generator, device) -> (network, AdamState);
    step(net, state, ray_o, ray_d, near, far, target, generator=None,
    u=None) -> (state, {"loss", "psnr", "eikonal"}), the network updated
    in place: rgb L2 + eikonal_weight * eikonal, one Adam step.
    `grads_out` and `mark` as in models/nerf.py::make_nerf_train_step."""

    def init(generator=None, device=None):
        net = cfg.init(generator, device)
        return net, adam_init(tree_flatten(net.jax_params()))

    def step(net: NeusNetwork, state: AdamState, ray_o, ray_d, near, far,
             target, generator=None, u=None, grads_out=None, mark=None):
        out = render_rays_neus(cfg, net, ray_o, ray_d, near, far, generator,
                               u)
        rgb_l = torch.mean((out["rgb_map"] - target) ** 2)
        loss = rgb_l + cfg.eikonal_weight * out["eikonal"]
        if mark:
            mark("forward")
        params = tree_flatten(net.jax_params())
        grads = grads_of(loss, params)
        if grads_out is not None:
            grads_out["grads"] = grads
        if mark:
            mark("backward")
        state = adam_update(params, grads, state, lr)
        if mark:
            mark("optimizer")
        return state, dict(loss=loss.detach(),
                           psnr=-10.0 * torch.log10(rgb_l.detach() + 1e-10),
                           eikonal=out["eikonal"].detach())

    return init, step

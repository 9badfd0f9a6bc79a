"""GaussianT model family: plain 3DGS rendering and training (port of
envgs_tpu/models/gaussiant.py, the reference's GaussianTSampler with the
`diff_gauss` rasterizer; here the tile blend in gauss3d mode,
`ops/raster3d.py`).

The parameter store is the shared padded pool with 3 scale axes; adaptive
density control, the SH degree ramp and the opacity reset reuse the pool
maintenance of `models/gaussians.py`. `render_gaussiant` renders one view;
`make_gaussiant_train_step` returns the L1 + SSIM step with the sparse
Adam update (zero gradients skip) and the in-step densification
statistics; `gaussiant_maintenance` applies the host-side schedule.
`gaussiant_state_to_numpy` / `gaussiant_state_from_numpy` carry a state
(weights, Adam moments, statistics) across the two packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.models.gaussians import (
    DensifyConfig,
    GaussianPool,
    accumulate_stats,
    create_pool,
    densify_and_prune,
    oneup_sh_degree,
    reset_opacity,
    sh_degree_mask,
)
from envgs_tpu_torch.ops.losses import ssim
from envgs_tpu_torch.ops.raster3d import (
    Prepared3DSplats,
    Raster3DOutput,
    prepare_gaussians3d,
    rasterize3d,
)
from envgs_tpu_torch.train.optimizer import (
    AdamState,
    LRConfig,
    init_adam,
    lr_tree_for,
    sparse_adam_update,
)
from envgs_tpu_torch.train.trainer import (
    pool_state_from_numpy,
    pool_state_to_numpy,
)
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.sh import eval_sh_color
from envgs_tpu_torch.utils.transforms import normalize


class GaussianTConfig(NamedTuple):
    """Static hyperparameters (GaussianTSampler defaults; the JAX package's
    fields but its raster backend: the tensors' device picks the kernels)."""

    sh_degree: int = 3
    bg_brightness: float = 0.0
    pair_cap: int = 2 ** 21
    scale_modifier: float = 1.0
    # training schedule (3DGS conventions)
    ssim_weight: float = 0.2
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    oneup_sh_every: int = 1_000


def init_gaussiant_pool(xyz, colors, cap: int, cfg: GaussianTConfig,
                        init_opacity: float = 0.1,
                        device=None) -> GaussianPool:
    """3-scale-axis pool from a point cloud (create_from_pcd)."""
    return create_pool(xyz, colors, cap, sh_degree=cfg.sh_degree,
                       init_opacity=init_opacity, scale_axes=3,
                       device=device)


def pool_colors(pool: GaussianPool,
                viewdir_origin: torch.Tensor) -> torch.Tensor:
    """Per-splat SH colors toward the camera (convert_SHs_python)."""
    feats = pool.get_features
    mask = sh_degree_mask(pool.stats.sh_degree, pool.max_sh_degree)
    feats = feats * mask[None, :, None]
    dirs = normalize(pool.params.xyz - viewdir_origin[None, :])
    return eval_sh_color(pool.max_sh_degree, feats.transpose(1, 2), dirs)


def prepare_gaussiant(pool: GaussianPool, cam: Camera, cfg: GaussianTConfig,
                      colors: torch.Tensor) -> Prepared3DSplats:
    """The prepared splats render_gaussiant rasterizes, given the pool's
    colors toward the camera (pool_colors)."""
    return prepare_gaussians3d(
        pool.params.xyz, pool.params.rotation, pool.get_scaling,
        pool.get_opacity[:, 0], colors, cam, cfg.scale_modifier,
        pool.stats.active)


def render_gaussiant(pool: GaussianPool, cam: Camera, cfg: GaussianTConfig,
                     means2d_zero: torch.Tensor | None = None
                     ) -> Raster3DOutput:
    """Render one view of a 3DGS pool (diff_gauss output contract): the
    render_gaussians3d of the JAX package's render_gaussiant."""
    colors = pool_colors(pool, cam.center)
    bg = torch.full((colors.shape[-1],), cfg.bg_brightness,
                    dtype=torch.float32, device=colors.device)
    return rasterize3d(prepare_gaussiant(pool, cam, cfg, colors), cam, bg,
                       cfg.pair_cap, means2d_zero)


class GaussianTState(NamedTuple):
    pool: GaussianPool
    opt: AdamState


def init_gaussiant_state(pool: GaussianPool) -> GaussianTState:
    return GaussianTState(pool, init_adam(pool.params))


def make_gaussiant_train_step(cfg: GaussianTConfig, cam_template: Camera,
                              lr: LRConfig | None = None):
    """The 3DGS train step at the template camera's resolution:
    step(state, K, R, T, target (H, W, 3)) -> (new state, {"loss", "psnr",
    "n_pts", "pair_overflow"}). Loss (1-w) L1 + w (1 - SSIM); sparse Adam
    at the LRs of iteration `state.opt.step`; densification statistics from
    the means2d_zero gradient, the forward wet and the radii."""
    lr = lr or LRConfig()
    H, W = cam_template.H, cam_template.W
    znear, zfar = cam_template.znear, cam_template.zfar

    def step(state: GaussianTState, K, R, T, target):
        cam = Camera(H, W, K, R, T, znear, zfar)
        pool = state.pool
        params = type(pool.params)(*(p.detach().requires_grad_(True)
                                     for p in pool.params))
        m2z = torch.zeros((pool.cap, 2), device=params.xyz.device,
                          requires_grad=True)
        out = render_gaussiant(pool._replace(params=params), cam, cfg,
                               means2d_zero=m2z)
        l1 = torch.mean(torch.abs(out.rgb - target))
        s = ssim(out.rgb, target)
        loss = (1.0 - cfg.ssim_weight) * l1 + cfg.ssim_weight * (1.0 - s)
        leaves = [*params, m2z]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        g_params, g_m2z = type(params)(*grads[:-1]), grads[-1]

        new_params, new_opt = sparse_adam_update(
            pool.params, g_params, state.opt,
            lr_tree_for(int(state.opt.step), lr))
        stats = accumulate_stats(pool.stats, g_m2z, out.radii > 0,
                                 weight=out.wet, radii=out.radii.detach())
        new_pool = pool._replace(params=new_params, stats=stats)
        rgb = out.rgb.detach()
        psnr = -10.0 * torch.log10(torch.mean((rgb - target) ** 2) + 1e-10)
        return GaussianTState(new_pool, new_opt), dict(
            loss=loss.detach(), psnr=psnr, n_pts=stats.active.sum(),
            pair_overflow=torch.clamp(out.num_pairs - cfg.pair_cap, min=0))

    return step


def gaussiant_maintenance(state: GaussianTState, iteration: int,
                          cfg: GaussianTConfig, dcfg: DensifyConfig,
                          generator: torch.Generator | None = None,
                          eps: list | None = None) -> GaussianTState:
    """The host-side schedule (GaussianTSampler.update_gaussians): SH
    ramp, densify/prune (split offsets from `generator`, or `eps`, see
    densify_and_prune), opacity reset."""
    pool, opt = state.pool, state.opt
    if iteration > 0 and iteration % cfg.oneup_sh_every == 0:
        pool = oneup_sh_degree(pool)
    if (cfg.densify_from_iter <= iteration < cfg.densify_until_iter
            and iteration % cfg.densification_interval == 0):
        pool, (mu, nu) = densify_and_prune(pool, (opt.mu, opt.nu), dcfg,
                                           generator, eps)
        opt = AdamState(mu, nu, opt.step)
    if iteration > 0 and iteration % cfg.opacity_reset_interval == 0:
        pool, (mu, nu) = reset_opacity(pool, (opt.mu, opt.nu))
        opt = AdamState(mu, nu, opt.step)
    return GaussianTState(pool, opt)


def gaussiant_state_to_numpy(state: GaussianTState) -> dict:
    """{"params", "stats", "mu", "nu": {field: array}, "step",
    "max_sh_degree"} under the JAX field names."""
    return pool_state_to_numpy(state.pool, state.opt)


def gaussiant_state_from_numpy(d: dict, device=None) -> GaussianTState:
    """Inverse of gaussiant_state_to_numpy (JAX arrays carried over as
    numpy)."""
    return GaussianTState(*pool_state_from_numpy(d, device))

"""Spacetime Gaussians (the STGS / FDGS dynamic-3DGS family; port of
envgs_tpu/models/stgs.py).

The padded 3DGS pool with the temporal fields of GaussianParams: a
temporal center `t`, a log temporal scale `scaling_t` and a linear
velocity `motion`. At query time tt a splat renders at

    xyz(tt) = xyz + motion (tt - t)
    opacity(tt) = sigmoid(opacity) exp(-0.5 ((tt - t) / exp(scaling_t))^2)

through the 3DGS rasterizer (`ops/raster3d.py`: K5, gauss3d K1 with its
per-pair wet and gauss3d K2 on a CUDA tensor, their plain versions on a
CPU tensor). Colors are the static SH, or with `sh_degree_t > 0` the 4D
SH whose temporal blocks ride features_rest. Maintenance is the shared
`densify_and_prune` (children copy the temporal fields of their parent)
and `reset_t`, which clamps the temporal centers into the sequence. The
4D ply is the trbf_center / trbf_scale / motion_* layout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.models.gaussians import (
    DensifyConfig,
    GaussianPool,
    accumulate_stats,
    create_pool,
    densify_and_prune,
    fill_params,
    map_params,
    present,
    sh_degree_mask,
    sigmoid,
)
from envgs_tpu_torch.ops.losses import ssim
from envgs_tpu_torch.ops.raster3d import Raster3DOutput, render_gaussians3d
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
from envgs_tpu_torch.utils.sh import eval_sh_4d, eval_sh_color


class STGSConfig(NamedTuple):
    """Static hyperparameters (the reference's STGS defaults).
    raster_backend: "pallas" (the kernels on a CUDA tensor, the plain
    versions on a CPU tensor) or "ref" (the reference rasterizer)."""

    sh_degree: int = 3
    # temporal SH degree: 0 = static SH; k > 0 adds k cosine harmonics per
    # spatial block
    sh_degree_t: int = 0
    init_opacity: float = 0.1
    init_scale_t: float = 0.1414
    duration: float = 1.0  # the sequence's time span (t in [0, 1])
    bg_brightness: float = 0.0
    raster_backend: str = "pallas"
    pair_cap: int = 2 ** 21
    scale_modifier: float = 1.0
    lambda_dssim: float = 0.2


def init_stgs_pool(xyz: np.ndarray, times: np.ndarray,
                   colors: np.ndarray | None, cap: int, cfg: STGSConfig,
                   device=None) -> GaussianPool:
    """A 3-scale-axis pool with the temporal fields (create_from_pcd): 3-NN
    scales, zero motion, the constant temporal scale."""
    return create_pool(xyz, colors, cap=cap, sh_degree=cfg.sh_degree,
                       init_opacity=cfg.init_opacity, scale_axes=3,
                       times=times, init_scale_t=cfg.init_scale_t,
                       sh_degree_t=cfg.sh_degree_t, device=device)


def splats_at_time(pool: GaussianPool, tt):
    """-> (xyz_t (P, 3), opacity_t (P,)) at the query time tt (a scalar)."""
    p = pool.params
    dt = tt - p.t[:, 0]
    xyz_t = p.xyz + p.motion * dt[:, None]
    marginal = torch.exp(-0.5 * (dt / torch.exp(p.scaling_t[:, 0])) ** 2)
    return xyz_t, sigmoid(p.opacity[:, 0]) * marginal


def _clip_min0(x):
    """max(x, 0) with the gradient the JAX package's jnp.clip gives: half
    at exactly 0 (the mean of relu's and clamp's)."""
    return 0.5 * (torch.relu(x) + torch.clamp(x, min=0.0))


def render_stgs(pool: GaussianPool, cam: Camera, tt, cfg: STGSConfig,
                means2d_zero: torch.Tensor | None = None) -> Raster3DOutput:
    """Render one view at time tt (render_fdgs's output contract)."""
    xyz_t, opacity_t = splats_at_time(pool, tt)
    dirs = xyz_t - cam.center[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-8)
    smask = sh_degree_mask(pool.stats.sh_degree, pool.max_sh_degree)
    if cfg.sh_degree_t > 0:
        # 4D SH: the splat's time offset from its center, period the
        # sequence's duration
        feats = pool.get_features * smask.repeat(
            cfg.sh_degree_t + 1)[None, :, None]
        dt = tt - pool.params.t[:, 0]
        colors = _clip_min0(eval_sh_4d(
            pool.max_sh_degree, cfg.sh_degree_t, feats.transpose(1, 2), dirs,
            dt, l=cfg.duration) + 0.5)
    else:
        feats = pool.get_features * smask[None, :, None]
        colors = eval_sh_color(pool.max_sh_degree, feats.transpose(1, 2),
                               dirs)
    return render_gaussians3d(
        xyz_t, pool.params.rotation, pool.get_scaling, opacity_t, colors,
        cam, bg_color=cfg.bg_brightness, pair_cap=cfg.pair_cap,
        scale_modifier=cfg.scale_modifier, active=pool.stats.active,
        means2d_zero=means2d_zero, backend=cfg.raster_backend)


def reset_t(pool: GaussianPool, adam: AdamState, tmin: float = 0.0,
            tmax: float = 1.0):
    """Clamp the temporal centers into [tmin, tmax] and zero their Adam
    moments -> (pool, adam)."""
    new_t = torch.clamp(pool.params.t, tmin, tmax)
    pool = pool._replace(params=pool.params._replace(t=new_t))
    mu = adam.mu._replace(t=torch.zeros_like(adam.mu.t))
    nu = adam.nu._replace(t=torch.zeros_like(adam.nu.t))
    return pool, adam._replace(mu=mu, nu=nu)


class STGSState(NamedTuple):
    pool: GaussianPool
    opt: AdamState


def init_stgs_state(pool: GaussianPool) -> STGSState:
    return STGSState(pool, init_adam(pool.params))


def stgs_lr_config(spatial_scale: float = 1.0,
                   duration: float = 1.0) -> LRConfig:
    """The reference's STGS learning rates: xyz and motion scaled by the
    scene's extent, t by half the duration, no opacity pulse."""
    return LRConfig(
        spatial_scale=spatial_scale,
        t=0.0001 * 0.5 * duration,
        scaling_t=0.002,
        motion=0.00016 * spatial_scale,
        use_opacity_pulse=False,
    )


def make_stgs_train_step(cfg: STGSConfig, cam_template: Camera,
                         lr_cfg: LRConfig):
    """The STGS train step at the template camera's resolution:
    step(state, K, R, T, tt, target (H, W, 3), it) -> (new state,
    {"loss", "n_active", "pair_overflow" (not with the ref backend)}).
    Loss (1 - l) L1 + l (1 - SSIM); sparse Adam at the LRs of iteration
    `it`; densification statistics from the means2d_zero gradient, the
    forward wet and the radii. With `grads_out` (a dict) the step also
    hands back its gradients ("params": GaussianParams, "means2d"); `mark`
    (a callable) is called with "forward", "backward" and "optimizer" as
    each stage is queued."""
    H, W = cam_template.H, cam_template.W
    znear, zfar = cam_template.znear, cam_template.zfar

    def step(state: STGSState, K, R, T, tt, target, it,
             grads_out: dict | None = None, mark=None):
        pool = state.pool
        params = map_params(lambda p: p.detach().requires_grad_(True),
                            pool.params)
        m2z = torch.zeros((pool.cap, 2), device=params.xyz.device,
                          requires_grad=True)
        cam = Camera(H, W, K, R, T, znear, zfar)
        out = render_stgs(pool._replace(params=params), cam, tt, cfg,
                          means2d_zero=m2z)
        l1 = torch.mean(torch.abs(out.rgb - target))
        loss = (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * (
            1.0 - ssim(out.rgb, target))
        if mark:
            mark("forward")
        leaves = [*present(params), m2z]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        g_params, g_m2z = fill_params(params, grads[:-1]), grads[-1]
        if grads_out is not None:
            grads_out.update(params=g_params, means2d=g_m2z)
        if mark:
            mark("backward")
        new_params, opt = sparse_adam_update(
            pool.params, g_params, state.opt, lr_tree_for(int(it), lr_cfg))
        stats = accumulate_stats(pool.stats, g_m2z, out.radii > 0,
                                 weight=out.wet, radii=out.radii.detach())
        info = dict(loss=loss.detach(), n_active=pool.stats.active.sum())
        if out.num_pairs is not None:  # the reference has no pair budget
            info["pair_overflow"] = torch.clamp(out.num_pairs - cfg.pair_cap,
                                                min=0)
        if mark:
            mark("optimizer")
        return STGSState(pool._replace(params=new_params, stats=stats),
                         opt), info

    return step


def stgs_maintenance(state: STGSState, cfg: DensifyConfig,
                     generator: torch.Generator | None = None,
                     eps: list | None = None) -> STGSState:
    """densify_and_prune of the pool and its moments (split offsets from
    `generator`, or `eps`: see densify_and_prune)."""
    pool, (mu, nu) = densify_and_prune(state.pool, (state.opt.mu,
                                                    state.opt.nu), cfg,
                                       generator, eps)
    return STGSState(pool, state.opt._replace(mu=mu, nu=nu))


def stgs_state_to_numpy(state: STGSState) -> dict:
    """{"params", "stats", "mu", "nu": {field: array}, "step",
    "max_sh_degree"} under the JAX field names."""
    return pool_state_to_numpy(state.pool, state.opt)


def stgs_state_from_numpy(d: dict, device=None) -> STGSState:
    """Inverse of stgs_state_to_numpy (JAX arrays carried over as numpy)."""
    return STGSState(*pool_state_from_numpy(d, device))


# ---------------------------------------------------------------------------
# the 4D Gaussian ply: trbf_center / trbf_scale and motion_* columns beside
# the 3DGS fields (convert_fdgs_pcd.py's layout)
# ---------------------------------------------------------------------------

def save_stgs_ply(pool: GaussianPool, path: str):
    """The active splats' raw parameters as a 4D Gaussian ply."""
    from envgs_tpu_torch.utils.ply import write_ply

    act = pool.stats.active
    get = lambda x: x[act].detach().cpu().numpy()  # noqa: E731
    p = pool.params
    n = int(act.sum())
    arrays = {}
    xyz = get(p.xyz)
    for i, k in enumerate("xyz"):
        arrays[k] = xyz[:, i]
    arrays["trbf_center"] = get(p.t)[:, 0]
    arrays["trbf_scale"] = get(p.scaling_t)[:, 0]
    for k in ("nx", "ny", "nz"):
        arrays[k] = np.zeros(n, np.float32)
    mot = get(p.motion)
    for i in range(3):
        arrays[f"motion_{i}"] = mot[:, i]
    f_dc = get(p.features_dc)
    for i in range(3):
        arrays[f"f_dc_{i}"] = f_dc[:, 0, i]
    arrays["opacity"] = get(p.opacity)[:, 0]
    scal = get(p.scaling)
    for i in range(scal.shape[1]):
        arrays[f"scale_{i}"] = scal[:, i]
    rot = get(p.rotation)
    for i in range(4):
        arrays[f"rot_{i}"] = rot[:, i]
    write_ply(path, arrays)


def load_stgs_ply(path: str, cap: int, cfg: STGSConfig,
                  device=None) -> GaussianPool:
    """A 4D Gaussian ply into a fresh pool of capacity `cap`: the ply's
    fields, init_stgs_pool's for the rest (higher SH zero)."""
    from envgs_tpu_torch.utils.ply import read_ply

    d = read_ply(path)
    P = len(d["x"])
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    pool = init_stgs_pool(xyz, d["trbf_center"].astype(np.float32), None,
                          cap, cfg, device=device)

    def pad(a):
        a = np.asarray(a, np.float32)
        a = np.pad(a, [(0, cap - P)] + [(0, 0)] * (a.ndim - 1))
        return torch.tensor(a, device=pool.params.xyz.device)

    f_dc = np.stack([d[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    params = pool.params._replace(
        xyz=pad(xyz), features_dc=pad(f_dc),
        opacity=pad(d["opacity"][:, None]),
        scaling=pad(np.stack([d[f"scale_{i}"] for i in range(3)], -1)),
        rotation=pad(np.stack([d[f"rot_{i}"] for i in range(4)], -1)),
        t=pad(d["trbf_center"][:, None]),
        scaling_t=pad(d["trbf_scale"][:, None]),
        motion=pad(np.stack([d[f"motion_{i}"] for i in range(3)], -1)))
    return pool._replace(params=params)

"""Band-parallel training: the image split into horizontal bands of whole
16-pixel tile rows, one band a rank (port of
envgs_tpu/parallel/sharding.py on torch.distributed).

Each rank renders and traces its band against the replicated pools as a
row-crop of the full camera (the full image's K everywhere; the band is
integer tile arithmetic, so its base pass equals the same rows of a full
render to the bit), and differentiates its share of the band-mean loss.
The loss is band-exact: SSIM exchanges 5-row halos (each window of the
image computed by one band), the depth normalization's quantiles count
over the image, the depth-derived surface normal recomputes the band's
boundary rows from a 1-row depth halo, and the env pass's SH view origin
is the image's. Then every parameter gradient and every zeros hook's
gradient is summed over the bands (the all-reduce of data parallelism, the
transpose psum of the JAX package's shard_map), and each rank applies the
same sparse Adam update: the replicated state stays equal on every rank.

The per-splat wet hooks' gradients carry each band's wet (summed from the
blend weights, whatever the loss's scale); the position hooks carry the
band's share of the band mean's gradient. Summing both over the bands
gives the single image's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from envgs_tpu_torch.models.camera_opt import apply_residual
from envgs_tpu_torch.models.envgs import EnvGSConfig, EnvGSOutput, forward_envgs
from envgs_tpu_torch.ops.raster import depth_to_normal
from envgs_tpu_torch.parallel.collectives import (
    Axis,
    _all_reduce,
    make_axis,
    ppermute,
)
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.supervisor import LossConfig, compute_losses
from envgs_tpu_torch.train.trainer import (
    Batch,
    CamOptConfig,
    CamOptState,
    TrainState,
    apply_grads,
    camera_step,
    step_grads,
    step_leaves,
    without_camera,
)
from envgs_tpu_torch.utils.camera import Camera


class Mesh(NamedTuple):
    """Named axes over the ranks of the default group, and `world`, the
    axis of every rank (what a sum over all the mesh's axes reduces
    over)."""

    axes: dict
    world: Axis

    @property
    def shape(self) -> dict:
        return {k: a.size for k, a in self.axes.items()}


def make_mesh(n_devices=None, axis="band", timeout=None) -> Mesh:
    """The mesh over every rank of the default group: 1-D (n_devices
    ranks on `axis`) or, with a tuple shape and a tuple of names, 2-D with
    rank = i * shape[1] + j at position (i, j), as a JAX Mesh lays out
    `devices.reshape(shape)`. n_devices must cover the world. Every rank
    must call this, in the same order as any other group it makes."""
    world = dist.get_world_size()
    shape = (world,) if n_devices is None else n_devices
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(shape) != len(names) or (
            shape[0] * (shape[1] if len(shape) > 1 else 1) != world):
        raise ValueError(f"mesh {shape} {names} over {world} ranks")
    all_ranks = make_axis("world", timeout=timeout)
    if len(shape) == 1:
        return Mesh({names[0]: all_ranks._replace(name=names[0])}, all_ranks)
    n0, n1 = shape
    me = dist.get_rank()
    axes = {}
    # every rank makes every subgroup, rows (fixed i) then columns
    for i in range(n0):
        a = make_axis(names[1], [i * n1 + j for j in range(n1)], timeout)
        if me // n1 == i:
            axes[names[1]] = a
    for j in range(n1):
        a = make_axis(names[0], [i * n1 + j for i in range(n0)], timeout)
        if me % n1 == j:
            axes[names[0]] = a
    return Mesh({n: axes[n] for n in names}, all_ranks)


def band_surface_normal(out: EnvGSOutput, axis: Axis, cam: Camera,
                        K_full: torch.Tensor, H: int, row0: int
                        ) -> EnvGSOutput:
    """The band-exact depth-derived surface normal: depth_to_normal's
    central differences read one depth row of each neighbouring band (a
    band's own border would read the zero edge the single image has only
    at its top and bottom). cam: the band's camera (H the band's)."""
    n = axis.size
    dpt = out.dpt_map
    dpt_ext = torch.cat([
        ppermute(dpt[-1:], axis, [(i, i + 1) for i in range(n - 1)]), dpt,
        ppermute(dpt[:1], axis, [(i + 1, i) for i in range(n - 1)])], dim=0)
    cam_ext = Camera(cam.H + 2, cam.W, K_full, cam.R, cam.T, cam.znear,
                     cam.zfar)
    sn = depth_to_normal(cam_ext, dpt_ext[..., 0], i0=row0 - 1.0)[1:-1]
    grow = row0 + torch.arange(cam.H, device=dpt.device)
    border = (grow == 0) | (grow == H - 1)
    sn = torch.where(border[:, None, None], 0.0, sn)
    return out._replace(surf_norm_map=sn * out.acc_map.detach())


def sum_flat(tensors: list, axis: Axis, op=dist.ReduceOp.SUM) -> list:
    """One all_reduce of every tensor of the list, flattened into one
    buffer (of their common dtype) and split back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = _all_reduce(flat, axis, op)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def pmean_stats(stats: dict, axis: Axis) -> dict:
    """Every 0-d stat's mean over the axis, in one all_reduce."""
    keys = list(stats)
    vals = torch.stack([stats[k].to(torch.float32) for k in keys])
    vals = _all_reduce(vals, axis, dist.ReduceOp.SUM) / axis.size
    return dict(zip(keys, vals.unbind(0)))


def make_sharded_train_step(
    mesh: Mesh,
    cam: Camera,
    model_cfg: EnvGSConfig,
    loss_cfg: LossConfig,
    lr_base: LRConfig,
    lr_env: LRConfig,
    has_norm: bool = False,
    axis: str = "band",
    lpips_fn=None,
    cam_opt: CamOptConfig = CamOptConfig(),
):
    """The band-parallel train step: step(state, batch, K, R, T, it) ->
    (state, stats), or with cam_opt.enabled step(state, cam_state, batch,
    K, R, T, view_idx, it) -> (state, cam_state, stats), on every rank of
    the mesh's `axis` with the full image's batch and camera; each rank
    takes its band of H / n_bands rows. The returned state and stats are
    the same on every rank. Keyword `mark(stage)` is called as the
    forward, backward and optimizer end; `grads_out`, a dict, receives the
    summed gradients ("base", "env", "means2d", "env_means3d", "wet_base",
    "wet_env", "cam").

    As the single-image step: the densification hook's width follows
    use_base_tracing, the camera residual applies to the full camera
    before the band is taken, the perceptual loss is the band's. Stats are
    compute_losses' terms, meaned over the bands (psnr: the bands' mean of
    their PSNRs). H must split into n_bands bands of whole 16-pixel tile
    rows."""
    band_axis = mesh.axes[axis]
    n_bands = band_axis.size
    H, W = cam.H, cam.W
    if H % (n_bands * 16):
        raise ValueError(f"H={H} does not split into {n_bands} bands of "
                         "whole 16-pixel tile rows")
    band_h = H // n_bands
    m2z_w = 3 if model_cfg.use_base_tracing else 2

    def step_impl(state: TrainState, cam_state: CamOptState | None,
                  batch: Batch, K, R, T, view_idx: int, it: int,
                  mark: Callable[[str], None] | None = None,
                  grads_out: dict | None = None):
        row0 = band_axis.index * band_h
        bparams, eparams, hooks, cres, leaves = step_leaves(
            state, m2z_w, cam_state)
        camera = Camera(H, W, K, R, T, cam.znear, cam.zfar)
        if cres is not None:
            camera = apply_residual(camera, cres, int(view_idx))
        bcam = Camera(band_h, W, camera.K, camera.R, camera.T, cam.znear,
                      cam.zfar)
        out = forward_envgs(
            state.base._replace(params=bparams),
            state.env._replace(params=eparams), bcam, it, model_cfg, *hooks,
            band=(row0, H, band_axis))
        out = band_surface_normal(out, band_axis, bcam, camera.K, H, row0)
        rows = slice(row0, row0 + band_h)
        loss, stats = compute_losses(
            out, batch.rgb[rows], batch.msk[rows],
            batch.norm[rows] if has_norm else None, camera.R, it, loss_cfg,
            bg_brightness=model_cfg.bg_brightness, lpips_fn=lpips_fn,
            band=(band_axis, n_bands, H))
        stats = pmean_stats(stats, band_axis)
        wet_b, vis_b, wet_e = sum_flat([out.base_wet.detach(),
                                        out.base_visibility.to(torch.float32),
                                        out.env_wet.detach()], band_axis)
        radii, = sum_flat([out.base_radii.detach()], band_axis,
                          dist.ReduceOp.MAX)
        if mark:
            mark("forward")
        # this rank's share of the objective; the gradients summed over the
        # bands in one all-reduce. One of {forward wet, gradient-lane wet}
        # is exact zeros per backend
        g = step_grads(loss / n_bands, leaves, bparams, eparams,
                       reduce=lambda gs: sum_flat(gs, band_axis))
        new_state = apply_grads(state, g, it, lr_base, lr_env, vis_b > 0,
                                wet_b + g.wet_base, radii, None,
                                wet_e + g.wet_env)
        if mark:
            mark("backward")
        if cres is not None:
            cam_state, g_cam = camera_step(cam_state, g.cam, cam_opt)
            g = g._replace(cam=g_cam)
        g.write(grads_out)
        if mark:
            mark("optimizer")
        return new_state, cam_state, stats

    return step_impl if cam_opt.enabled else without_camera(step_impl)

"""Splat-slab parallelism: the pair pipelines split over the ranks of an
axis by depth-rank slabs (port of envgs_tpu/parallel/splat_sharding.py on
torch.distributed).

Each frame the pool is split into slabs by the key the rasterizer's
binning sorts by (front-to-back splat depth, ties by index); each rank
rasterizes only its slab over the whole image, and the per-slab
accumulators are all-gathered and composed in slab order. Front-to-back
alpha blending composes exactly in the premultiplied form: for a split of
the blend order into (lo, hi)

    rgb  = rgb_lo + T_lo * rgb_hi          (likewise depth, normal, alpha)
    T    = T_lo * T_hi
    dist = dist_lo + T_lo^2 * dist_hi
         + T_lo * (a_lo * D2_hi + D2_lo * a_hi - 2 * D1_lo * D1_hi)

with D1 / D2 the blends' running sums of w m and w m^2. Two outputs are
approximate under slabs, as in the JAX package: the median depth (a
threshold crossing) becomes the expected depth, and a slab's per-splat wet
ignores the occlusion by nearer slabs (an upper bound, exact for slab 0).
The env pass splits the env splats by their distance from the mean
reflected-ray origin, which approximates each ray tile's radial blend
order near the slab boundaries (exact for radially separated shells).

Each rank runs its slab at pair_cap / D. Parameter gradients come back
through the all-gather's transpose and are summed over the ranks, as the
band step sums them; with a band axis the mesh is 2-D ('band', 'splat').
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.envgs import (
    EnvGSConfig,
    _pool_colors,
    _pool_colors_at,
    forward_envgs,
)
from envgs_tpu_torch.ops import tracer
from envgs_tpu_torch.ops.common import prepare_splats
from envgs_tpu_torch.ops.raster import RasterOutput, rasterize, render_decode
from envgs_tpu_torch.ops.tracer_ref import TraceOutput, prepare_trace_scene
from envgs_tpu_torch.parallel.collectives import (
    Axis,
    _all_reduce,
    gather_tree,
    pmax,
)
from envgs_tpu_torch.parallel.sharding import (
    Mesh,
    band_surface_normal,
    pmean_stats,
    sum_flat,
)
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.supervisor import LossConfig, compute_losses
from envgs_tpu_torch.train.trainer import (
    Batch,
    TrainState,
    apply_grads,
    step_grads,
    step_leaves,
)
from envgs_tpu_torch.utils.camera import Camera


def slab_assignment(depth: torch.Tensor, valid: torch.Tensor,
                    n_slabs: int) -> torch.Tensor:
    """(P,) int32 slab of each splat by its global depth rank: the binning
    sort's key (depth, invalid -> inf, ties by index), so the union of the
    slabs' blend orders is the single image's."""
    P = depth.shape[0]
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    quota = -(-P // n_slabs)
    slab = torch.zeros(P, dtype=torch.int32, device=depth.device)
    slab[order] = (torch.arange(P, device=depth.device) // quota).to(
        torch.int32)
    return slab


def compose_slabs(parts: RasterOutput, bg_color: torch.Tensor,
                  C: int) -> RasterOutput:
    """Fold (D, ...) stacked per-slab raster outputs in slab order. The
    parts come from rasterize with bg 0 (premultiplied rgb); their wet and
    radii cover disjoint splats (summed, maxed). Moments a render-mode
    part lacks (d1 / d2 None) are zeros."""
    D = parts.trans.shape[0]
    zero = torch.zeros_like(parts.alpha)
    p_d1 = zero if parts.d1 is None else parts.d1
    p_d2 = zero if parts.d2 is None else parts.d2
    rgb, dpt, alpha = parts.rgb[0], parts.depth_expected[0], parts.alpha[0]
    nrm, dist_, T = parts.normal[0], parts.distortion[0], parts.trans[0]
    d1, d2 = p_d1[0], p_d2[0]
    for k in range(1, D):
        rgb = rgb + T[..., None] * parts.rgb[k]
        dpt = dpt + T * parts.depth_expected[k]
        nrm = nrm + T[..., None] * parts.normal[k]
        dist_ = (dist_ + T * T * parts.distortion[k]
                 + T * (alpha * p_d2[k] + d2 * parts.alpha[k]
                        - 2.0 * d1 * p_d1[k]))
        d1 = d1 + T * p_d1[k]
        d2 = d2 + T * p_d2[k]
        alpha = alpha + T * parts.alpha[k]
        T = T * parts.trans[k]
    bg = torch.zeros(C, dtype=torch.float32, device=rgb.device)
    bg[: bg_color.shape[0]] = bg_color
    rgb = rgb + T[..., None] * bg
    # the median depth is a threshold crossing, which slabs do not compose:
    # the expected depth stands in (exact for depth_ratio == 0)
    med = torch.where(alpha > 1e-8, dpt / torch.clamp(alpha, min=1e-8),
                      0.0).detach()
    return RasterOutput(
        rgb=rgb, depth_expected=dpt, alpha=alpha, normal=nrm,
        depth_median=med, distortion=dist_,
        wet=torch.sum(parts.wet, dim=0),
        radii=torch.amax(parts.radii, dim=0), trans=T,
        num_pairs=(None if parts.num_pairs is None
                   else torch.sum(parts.num_pairs, dim=0)),
        d1=d1, d2=d2)


def compose_trace_slabs(parts: TraceOutput, bg_color: torch.Tensor
                        ) -> TraceOutput:
    """Fold (D, ...) stacked raw per-slab trace outputs (from
    trace_rays(compose_raw=True): premultiplied rgb / dpt, d1 / d2 filled)
    in slab order; wet, dropped slots and cut chunks summed."""
    D = parts.trans.shape[0]
    rgb, dpt, acc = parts.rgb[0], parts.dpt[0], parts.acc[0]
    nrm, dist_, T = parts.norm[0], parts.dist[0], parts.trans[0]
    aux = parts.aux[0]
    d1, d2 = parts.d1[0], parts.d2[0]
    for k in range(1, D):
        rgb = rgb + T[..., None] * parts.rgb[k]
        dpt = dpt + T * parts.dpt[k]
        nrm = nrm + T[..., None] * parts.norm[k]
        aux = aux + T[..., None] * parts.aux[k]
        dist_ = (dist_ + T * T * parts.dist[k]
                 + T * (acc * parts.d2[k] + d2 * parts.acc[k]
                        - 2.0 * d1 * parts.d1[k]))
        d1 = d1 + T * parts.d1[k]
        d2 = d2 + T * parts.d2[k]
        acc = acc + T * parts.acc[k]
        T = T * parts.trans[k]
    rgb = rgb + T[..., None] * bg_color
    dpt = torch.where(acc > 1e-8, dpt / torch.clamp(acc, min=1e-8), 0.0)
    return TraceOutput(
        rgb=rgb, dpt=dpt, acc=acc, norm=nrm, dist=dist_, aux=aux,
        wet=torch.sum(parts.wet, dim=0), trans=T,
        dropped_pairs=(None if parts.dropped_pairs is None
                       else torch.sum(parts.dropped_pairs, dim=0)),
        d1=d1, d2=d2,
        cut_chunks=(None if parts.cut_chunks is None
                    else torch.sum(parts.cut_chunks, dim=0)))


def _colors(pool: G.GaussianPool, cam: Camera, cfg: EnvGSConfig):
    colors = _pool_colors(pool, cam.center)
    if cfg.render_reflection:
        colors = torch.cat([colors, pool.get_specular, pool.get_roughness],
                           dim=-1)
    return colors


def _slab_of(pool: G.GaussianPool, cam: Camera, cfg: EnvGSConfig,
             n_slabs: int) -> torch.Tensor:
    """The pool's depth-rank slabs seen from cam (the same on every rank:
    the pool is replicated)."""
    with torch.no_grad():
        pre = prepare_splats(
            pool.params.xyz, pool.params.rotation, pool.get_scaling,
            pool.get_opacity[:, 0],
            torch.zeros_like(pool.params.xyz), cam,
            scale_modifier=cfg.scale_modifier, active=pool.stats.active)
        return slab_assignment(pre.depth, pre.valid, n_slabs)


def _slab_base_pass(axis: Axis, slab_pair_cap: int | None,
                    sink: dict | None = None):
    """render_base with the rasterizer's pair pipeline split over `axis`
    (called as forward_envgs calls base_pass). Each rank rasterizes its
    slab at pair_cap / D, the accumulators compose over the axis. `sink`,
    when given, receives sink["pair_overflow"], the worst slab's
    overshoot of its own cap (pmax over the axis: the composed pair count
    is the slabs' sum, which could hide one slab past its cap)."""

    def base_pass(pool, cam, cfg, means2d_zero=None, wet_zero=None):
        D = axis.size
        cap = slab_pair_cap or max(cfg.pair_cap // D, 1 << 12)
        train = not cfg.render_mode
        slab = _slab_of(pool, cam, cfg, D)
        prep = prepare_splats(
            pool.params.xyz, pool.params.rotation, pool.get_scaling,
            pool.get_opacity[:, 0], _colors(pool, cam, cfg), cam,
            scale_modifier=cfg.scale_modifier,
            active=pool.stats.active & (slab == axis.index))
        out = rasterize(
            prep, cam, torch.zeros(3, device=prep.depth.device),
            pair_cap=cap, means2d_zero=means2d_zero,
            needs=(train, train or cfg.depth_ratio > 0, train),
            wet_zero=wet_zero if cfg.raster_backend != "ref" else None,
            backend=cfg.raster_backend)
        if sink is not None and out.num_pairs is not None:
            sink["pair_overflow"] = pmax(
                torch.clamp(out.num_pairs - cap, min=0), axis)
        bg = torch.full((3,), cfg.bg_brightness, dtype=torch.float32,
                        device=prep.depth.device)
        C = 3 + (cfg.specular_channels + 1 if cfg.render_reflection else 0)
        composed = compose_slabs(gather_tree(out, axis), bg, C)
        return render_decode(
            composed, cam,
            specular_channels=(cfg.specular_channels
                               if cfg.render_reflection else 0),
            depth_ratio=cfg.depth_ratio)

    return base_pass


def _slab_env_pass(axis: Axis, slab_env_cap: int | None):
    """render_env with the tracer's pair pipeline split over `axis` (called
    as forward_envgs calls env_pass): env splats in slabs by their distance
    from the mean reflected-ray origin, each rank traces its slab at
    env_pair_cap / D in the raw form, the slabs compose over the axis.
    Single bounce (max_trace_depth 0) only, as in the JAX package."""

    def env_pass(env, ref_o, ref_d, cfg, env_means3d_zero=None,
                 ray_mask=None, wet_zero=None):
        if cfg.max_trace_depth != 0 or cfg.tracer_backend != "tiled":
            raise NotImplementedError(
                "the slab env pass traces one bounce with the tiled tracer")
        D = axis.size
        cap = slab_env_cap or max(cfg.env_pair_cap // D, 1 << 12)
        train = not cfg.render_mode
        xyz = env.params.xyz
        if env_means3d_zero is not None:
            xyz = xyz + env_means3d_zero
        colors = _pool_colors_at(env, ref_o)
        with torch.no_grad():
            apex = torch.mean(ref_o.reshape(-1, 3), dim=0)
            radial = torch.linalg.vector_norm(xyz - apex[None, :], dim=-1)
            eslab = slab_assignment(radial, env.stats.active, D)
        scene = prepare_trace_scene(
            xyz, env.params.rotation, env.get_scaling,
            env.get_opacity[:, 0], colors,
            active=env.stats.active & (eslab == axis.index),
            scale_modifier=cfg.scale_modifier)
        out = tracer.trace_rays(
            scene, ref_o, ref_d, torch.zeros(3, device=xyz.device),
            per_tile_cap=cfg.env_per_tile_cap,
            total_pair_cap=cap, ray_mask=ray_mask,
            needs=(train, train, train), wet_zero=wet_zero,
            compose_raw=True)
        out = out._replace(num_pairs=None)
        bg = torch.full((3,), cfg.env_bg_brightness, dtype=torch.float32,
                        device=xyz.device)
        return compose_trace_slabs(gather_tree(out, axis), bg)

    return env_pass


def make_splat_sharded_render_base(mesh: Mesh, cam: Camera,
                                   cfg: EnvGSConfig, axis: str = "splat",
                                   slab_pair_cap: int | None = None):
    """-> render(pool): the base pass with the pair pipeline split over the
    mesh's `axis` (each rank at slab_pair_cap, default pair_cap / D),
    equal to models.envgs.render_base on one device up to the float
    re-association of the composition (the blend order is exact). The
    median depth is the expected depth's stand-in; the per-splat wet is
    slab-local. Called on every rank of the axis; the same result on
    each."""
    base_pass = _slab_base_pass(mesh.axes[axis], slab_pair_cap)

    def render(pool: G.GaussianPool):
        return base_pass(pool, cam, cfg)

    return render


def make_splat_sharded_train_step(
    mesh: Mesh,
    cam: Camera,
    model_cfg: EnvGSConfig,
    loss_cfg: LossConfig,
    lr_base: LRConfig,
    lr_env: LRConfig,
    has_norm: bool = False,
    splat_axis: str = "splat",
    band_axis: str | None = None,
    slab_pair_cap: int | None = None,
    slab_env_cap: int | None = None,
    lpips_fn=None,
):
    """The train step with both pair pipelines split over `splat_axis`:
    step(state, batch, K, R, T, it) -> (state, stats), called on every
    rank with the full image's batch; `mark` and `grads_out` as the band
    step's. Every composite, filter and gate is forward_envgs's, through
    its pass hooks. With `band_axis` the mesh is 2-D ('band', 'splat'):
    a band's camera is the full camera with its principal point shifted
    up by the band's first row (the JAX package's slab path: not the
    row-crop of the band step), the surface normal and the loss are
    band-exact as in the band step. Stats: the loss terms meaned over the
    mesh, `pair_overflow` (the worst slab's overshoot of its cap) and
    `trace_dropped` (the env slabs' dropped slots), each the bands'
    maximum. The per-splat wet is the slab-local upper bound."""
    if model_cfg.use_base_tracing:
        raise NotImplementedError(
            "the slab base pass rasterizes (no base tracing)")
    s_axis = mesh.axes[splat_axis]
    b_axis = mesh.axes[band_axis] if band_axis else None
    n_bands = b_axis.size if b_axis else 1
    H, W = cam.H, cam.W
    if H % (n_bands * 16):
        raise ValueError(f"H={H} does not split into {n_bands} bands of "
                         "whole 16-pixel tile rows")
    band_h = H // n_bands
    n_all = n_bands * s_axis.size
    sink: dict = {}
    base_pass = _slab_base_pass(s_axis, slab_pair_cap, sink=sink)
    env_pass = _slab_env_pass(s_axis, slab_env_cap)

    def band_reduce(x, op=dist.ReduceOp.SUM):
        return x if b_axis is None else _all_reduce(x, b_axis, op)

    def step(state: TrainState, batch: Batch, K, R, T, it: int,
             mark: Callable[[str], None] | None = None,
             grads_out: dict | None = None):
        bparams, eparams, hooks, _, leaves = step_leaves(state, 2)
        camera = Camera(H, W, K, R, T, cam.znear, cam.zfar)
        K_full = camera.K
        row0 = 0
        if b_axis is not None:
            row0 = b_axis.index * band_h
            camera = camera.crop_rows(row0, band_h)
        out = forward_envgs(
            state.base._replace(params=bparams),
            state.env._replace(params=eparams), camera, it, model_cfg,
            *hooks, base_pass=base_pass, env_pass=env_pass)
        if b_axis is not None:
            out = band_surface_normal(out, b_axis, camera, K_full, H, row0)
        rows = slice(row0, row0 + band_h)
        loss, stats = compute_losses(
            out, batch.rgb[rows], batch.msk[rows],
            batch.norm[rows] if has_norm else None, camera.R, it, loss_cfg,
            bg_brightness=model_cfg.bg_brightness, lpips_fn=lpips_fn,
            band=(b_axis, n_bands, H) if b_axis else None)
        stats = pmean_stats(stats, mesh.world)
        # capacity counters: any slab past its cap, any env slot dropped,
        # in any band
        if "pair_overflow" in sink:
            stats["pair_overflow"] = band_reduce(sink.pop("pair_overflow"),
                                                 dist.ReduceOp.MAX)
        if out.env_dropped_pairs is not None:
            stats["trace_dropped"] = band_reduce(out.env_dropped_pairs,
                                                 dist.ReduceOp.MAX)
        # the composed per-splat outputs are the same on every slab: reduce
        # over the bands alone
        wet_b, vis_b, wet_e = (out.base_wet.detach(), out.base_visibility,
                               out.env_wet.detach())
        radii = out.base_radii.detach()
        if b_axis is not None:
            wet_b, vis_b, wet_e = sum_flat(
                [wet_b, vis_b.to(torch.float32), wet_e], b_axis)
            vis_b = vis_b > 0
            radii = band_reduce(radii, dist.ReduceOp.MAX)
        if mark:
            mark("forward")
        g = step_grads(loss / n_all, leaves, bparams, eparams,
                       reduce=lambda gs: sum_flat(gs, mesh.world))
        new_state = apply_grads(state, g, it, lr_base, lr_env, vis_b,
                                wet_b + g.wet_base, radii, None,
                                wet_e + g.wet_env)
        g.write(grads_out)
        if mark:
            mark("backward")
            mark("optimizer")
        return new_state, stats

    return step

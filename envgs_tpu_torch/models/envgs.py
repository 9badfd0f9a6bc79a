"""EnvGS model: base surfels (rasterized) + environment surfels (ray-traced
along reflected rays), composited by the specular map (port of
envgs_tpu/models/envgs.py, render path).

  base pass (tile rasterizer, rgb + specular + roughness channels)
    -> reflect rays off the rendered depth + normal
    -> environment pass (surfel tracer)
    -> rgb = (1 - specular) * rgb_base + specular * rgb_env

Ported: the render configuration (`render_mode=True`) and the training
configuration (`render_mode=False` with the four zeros hooks the train step
passes: `means2d_zero`, `env_means3d_zero`, `wet_zero`, `env_wet_zero`),
the rasterized base pass and a single env trace, in the radial order of
the blend kernel or, with `tracer_exact_order`, in each ray's exact depth
order (evaluation). Base tracing and multi-bounce tracing raise until
their slices. The reflection gate is a Python `if` on the iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.models.gaussians import GaussianPool, sh_degree_mask
from envgs_tpu_torch.ops import tracer
from envgs_tpu_torch.ops.common import prepare_splats
from envgs_tpu_torch.ops.raster import RenderOutput, rasterize, render_decode
from envgs_tpu_torch.ops.tracer_ref import TraceOutput, prepare_trace_scene
from envgs_tpu_torch.utils.camera import Camera, get_rays
from envgs_tpu_torch.utils.sh import eval_sh_color
from envgs_tpu_torch.utils.transforms import normalize, reflect


class EnvGSConfig(NamedTuple):
    """Forward hyperparameters (the JAX package's fields minus the backend
    names: the device of the inputs picks kernel or plain version)."""

    specular_channels: int = 1
    render_reflection: bool = True
    reflection_start_iter: int = 3000
    depth_ratio: float = 0.0
    bg_brightness: float = 0.0
    env_bg_brightness: float = 0.0
    # stop the env loss's gradient at the reflected rays (no gradient from
    # the env pass into the base pass through ref_o / ref_d)
    detach_reflection: bool = False
    scale_modifier: float = 1.0
    pair_cap: int = 2 ** 21
    env_pair_cap: int = 2 ** 20
    use_base_tracing: bool = False
    max_trace_depth: int = 0
    # a bounce continues only where the specular map exceeds it (read by
    # multi-bounce tracing alone, which raises until it is ported)
    specular_threshold: float = 0.0
    # reflection ray filtering (envgs_sampler.py:434-447): <= 0 disables
    specular_filtering_start_iter: int = -1
    specular_filtering_percent: float = 0.9
    acc_filtering_start_iter: int = -1
    render_mode: bool = False
    tracer_exact_order: bool = False


def _bisect_quantile01(x: torch.Tensor, q: float, iters: int = 10) -> torch.Tensor:
    """Approximate q-quantile of values in [0, 1] by threshold bisection
    (within 2^-iters of the exact quantile)."""
    n = x.numel()
    lo = x.new_zeros(())
    hi = x.new_ones(())
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = torch.sum(x <= mid) / n < q
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _pool_colors(pool: GaussianPool, viewdir_origin: torch.Tensor) -> torch.Tensor:
    """Per-splat SH colors toward `viewdir_origin`, active-degree masked."""
    feats = pool.get_features  # (P, K, 3)
    mask = sh_degree_mask(pool.stats.sh_degree, pool.max_sh_degree)
    feats = feats * mask[None, :, None]
    dirs = normalize(pool.params.xyz - viewdir_origin[None, :])
    return eval_sh_color(pool.max_sh_degree, feats.transpose(1, 2), dirs)


def _pool_colors_at(pool: GaussianPool, ref_o: torch.Tensor) -> torch.Tensor:
    """Env SH colors toward the mean ray origin, the mean taken over 16-row
    blocks first (the JAX package's hierarchical order, which its band-
    parallel path needs for a bit-identical image-global origin)."""
    Hb, W = ref_o.shape[0], ref_o.shape[1]
    if Hb % 16 != 0:
        return _pool_colors(pool, torch.mean(ref_o.reshape(-1, 3), dim=0))
    bm = torch.mean(ref_o.reshape(Hb // 16, 16 * W, 3), dim=1)
    return _pool_colors(pool, torch.mean(bm, dim=0))


def render_base(pool: GaussianPool, cam: Camera, cfg: EnvGSConfig,
                means2d_zero: torch.Tensor | None = None,
                wet_zero: torch.Tensor | None = None) -> RenderOutput:
    """Rasterize the base (diffuse + specular-mask) surfel set. On the
    training path, per-splat wet is the gradient of the (P,) zeros hook
    `wet_zero` and RenderOutput.wet is exact zeros."""
    colors = _pool_colors(pool, cam.center)
    if cfg.render_reflection:
        colors = torch.cat([colors, pool.get_specular, pool.get_roughness],
                           dim=-1)
    prep = prepare_splats(
        pool.params.xyz, pool.params.rotation, pool.get_scaling,
        pool.get_opacity[:, 0], colors, cam,
        scale_modifier=cfg.scale_modifier, active=pool.stats.active,
    )
    bg = torch.full((3,), cfg.bg_brightness, dtype=torch.float32,
                    device=colors.device)
    train = not cfg.render_mode
    out = rasterize(prep, cam, bg, pair_cap=cfg.pair_cap,
                    means2d_zero=means2d_zero,
                    needs=(train, train or cfg.depth_ratio > 0, train),
                    wet_zero=wet_zero)
    return render_decode(
        out, cam,
        specular_channels=cfg.specular_channels if cfg.render_reflection else 0,
        depth_ratio=cfg.depth_ratio,
    )


def reflect_rays(cam: Camera, base: RenderOutput):
    """Reflected ray grid from the base pass (envgs_sampler.py:420-455)."""
    o, d = get_rays(cam, z_depth=True)  # d not normalized (z-depth)
    n = normalize(base.normal_world)
    ref_d = reflect(d, n)
    ref_o = o[None, None, :] + d * base.surf_depth
    return ref_o, ref_d


def render_env(env: GaussianPool, ref_o: torch.Tensor, ref_d: torch.Tensor,
               cfg: EnvGSConfig,
               env_means3d_zero: torch.Tensor | None = None,
               ray_mask: torch.Tensor | None = None,
               wet_zero: torch.Tensor | None = None) -> TraceOutput:
    """Trace the environment surfel set along the reflected rays;
    env_means3d_zero (Pe, 3) zeros is added to the env means, so its
    gradient is the world-space densification gradient."""
    xyz = env.params.xyz
    if env_means3d_zero is not None:
        xyz = xyz + env_means3d_zero
    colors = _pool_colors_at(env, ref_o)
    scene = prepare_trace_scene(
        xyz, env.params.rotation, env.get_scaling,
        env.get_opacity[:, 0], colors, active=env.stats.active,
        scale_modifier=cfg.scale_modifier,
    )
    bg = torch.full((3,), cfg.env_bg_brightness, dtype=torch.float32,
                    device=colors.device)
    train = not cfg.render_mode
    return tracer.trace_rays(scene, ref_o, ref_d, bg,
                             total_pair_cap=cfg.env_pair_cap,
                             ray_mask=ray_mask, needs=(train, train, train),
                             wet_zero=wet_zero,
                             exact_order=cfg.tracer_exact_order)


class EnvGSOutput(NamedTuple):
    rgb_map: torch.Tensor  # (H, W, 3) final composite
    dif_rgb_map: torch.Tensor  # (H, W, 3) diffuse part
    ref_rgb_map: torch.Tensor  # (H, W, 3) reflection (vis-scaled)
    env_rgb_map: torch.Tensor  # (H, W, 3) raw environment render
    spec_map: torch.Tensor  # (H, W, S)
    rough_map: torch.Tensor  # (H, W, 1)
    acc_map: torch.Tensor  # (H, W, 1)
    dpt_map: torch.Tensor  # (H, W, 1)
    norm_map: torch.Tensor  # (H, W, 3) world, unnormalized
    dist_map: torch.Tensor  # (H, W, 1)
    surf_norm_map: torch.Tensor  # (H, W, 3)
    env_dpt_map: torch.Tensor  # (H, W, 1)
    env_acc_map: torch.Tensor  # (H, W, 1)
    ref_o: torch.Tensor  # (H, W, 3)
    ref_d: torch.Tensor  # (H, W, 3)
    base_wet: torch.Tensor  # (P,)
    base_radii: torch.Tensor  # (P,)
    base_visibility: torch.Tensor  # (P,) bool
    env_wet: torch.Tensor  # (Pe,)
    env_visibility: torch.Tensor  # (Pe,) bool
    env_opacity: torch.Tensor  # (Pe, 1)
    base_num_pairs: torch.Tensor  # () raster pairs before the cap
    env_dropped_pairs: torch.Tensor  # () tracer slots dropped by the cap
    env_num_pairs: torch.Tensor  # () tracer chunk-aligned slots used


def forward_envgs(base: GaussianPool, env: GaussianPool, cam: Camera,
                  it: int, cfg: EnvGSConfig,
                  means2d_zero: torch.Tensor | None = None,
                  env_means3d_zero: torch.Tensor | None = None,
                  wet_zero: torch.Tensor | None = None,
                  env_wet_zero: torch.Tensor | None = None) -> EnvGSOutput:
    """One EnvGS forward at iteration `it` (the reflection and filtering
    gates compare against it).

    The zeros hooks, (P, 2), (Pe, 3), (P,), (Pe,): their gradients are the
    screen-space and world-space densification gradients and the base and
    env per-splat wet (base_wet / env_wet are then exact zeros). The
    training configuration (`render_mode=False`) needs the two wet hooks."""
    if cfg.use_base_tracing or cfg.max_trace_depth > 0:
        raise NotImplementedError(
            "base tracing and multi-bounce tracing are not ported yet")
    b = render_base(base, cam, cfg, means2d_zero, wet_zero)
    H, W = cam.H, cam.W
    dev = b.rgb.device
    spec = b.specular if b.specular is not None else b.rgb.new_zeros((H, W, 1))
    rough = b.roughness if b.roughness is not None else b.rgb.new_zeros((H, W, 1))
    ref_o, ref_d = reflect_rays(cam, b)
    if cfg.detach_reflection:
        ref_o, ref_d = ref_o.detach(), ref_d.detach()

    ref_msk = None
    if cfg.specular_filtering_start_iter > 0:
        if it >= cfg.specular_filtering_start_iter:
            thresh = _bisect_quantile01(spec[..., 0],
                                        cfg.specular_filtering_percent)
            ref_msk = spec[..., 0] > thresh
        else:
            ref_msk = torch.ones((H, W), dtype=torch.bool, device=dev)
    elif cfg.acc_filtering_start_iter > 0:
        ref_msk = (b.alpha[..., 0] > 0.75 if it >= cfg.acc_filtering_start_iter
                   else torch.ones((H, W), dtype=torch.bool, device=dev))

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    active = cfg.render_reflection and it >= cfg.reflection_start_iter
    if active:
        e = render_env(env, ref_o, ref_d, cfg, env_means3d_zero,
                       ray_mask=ref_msk, wet_zero=env_wet_zero)
        env_rgb, env_dpt, env_acc = e.rgb, e.dpt[..., None], e.acc[..., None]
        env_wet, env_dropped, env_num_pairs = (e.wet, e.dropped_pairs,
                                               e.num_pairs)
        spec_eff = spec
    else:
        env_rgb = b.rgb.new_zeros((H, W, 3))
        env_dpt = env_acc = b.rgb.new_zeros((H, W, 1))
        env_wet = b.rgb.new_zeros((env.cap,))
        env_dropped = env_num_pairs = zero
        spec_eff = torch.zeros_like(spec)
    if ref_msk is not None:
        spec_eff = torch.where(ref_msk[..., None], spec_eff, 0.0)
    rgb = (1.0 - spec_eff) * b.rgb + spec_eff * env_rgb
    return EnvGSOutput(
        rgb_map=rgb,
        dif_rgb_map=b.rgb * (1.0 - spec),
        ref_rgb_map=env_rgb * spec * 2.0,
        env_rgb_map=env_rgb,
        spec_map=spec,
        rough_map=rough,
        acc_map=b.alpha,
        dpt_map=b.surf_depth,
        norm_map=b.normal_world,
        dist_map=b.distortion,
        surf_norm_map=b.surf_normal,
        env_dpt_map=env_dpt,
        env_acc_map=env_acc,
        ref_o=ref_o,
        ref_d=ref_d,
        base_wet=b.wet,
        base_radii=b.radii,
        base_visibility=b.visibility,
        env_wet=env_wet,
        env_visibility=env_wet > 0,
        env_opacity=env.get_opacity,
        base_num_pairs=b.num_pairs,
        env_dropped_pairs=env_dropped,
        env_num_pairs=env_num_pairs,
    )

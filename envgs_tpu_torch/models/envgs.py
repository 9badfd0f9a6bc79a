"""EnvGS model: base surfels (rasterized) + environment surfels (ray-traced
along reflected rays), composited by the specular map (port of
envgs_tpu/models/envgs.py, render path).

  base pass (tile rasterizer, rgb + specular + roughness channels)
    -> reflect rays off the rendered depth + normal
    -> environment pass (surfel tracer)
    -> rgb = (1 - specular) * rgb_base + specular * rgb_env

The render configuration (`render_mode=True`) and the training
configuration (`render_mode=False` with the four zeros hooks the train step
passes: `means2d_zero`, `env_means3d_zero`, `wet_zero`, `env_wet_zero`);
the base pass rasterized or, with `use_base_tracing`, traced along the
camera rays (`render_base_traced`); the env pass a single trace, in the
radial order of the blend kernel or, with `tracer_exact_order`, in each
ray's exact depth order (evaluation), or with `max_trace_depth > 0`
recursive specular bounces. The backends "ref" run the reference
rasterizer and tracer instead of the kernels. The reflection gate is a
Python `if` on the iteration.

A call may render one horizontal band of the image (`band`, the row-crop
of the band-parallel step, parallel/sharding.py), and the two passes may
be replaced (`base_pass`, `env_pass`: the splat-slab passes of
parallel/splat_sharding.py) while every composite, filter and gate stays
this module's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from envgs_tpu_torch.models.gaussians import GaussianPool, sh_degree_mask
from envgs_tpu_torch.parallel.collectives import all_gather
from envgs_tpu_torch.ops import tracer
from envgs_tpu_torch.ops.common import check_backend, prepare_splats
from envgs_tpu_torch.ops.raster import (
    RenderOutput,
    depth_to_normal,
    rasterize,
    render_decode,
)
from envgs_tpu_torch.ops.tracer_ref import (
    TraceOutput,
    prepare_trace_scene,
    trace_rays_reference,
)
from envgs_tpu_torch.utils.camera import Camera, get_rays
from envgs_tpu_torch.utils.sh import eval_sh_color
from envgs_tpu_torch.utils.timer import span
from envgs_tpu_torch.utils.transforms import normalize, reflect


class EnvGSConfig(NamedTuple):
    """Forward hyperparameters (the JAX package's fields). The backends:
    "pallas" / "tiled" run the kernels on CUDA tensors and their plain
    versions on CPU tensors; "ref" the reference rasterizer / tracer."""

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
    raster_backend: str = "pallas"
    tracer_backend: str = "tiled"
    pair_cap: int = 2 ** 21
    env_pair_cap: int = 2 ** 20
    use_base_tracing: bool = False
    max_trace_depth: int = 0
    # a bounce continues only where the specular map exceeds it (read by
    # multi-bounce tracing alone)
    specular_threshold: float = 0.0
    # reflection ray filtering (envgs_sampler.py:434-447): <= 0 disables
    specular_filtering_start_iter: int = -1
    specular_filtering_percent: float = 0.9
    acc_filtering_start_iter: int = -1
    render_mode: bool = False
    tracer_exact_order: bool = False
    # candidates the env pass's cull keeps per 16x16 ray tile (whole
    # 64-splat chunks, the nearest first); None: the JAX package's
    # tracer.default_per_tile_cap, 2048. The chunks it cuts are counted in
    # EnvGSOutput.env_cut_chunks (the train step's `trace_cut`)
    env_per_tile_cap: int | None = None


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


def _pool_colors_at(pool: GaussianPool, ref_o: torch.Tensor,
                    band_axis=None) -> torch.Tensor:
    """Env SH colors toward the mean ray origin, the mean taken over 16-row
    blocks first, so that a band-parallel run (band_axis, a
    parallel.collectives.Axis: the block means all-gathered over the
    bands) reduces the same values in the same shapes and gets the image's
    origin to the bit."""
    Hb, W = ref_o.shape[0], ref_o.shape[1]
    if Hb % 16 != 0:  # bands are whole 16-row blocks: one image alone
        assert band_axis is None, (Hb, band_axis)
        return _pool_colors(pool, torch.mean(ref_o.reshape(-1, 3), dim=0))
    bm = torch.mean(ref_o.reshape(Hb // 16, 16 * W, 3), dim=1)
    if band_axis is not None:
        bm = all_gather(bm, band_axis, tiled=True)
    return _pool_colors(pool, torch.mean(bm, dim=0))


def _band_camera(cam: Camera, band: tuple | None) -> Camera:
    """The full image's camera of a band's call: cam holds the full
    image's K with H the band's height; band[1] is the image's height."""
    if band is None:
        return cam
    return cam._replace(H=int(band[1]))


def render_base(pool: GaussianPool, cam: Camera, cfg: EnvGSConfig,
                means2d_zero: torch.Tensor | None = None,
                wet_zero: torch.Tensor | None = None,
                band: tuple | None = None) -> RenderOutput:
    """Rasterize the base (diffuse + specular-mask) surfel set. On the
    training path, per-splat wet is the gradient of the (P,) zeros hook
    `wet_zero` and RenderOutput.wet is exact zeros.

    band = (row0, H_full): render the rows [row0, row0 + cam.H) of the
    H_full-row image whose intrinsics cam.K holds (the row-crop: equal to
    the same rows of a full render to the bit, see rasterize's
    row_window)."""
    colors = _pool_colors(pool, cam.center)
    if cfg.render_reflection:
        colors = torch.cat([colors, pool.get_specular, pool.get_roughness],
                           dim=-1)
    cam_proj = _band_camera(cam, band)
    prep = prepare_splats(
        pool.params.xyz, pool.params.rotation, pool.get_scaling,
        pool.get_opacity[:, 0], colors, cam_proj,
        scale_modifier=cfg.scale_modifier, active=pool.stats.active,
    )
    bg = torch.full((3,), cfg.bg_brightness, dtype=torch.float32,
                    device=colors.device)
    train = not cfg.render_mode
    ref = cfg.raster_backend == "ref"
    out = rasterize(prep, cam_proj, bg, pair_cap=cfg.pair_cap,
                    means2d_zero=means2d_zero,
                    needs=(train, train or cfg.depth_ratio > 0, train),
                    wet_zero=None if ref else wet_zero,
                    backend=cfg.raster_backend,
                    row_window=None if band is None else (band[0], cam.H))
    return render_decode(
        out, cam,
        specular_channels=cfg.specular_channels if cfg.render_reflection else 0,
        depth_ratio=cfg.depth_ratio,
        i0=None if band is None else band[0],
    )


def render_base_traced(pool: GaussianPool, cam: Camera, cfg: EnvGSConfig,
                       means3d_zero: torch.Tensor | None = None,
                       wet_zero: torch.Tensor | None = None,
                       band: tuple | None = None) -> RenderOutput:
    """The base pass traced along the camera rays (`use_base_tracing`, the
    reference's start_from_first contract): specular and roughness ride
    the tracer's aux channels; visibility is traced weight > 0 or an
    in-frustum projection; the surface normal comes from the traced depth.
    means3d_zero (P, 3) zeros is added to the means, so its gradient is the
    world-space densification gradient. No pair count (num_pairs None): the
    trace's dropped slots go unreported, as in the JAX package. band: as
    render_base's (the band's camera rays and projection)."""
    i0 = None if band is None else band[0]
    xyz = pool.params.xyz
    if means3d_zero is not None:
        xyz = xyz + means3d_zero
    colors = _pool_colors(pool, cam.center)
    aux = None
    if cfg.render_reflection:
        aux = torch.cat([pool.get_specular, pool.get_roughness], dim=-1)
    scene = prepare_trace_scene(
        xyz, pool.params.rotation, pool.get_scaling, pool.get_opacity[:, 0],
        colors, aux=aux, active=pool.stats.active,
        scale_modifier=cfg.scale_modifier)
    o, d = get_rays(cam, z_depth=True, i0=i0)
    ray_o = o.expand(d.shape)
    bg = torch.full((3,), cfg.bg_brightness, dtype=torch.float32,
                    device=colors.device)
    if cfg.tracer_backend == "ref":
        t = trace_rays_reference(scene, ray_o, d, bg)
    else:
        train = not cfg.render_mode
        t = tracer.trace_rays(scene, ray_o, d, bg,
                              total_pair_cap=cfg.pair_cap,
                              needs=(train, train), wet_zero=wet_zero,
                              exact_order=cfg.tracer_exact_order)
    with torch.no_grad():  # the projection gives visibility alone
        prep = prepare_splats(
            xyz, pool.params.rotation, pool.get_scaling,
            pool.get_opacity[:, 0], colors, _band_camera(cam, band),
            scale_modifier=cfg.scale_modifier, active=pool.stats.active)
    S = cfg.specular_channels if cfg.render_reflection else 0
    alpha = t.acc[..., None]
    depth = t.dpt[..., None]
    return RenderOutput(
        rgb=t.rgb,
        specular=t.aux[..., :S] if S else None,
        roughness=t.aux[..., S:S + 1] if S else None,
        alpha=alpha,
        normal_world=t.norm,
        depth_expected=depth,
        depth_median=depth.detach(),
        surf_depth=depth,
        surf_normal=(depth_to_normal(cam, depth[..., 0], i0=i0)
                     * alpha.detach()),
        distortion=t.dist[..., None],
        wet=t.wet,
        radii=prep.radius,
        visibility=(t.wet > 0) | (prep.radius > 0),
    )


def reflect_rays(cam: Camera, base: RenderOutput, i0=None):
    """Reflected ray grid from the base pass (envgs_sampler.py:420-455);
    i0: a band's first global pixel row."""
    o, d = get_rays(cam, z_depth=True, i0=i0)  # d not normalized (z-depth)
    n = normalize(base.normal_world)
    ref_d = reflect(d, n)
    ref_o = o[None, None, :] + d * base.surf_depth
    return ref_o, ref_d


def render_env(env: GaussianPool, ref_o: torch.Tensor, ref_d: torch.Tensor,
               cfg: EnvGSConfig,
               env_means3d_zero: torch.Tensor | None = None,
               ray_mask: torch.Tensor | None = None,
               wet_zero: torch.Tensor | None = None,
               band_axis=None) -> TraceOutput:
    """Trace the environment surfel set along the reflected rays (with
    `max_trace_depth > 0`, bouncing them on, the env set's specular and
    roughness on the aux channels); env_means3d_zero (Pe, 3) zeros is added
    to the env means, so its gradient is the world-space densification
    gradient. band_axis: the bands' axis of a band-parallel call (the SH
    view origin is the image's, `_pool_colors_at`)."""
    check_backend("tracer", cfg.tracer_backend)
    xyz = env.params.xyz
    if env_means3d_zero is not None:
        xyz = xyz + env_means3d_zero
    colors = _pool_colors_at(env, ref_o, band_axis=band_axis)
    aux = None
    if cfg.max_trace_depth > 0:  # the bounces read the env set's own
        aux = torch.cat([env.get_specular, env.get_roughness], dim=-1)
    scene = prepare_trace_scene(
        xyz, env.params.rotation, env.get_scaling,
        env.get_opacity[:, 0], colors, aux=aux, active=env.stats.active,
        scale_modifier=cfg.scale_modifier,
    )
    bg = torch.full((3,), cfg.env_bg_brightness, dtype=torch.float32,
                    device=colors.device)
    if cfg.max_trace_depth > 0:
        out, _ = tracer.trace_rays_multibounce(
            scene, ref_o, ref_d, bg, max_trace_depth=cfg.max_trace_depth,
            specular_threshold=cfg.specular_threshold,
            backend=cfg.tracer_backend, total_pair_cap=cfg.env_pair_cap,
            ray_mask=ray_mask, per_tile_cap=cfg.env_per_tile_cap)
        return out
    if cfg.tracer_backend == "ref":
        return trace_rays_reference(scene, ref_o, ref_d, bg)
    train = not cfg.render_mode
    return tracer.trace_rays(scene, ref_o, ref_d, bg,
                             per_tile_cap=cfg.env_per_tile_cap,
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
    base_num_pairs: torch.Tensor | None  # () raster pairs before the cap
    #   (None for a traced base pass)
    env_dropped_pairs: torch.Tensor  # () tracer slots dropped by the cap
    env_num_pairs: torch.Tensor  # () tracer chunk-aligned slots used
    env_cut_chunks: torch.Tensor | None = None  # () chunks the env cull's
    #   per-tile cap cut (0 = no ray tile lost a candidate to it)


def forward_envgs(base: GaussianPool, env: GaussianPool, cam: Camera,
                  it: int, cfg: EnvGSConfig,
                  means2d_zero: torch.Tensor | None = None,
                  env_means3d_zero: torch.Tensor | None = None,
                  wet_zero: torch.Tensor | None = None,
                  env_wet_zero: torch.Tensor | None = None,
                  base_pass=None, env_pass=None,
                  band: tuple | None = None) -> EnvGSOutput:
    """One EnvGS forward at iteration `it` (the reflection and filtering
    gates compare against it).

    The zeros hooks, (P, 2), (Pe, 3), (P,), (Pe,): their gradients are the
    screen-space and world-space densification gradients and the base and
    env per-splat wet (base_wet / env_wet are then exact zeros). The
    training configuration (`render_mode=False`) needs the two wet hooks;
    with `use_base_tracing` means2d_zero is the (P, 3) world-space hook.

    base_pass / env_pass: replacements of the two passes, called as
    render_base / render_env are (the splat-slab passes). band = (row0,
    H_full[, axis]): render the rows [row0, row0 + cam.H) of an
    H_full-row image, cam holding the full image's intrinsics (the
    row-crop: the band's base pass equals the same rows of a full render);
    with the bands' axis (parallel.collectives.Axis) the env pass's SH
    view origin is the image's. The specular filter's quantile stays the
    band's own, as in the JAX package."""
    with span("render"):
        check_backend("raster", cfg.raster_backend)
        check_backend("tracer", cfg.tracer_backend)
        i0 = None if band is None else band[0]
        if base_pass is not None:
            b = base_pass(base, cam, cfg, means2d_zero, wet_zero=wet_zero)
        elif cfg.use_base_tracing:
            b = render_base_traced(base, cam, cfg, means2d_zero, wet_zero,
                                   band=band)
        else:
            b = render_base(base, cam, cfg, means2d_zero, wet_zero, band=band)
        H, W = cam.H, cam.W
        dev = b.rgb.device
        spec = b.specular if b.specular is not None else b.rgb.new_zeros((H, W, 1))
        rough = b.roughness if b.roughness is not None else b.rgb.new_zeros((H, W, 1))
        with span("render.reflect"):
            ref_o, ref_d = reflect_rays(cam, b, i0=i0)
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
            ref_msk = (b.alpha[..., 0] > 0.75
                       if it >= cfg.acc_filtering_start_iter
                       else torch.ones((H, W), dtype=torch.bool, device=dev))

        zero = torch.zeros((), dtype=torch.int32, device=dev)
        active = cfg.render_reflection and it >= cfg.reflection_start_iter
        if active:
            env_pass = env_pass or functools.partial(
                render_env, band_axis=band[2] if band is not None
                and len(band) > 2 else None)
            with span("render.env"):
                e = env_pass(env, ref_o, ref_d, cfg, env_means3d_zero,
                             ray_mask=ref_msk, wet_zero=env_wet_zero)
            env_rgb = e.rgb
            env_dpt, env_acc = e.dpt[..., None], e.acc[..., None]
            # the reference tracer has no slot budget: nothing dropped
            env_wet = e.wet
            env_dropped = zero if e.dropped_pairs is None else e.dropped_pairs
            env_num_pairs = zero if e.num_pairs is None else e.num_pairs
            env_cut = zero if e.cut_chunks is None else e.cut_chunks
            spec_eff = spec
        else:
            env_rgb = b.rgb.new_zeros((H, W, 3))
            env_dpt = env_acc = b.rgb.new_zeros((H, W, 1))
            env_wet = b.rgb.new_zeros((env.cap,))
            env_dropped = env_num_pairs = env_cut = zero
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
            env_cut_chunks=env_cut,
        )

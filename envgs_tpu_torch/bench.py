"""The port's bench scenes on one CUDA card (the JAX package's bench
scenes), and the helpers `chip_smoke.py` and the probes time them with:

- render: `make_render_scene`, 1584x1040, 300K base + 32K env surfels,
  rendered through `forward_envgs` (`render_fps`, `stage_times`);
- train: `make_train_scene`, 1558x1038, 500K base + 131K env surfels, one
  EnvGS train step (`make_bench_step`) at it=25000 (`train_stage_times`);
- gaussiant: the train scene's base draws recast as 500K full 3D
  Gaussians (plain 3DGS, `models/gaussiant.py`) in a pool of 2^20 slots,
  1558x1038, SH degree 3, the train scene's target image
  (`gaussiant_render_fps`).

The timers need a CUDA card. The benchmark of the port is `benchmark/`
(BENCHMARK.json at the repository's root).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from envgs_tpu_torch.models.envgs import (
    EnvGSConfig,
    forward_envgs,
    reflect_rays,
    render_base,
    _pool_colors,
    _pool_colors_at,
)
from envgs_tpu_torch.models.gaussians import DensifyConfig, create_pool, logit
from envgs_tpu_torch.models.gaussiant import (
    GaussianTConfig,
    init_gaussiant_state,
    pool_colors,
    prepare_gaussiant,
    render_gaussiant,
)
from envgs_tpu_torch.ops.binning import _ALIGN_N, aligned_markers, bin_splats
from envgs_tpu_torch.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu_torch.ops.raster import _pack_table
from envgs_tpu_torch.ops.raster3d import bin_and_pack
from envgs_tpu_torch.ops.raster_blend import CHUNK, TILE, blend_tiles
from envgs_tpu_torch.ops.trace_blend import trace_blend
from envgs_tpu_torch.ops.tracer import (
    _pack_scene_table,
    build_ray_tiles,
    cull_and_sort,
    default_per_tile_cap,
    splat_radius3,
    tile_mask_of,
)
from envgs_tpu_torch.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.supervisor import LossConfig
from envgs_tpu_torch.train.trainer import (
    Batch,
    ScheduleConfig,
    make_train_step,
)
from envgs_tpu_torch.utils.camera import Camera, get_rays, make_camera

H, W = 1040, 1584
P_BASE, P_ENV = 300_000, 32_768
TRAIN_H, TRAIN_W = 1038, 1558
TRAIN_P_BASE, TRAIN_P_ENV = 500_000, 131_072
TRAIN_IT = 25_000
# caps of the train scene that drop nothing: the JAX bench's 2^21 env cap
# cuts about a quarter of its ~2.8M env slots (bench.py::main_train)
TRAIN_PAIR_CAP = 2 ** 21
TRAIN_ENV_PAIR_CAP = 2 ** 22
# the 3DGS scene: the pool leaves densification about as many free slots
# as it has Gaussians; a pair cap that drops nothing, before or after the
# densification of chip_smoke.py
GAUSSIANT_CAP = 2 ** 20
GAUSSIANT_PAIR_CAP = 2 ** 22


def make_render_scene(device):
    """(base, env, cam, cfg) of the bench scene: the same numpy draws, in
    the same default_rng(0) order, as the JAX package's bench.py."""
    rng = np.random.default_rng(0)
    xyz = np.concatenate(
        [rng.normal(size=(P_BASE, 2)) * 1.5,
         (rng.random((P_BASE, 1)) * 5 + 2.0)], -1
    ).astype(np.float32)
    base = create_pool(xyz, rng.random((P_BASE, 3)).astype(np.float32),
                       cap=P_BASE, sh_degree=3, init_opacity=0.8,
                       device=device)
    # a smooth (wavy) normal field, as a trained reflective scene has
    qv = np.stack([
        np.ones(P_BASE, np.float32),
        0.18 * np.sin(2.0 * xyz[:, 0]),
        0.18 * np.cos(2.0 * xyz[:, 1]),
        0.10 * np.sin(xyz[:, 0] + xyz[:, 1]),
    ], -1).astype(np.float32)
    scal = np.full((P_BASE, 2), np.log(0.012), np.float32)
    spec = np.full((P_BASE, 1), float(logit(0.3)), np.float32)
    base = base._replace(params=base.params._replace(
        rotation=torch.tensor(qv, device=device),
        scaling=torch.tensor(scal, device=device),
        specular=torch.tensor(spec, device=device)))

    dirs = rng.normal(size=(P_ENV, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 20).astype(np.float32),
                      rng.random((P_ENV, 3)).astype(np.float32),
                      cap=P_ENV, sh_degree=3, init_opacity=0.8, device=device)
    env = env._replace(params=env.params._replace(
        scaling=torch.full((P_ENV, 2), float(np.log(0.5)),
                           dtype=torch.float32, device=device)))

    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), 0.02, 100.0, device=device)
    # caps sized to the workload; main() asserts neither pass truncates
    cfg = EnvGSConfig(pair_cap=1_179_648, env_pair_cap=786_432,
                      reflection_start_iter=0, render_mode=True)
    return base, env, cam, cfg


def yawed(cam: Camera, deg: float) -> Camera:
    """The camera turned by `deg` degrees about the view y axis."""
    a = np.deg2rad(deg)
    Ry = cam.R.new_tensor([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                           [-np.sin(a), 0.0, np.cos(a)]])
    return cam._replace(R=Ry @ cam.R, T=Ry @ cam.T)


def check_render(out, cfg: EnvGSConfig):
    """The bench's acceptance: no truncation, finite non-degenerate rgb."""
    n_pairs = int(out.base_num_pairs)
    dropped = int(out.env_dropped_pairs)
    if n_pairs > cfg.pair_cap:
        raise AssertionError(f"base pass truncated: {n_pairs} pairs > "
                             f"pair_cap {cfg.pair_cap}")
    if dropped != 0:
        raise AssertionError(f"env pass dropped {dropped} slots")
    rgb = out.rgb_map
    if not bool(torch.isfinite(rgb).all()):
        raise AssertionError("non-finite rgb")
    std = float(rgb.std())
    if not std > 0.01:
        raise AssertionError(f"degenerate rgb (std {std})")
    return n_pairs, int(out.env_num_pairs), std


def render_fps(base, env, cam, cfg, n: int = 10) -> float:
    """Frames per second over n synchronized renders (one warm-up)."""
    forward_envgs(base, env, cam, 10, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        forward_envgs(base, env, cam, 10, cfg)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def blend_inputs(base, env, cam, cfg):
    """(k1_args, k3_args): the arguments forward_envgs hands the raster
    blend (K1) and the trace blend (K3) when it renders (base, env, cam),
    for comparing each kernel with its plain version on real inputs."""
    colors = torch.cat([_pool_colors(base, cam.center), base.get_specular,
                        base.get_roughness], dim=-1)
    prep = prepare_splats(base.params.xyz, base.params.rotation,
                          base.get_scaling, base.get_opacity[:, 0], colors,
                          cam, active=base.stats.active)
    bins = bin_splats(prep, cam.H, cam.W, TILE, cfg.pair_cap, align=CHUNK,
                      lowpass_r=ROWCULL_LOWPASS_R)
    k1 = (_pack_table(prep, bins.order), bins.gauss_idx, bins.tile_bounds,
          colors.shape[-1], bins.tiles_x, bins.tiles_y)
    ref_o, ref_d = reflect_rays(cam, render_base(base, cam, cfg))
    scene = prepare_trace_scene(
        env.params.xyz, env.params.rotation, env.get_scaling,
        env.get_opacity[:, 0], _pool_colors_at(env, ref_o),
        active=env.stats.active)
    tiles = build_ray_tiles(ref_o, ref_d)
    gidx, bounds, *_ = cull_and_sort(
        tiles, scene, splat_radius3(scene),
        per_tile_cap=default_per_tile_cap(scene.mean.shape[0]),
        total_pair_cap=cfg.env_pair_cap)
    k3 = (_pack_scene_table(scene), gidx, tiles.rays, bounds,
          -(-cam.W // TILE), -(-cam.H // TILE))
    return k1, k3


def train_blend_inputs(base, env, cam, cfg) -> dict:
    """The kernel arguments of a training forward of (base, env, cam):
    k1 (K1 training mode, aligned layout), k3 (K3 training mode) and k5
    (the fill-forward markers of the aligned layout), for comparing each
    training kernel with its plain version on real inputs. The reflected
    rays come from the render-mode base pass, equal to the training one up
    to the last bits."""
    colors = torch.cat([_pool_colors(base, cam.center), base.get_specular,
                        base.get_roughness], dim=-1)
    prep = prepare_splats(base.params.xyz, base.params.rotation,
                          base.get_scaling, base.get_opacity[:, 0], colors,
                          cam, active=base.stats.active)
    bins = bin_splats(prep, cam.H, cam.W, TILE, cfg.pair_cap, align=CHUNK,
                      lowpass_r=ROWCULL_LOWPASS_R, aligned=True)
    k1 = (_pack_table(prep, bins.order), bins.gauss_idx, bins.tile_bounds,
          colors.shape[-1], bins.tiles_x, bins.tiles_y)
    raw = bin_splats(prep, cam.H, cam.W, TILE, cfg.pair_cap, align=CHUNK,
                     lowpass_r=ROWCULL_LOWPASS_R)
    pair_cap = -(-cfg.pair_cap // _ALIGN_N) * _ALIGN_N
    marks, valid, _ = aligned_markers(raw.tile_bounds, pair_cap,
                                      bins.tiles_x * bins.tiles_y, CHUNK)
    ref_o, ref_d = reflect_rays(
        cam, render_base(base, cam, cfg._replace(render_mode=True)))
    scene = prepare_trace_scene(
        env.params.xyz, env.params.rotation, env.get_scaling,
        env.get_opacity[:, 0], _pool_colors_at(env, ref_o),
        active=env.stats.active)
    tiles = build_ray_tiles(ref_o, ref_d)
    gidx, bounds, *_ = cull_and_sort(
        tiles, scene, splat_radius3(scene),
        per_tile_cap=default_per_tile_cap(scene.mean.shape[0]),
        total_pair_cap=cfg.env_pair_cap)
    k3 = (_pack_scene_table(scene), gidx, tiles.rays, bounds,
          -(-cam.W // TILE), -(-cam.H // TILE))
    return dict(k1=k1, k3=k3, k5=(marks, valid))


def trace_inputs(scene, ray_o, ray_d, pair_cap: int, ray_mask=None):
    """(K3 arguments, slots the cull dropped) of tracing `scene` along the
    rays (those of tiles with a ray of `ray_mask`, when given), as
    trace_rays makes them."""
    tiles = build_ray_tiles(ray_o, ray_d)
    H, W = ray_o.shape[:2]
    gidx, bounds, dropped, _ = cull_and_sort(
        tiles, scene, splat_radius3(scene),
        per_tile_cap=default_per_tile_cap(scene.mean.shape[0]),
        total_pair_cap=pair_cap,
        tile_mask=None if ray_mask is None else tile_mask_of(ray_mask))
    return (_pack_scene_table(scene), gidx, tiles.rays, bounds,
            -(-W // TILE), -(-H // TILE)), dropped


def traced_base_scene(base, cam, cfg):
    """(scene, ray_o, ray_d) of the base pass traced along the camera rays
    (use_base_tracing), as render_base_traced makes them: the base set with
    its specular and roughness on the aux channels (A = 2)."""
    o, d = get_rays(cam, z_depth=True)
    scene = prepare_trace_scene(
        base.params.xyz, base.params.rotation, base.get_scaling,
        base.get_opacity[:, 0], _pool_colors(base, cam.center),
        aux=torch.cat([base.get_specular, base.get_roughness], dim=-1),
        active=base.stats.active, scale_modifier=cfg.scale_modifier)
    return scene, o.expand(d.shape), d


def bounce_scene(base, env, cam, cfg, aux: bool = True):
    """(scene, ref_o, ref_d) of the env trace along the reflected rays of
    the render-mode base pass: with `aux`, as multi-bounce tracing makes
    its first bounce (the env set's specular and roughness on the aux
    channels, A = 2), else as the single env trace (A = 0)."""
    ref_o, ref_d = reflect_rays(
        cam, render_base(base, cam, cfg._replace(render_mode=True)))
    scene = prepare_trace_scene(
        env.params.xyz, env.params.rotation, env.get_scaling,
        env.get_opacity[:, 0], _pool_colors_at(env, ref_o),
        aux=(torch.cat([env.get_specular, env.get_roughness], dim=-1)
             if aux else None),
        active=env.stats.active, scale_modifier=cfg.scale_modifier)
    return scene, ref_o, ref_d


def stage_times(base, env, cam, cfg, reps: int = 5) -> dict:
    """Median device ms of each render stage, timed with CUDA events around
    the calls forward_envgs makes; each stage is fed the real output of the
    one before it (the decode between the two passes is not timed alone)."""
    events = {}

    def timed(name, fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = fn()
        e1.record()
        events.setdefault(name, []).append((e0, e1))
        return res

    for _ in range(reps + 1):  # the first pass warms up
        timed("total", lambda: forward_envgs(base, env, cam, 10, cfg))
        colors = timed("sh_colors", lambda: torch.cat(
            [_pool_colors(base, cam.center), base.get_specular,
             base.get_roughness], dim=-1))
        prep = timed("prepare", lambda: prepare_splats(
            base.params.xyz, base.params.rotation, base.get_scaling,
            base.get_opacity[:, 0], colors, cam, active=base.stats.active))
        bins = timed("bin", lambda: bin_splats(
            prep, cam.H, cam.W, TILE, cfg.pair_cap, align=CHUNK,
            lowpass_r=ROWCULL_LOWPASS_R))
        packed = _pack_table(prep, bins.order)
        timed("raster_blend", lambda: blend_tiles(
            packed, bins.gauss_idx, bins.tile_bounds, colors.shape[-1],
            bins.tiles_x, bins.tiles_y))
        b = render_base(base, cam, cfg)
        ref_o, ref_d = timed("reflect", lambda: reflect_rays(cam, b))
        scene = timed("env_scene", lambda: prepare_trace_scene(
            env.params.xyz, env.params.rotation, env.get_scaling,
            env.get_opacity[:, 0], _pool_colors_at(env, ref_o),
            active=env.stats.active))
        tiles = timed("ray_tiles", lambda: build_ray_tiles(ref_o, ref_d))
        gidx, bounds, *_ = timed("cull", lambda: cull_and_sort(
            tiles, scene, splat_radius3(scene),
            per_tile_cap=default_per_tile_cap(P_ENV),
            total_pair_cap=cfg.env_pair_cap))
        packed_env = _pack_scene_table(scene)
        timed("trace_blend", lambda: trace_blend(
            packed_env, gidx, tiles.rays, bounds, -(-cam.W // TILE),
            -(-cam.H // TILE)))
    torch.cuda.synchronize()
    return {k: statistics.median(e0.elapsed_time(e1) for e0, e1 in v[1:])
            for k, v in events.items()}


def make_train_scene(device, P: int = TRAIN_P_BASE, Pe: int = TRAIN_P_ENV,
                     Ht: int = TRAIN_H, Wt: int = TRAIN_W,
                     cap: int | None = None, env_cap: int | None = None,
                     base_scale: float = 0.012):
    """(base, env, cam, cfg, batch) of the train bench scene: the same numpy
    draws, in the same default_rng(0) order, as the JAX package's
    bench.py::main_train, the batch image included; caps that drop
    nothing. The defaults are the bench's sizes; `cap` / `env_cap` above
    P / Pe leave free pool slots (for densification), the other arguments
    shrink the scene for small runs (`base_scale`, the base surfels' size,
    then grows with the pixel: 0.012 covers a few pixels at full size)."""
    rng = np.random.default_rng(0)
    cap, env_cap = cap or P, env_cap or Pe
    xyz = np.concatenate(
        [rng.normal(size=(P, 2)) * 1.5,
         rng.random((P, 1)) * 5 + 2.0], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=cap,
                       sh_degree=3, init_opacity=0.8, device=device)
    full = lambda n, k, v: torch.full((n, k), v, dtype=torch.float32,  # noqa: E731
                                      device=device)
    base = base._replace(params=base.params._replace(
        scaling=full(cap, 2, float(np.log(base_scale))),
        specular=full(cap, 1, float(logit(0.3)))))
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 20).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=env_cap,
                      sh_degree=3, init_opacity=0.8, device=device)
    env = env._replace(params=env.params._replace(
        scaling=full(env_cap, 2, float(np.log(0.5)))))
    f = 0.9 * Wt
    K = np.array([[f, 0, Wt / 2], [0, f, Ht / 2], [0, 0, 1]], np.float32)
    cam = make_camera(Ht, Wt, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), 0.02, 100.0, device=device)
    cfg = EnvGSConfig(pair_cap=TRAIN_PAIR_CAP,
                      env_pair_cap=TRAIN_ENV_PAIR_CAP, reflection_start_iter=0)
    batch = Batch(
        rgb=torch.tensor(rng.random((Ht, Wt, 3)).astype(np.float32),
                         device=device),
        msk=torch.ones((Ht, Wt, 1), device=device),
        norm=torch.zeros((Ht, Wt, 3), device=device))
    return base, env, cam, cfg, batch


RUN_YAWS = (-3.0, -1.0, 1.0, 3.0)  # training views: degrees about view y
RUN_EVAL_YAWS = (-2.0, 2.0)  # held-out views, between them
RUN_FREE = 0.3  # free pool slots per surfel, for densification's children
# densification of the compressed runs: the schedule puts a densify one
# iteration after an opacity reset (thousands lie between them in a real
# schedule), so the prune floor sits below the reset's 0.01 or the densify
# would prune every splat
RUN_DENSIFY = dict(spatial_scale=1.0, min_opacity=0.005)
# the env dome has a radius of 20 and surfels of 0.5: at spatial scale 1
# they would all be pruned as too large for the scene; and the run's pools
# start from a specular of 1e-3, which weighs the env pass's gradients by
# as much: the threshold follows
RUN_DENSIFY_ENV = dict(spatial_scale=20.0, min_opacity=0.005,
                       densify_grad_threshold=2e-7)


def make_run_scene(device, **size):
    """(views, eval_views, base, env, cfg) for a training run on the train
    bench scene (`size`: make_train_scene's arguments; the default is the
    bench's full size): views on a short orbit about the bench camera
    (RUN_YAWS to train on, RUN_EVAL_YAWS held out) whose targets the port
    renders from the scene's own pools (render mode, radial order), masks
    all ones, no normal prior; then the pools to train are perturbed, so
    the run has something to learn: dc colors redrawn, positions jittered
    by 0.01 (default_rng(1)) and the base specular back at the value a
    fresh pool starts from (1e-3; the targets were rendered at the bench's
    0.3). The pools get RUN_FREE more slots than surfels."""
    P = size.get("P", TRAIN_P_BASE)
    Pe = size.get("Pe", TRAIN_P_ENV)
    base, env, cam, cfg, _ = make_train_scene(
        device, cap=-(-int(P * (1 + RUN_FREE)) // 256) * 256,
        env_cap=-(-int(Pe * (1 + RUN_FREE)) // 256) * 256, **size)
    render_cfg = cfg._replace(render_mode=True)

    def view(deg, name):
        pose = yawed(cam, deg)
        with torch.no_grad():
            out = forward_envgs(base, env, pose, TRAIN_IT, render_cfg)
        check_render(out, cfg)
        return dict(rgb=np.clip(out.rgb_map.cpu().numpy(), 0, 1),
                    camera=pose, name=name)

    views = [view(d, f"train{d:+.0f}") for d in RUN_YAWS]
    eval_views = [view(d, f"eval{d:+.0f}") for d in RUN_EVAL_YAWS]
    rng = np.random.default_rng(1)
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)  # noqa: E731
    p = base.params
    act = base.stats.active[:, None]
    base = base._replace(params=p._replace(
        xyz=p.xyz + act * t(rng.normal(scale=0.01, size=p.xyz.shape)),
        features_dc=torch.where(
            act[..., None], t(rng.normal(scale=0.5, size=p.features_dc.shape)),
            p.features_dc),
        specular=torch.full_like(p.specular, float(logit(1e-3)))))
    return views, eval_views, base, env, cfg


def compressed_schedule(**overrides) -> ScheduleConfig:
    """The EnvGS schedule squeezed into 30 iterations so that every
    maintenance event fires at least once: the reflection pass from
    iteration 10; base SH one-ups every 4 and env ones from 12; base densify
    at 3, 6, 9 (the early interval), 10, 15, 20 (the normal-propagation
    phase's) and 24, 27; env densify at 14, 21, 28; base opacity resets at
    9, 18, 27, the last two with a specular reset; env opacity resets at 13
    and 26; color sabotage at 12 and 24 (18 falls to the opacity reset);
    normal propagation at 16 and 24."""
    kw = dict(
        epochs=1, ep_iter=30, densify_from_iter=2, densify_until_iter=29,
        init_densification_interval=3, norm_densification_interval=5,
        opacity_reset_interval=9, sh_update_iter=4,
        env_densify_from_iter=2, env_densify_until_iter=29,
        env_densification_interval=7, env_opacity_reset_interval=13,
        env_sh_update_iter=4, reflection_start_iter=10,
        normal_prop_until_iter=24, normal_prop_interval=8,
        color_sabotage_until_iter=24, color_sabotage_interval=6)
    return ScheduleConfig(**{**kw, **overrides})


def make_bench_step(cam: Camera, cfg: EnvGSConfig):
    """The train bench's step: every default loss but LPIPS, the default
    LR tables, the monocular normal prior on (bench.py::main_train)."""
    return make_train_step(cam, cfg, LossConfig(perc_loss_weight=0.0),
                           LRConfig(), LRConfig(), has_norm=True)


def train_stage_times(step, state, batch, cam: Camera, reps: int = 5,
                      it: int = TRAIN_IT) -> dict:
    """Median device ms of the step's stages (forward with the losses,
    backward, optimizer with the densification statistics) over reps
    steps after one warm-up, from CUDA events recorded between them."""
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[-1].append((name, e))

    for _ in range(reps + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        marks.append([("start", e0)])
        state, _ = step(state, batch, cam.K, cam.R, cam.T, it, mark=mark)
    torch.cuda.synchronize()
    times = {}
    for run in marks[1:]:
        for (_, a), (name, b) in zip(run, run[1:]):
            times.setdefault(name, []).append(a.elapsed_time(b))
        times.setdefault("step", []).append(run[0][1].elapsed_time(run[-1][1]))
    return {k: statistics.median(v) for k, v in times.items()}


def make_gaussiant_scene(device):
    """(state, cam, cfg, dcfg, target) of the 3DGS bench scene: the train
    scene's draws in its default_rng(0) order (the env pool's draws taken
    and dropped, so the target is the train scene's image) as 500K 3D
    Gaussians, random rotations, three scale axes at 0.012, opacity 0.8,
    in a pool of GAUSSIANT_CAP slots; dcfg: the 3DGS densification
    defaults at spatial scale 1 (so these Gaussians split)."""
    rng = np.random.default_rng(0)
    P, Pe, Ht, Wt = TRAIN_P_BASE, TRAIN_P_ENV, TRAIN_H, TRAIN_W
    xyz = np.concatenate(
        [rng.normal(size=(P, 2)) * 1.5,
         rng.random((P, 1)) * 5 + 2.0], -1).astype(np.float32)
    rgb = rng.random((P, 3)).astype(np.float32)
    rng.normal(size=(Pe, 3))
    rng.random((Pe, 3))
    target = torch.tensor(rng.random((Ht, Wt, 3)).astype(np.float32),
                          device=device)
    cfg = GaussianTConfig(sh_degree=3, pair_cap=GAUSSIANT_PAIR_CAP)
    pool = create_pool(xyz, rgb, cap=GAUSSIANT_CAP, sh_degree=3,
                       init_opacity=0.8,
                       init_scales=np.full((P, 3), np.log(0.012), np.float32),
                       scale_axes=3, device=device)
    f = 0.9 * Wt
    K = np.array([[f, 0, Wt / 2], [0, f, Ht / 2], [0, 0, 1]], np.float32)
    cam = make_camera(Ht, Wt, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), 0.02, 100.0, device=device)
    dcfg = DensifyConfig(spatial_scale=1.0, max_gs=GAUSSIANT_CAP)
    return init_gaussiant_state(pool), cam, cfg, dcfg, target


def gaussiant_blend_inputs(pool, cam, cfg: GaussianTConfig):
    """The arguments render_gaussiant hands K1 (gauss3d mode; aligned
    layout) for (pool, cam): (packed, gauss_idx, tile_bounds, C, tiles_x,
    tiles_y), and the pairs before the cap."""
    prep = prepare_gaussiant(pool, cam, cfg, pool_colors(pool, cam.center))
    packed, bins = bin_and_pack(prep, cam, cfg.pair_cap)
    return ((packed, bins.gauss_idx, bins.tile_bounds, prep.color.shape[-1],
             bins.tiles_x, bins.tiles_y), int(bins.num_pairs))


def check_gaussiant(out, cfg: GaussianTConfig):
    """No pair past the cap, finite non-degenerate rgb -> (pairs, std)."""
    n_pairs = int(out.num_pairs)
    if n_pairs > cfg.pair_cap:
        raise AssertionError(f"3DGS render truncated: {n_pairs} pairs > "
                             f"pair_cap {cfg.pair_cap}")
    if not bool(torch.isfinite(out.rgb).all()):
        raise AssertionError("non-finite rgb")
    std = float(out.rgb.std())
    if not std > 0.01:
        raise AssertionError(f"degenerate rgb (std {std})")
    return n_pairs, std


def gaussiant_render_fps(pool, cam, cfg: GaussianTConfig, n: int = 10):
    """Frames per second over n synchronized renders (one warm-up), without
    autograd, as a viewer renders."""
    with torch.no_grad():
        render_gaussiant(pool, cam, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            render_gaussiant(pool, cam, cfg)
        torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


# ---- the kernel-free families' small steps (CUDA against CPU) ----

def _smooth_images(n: int, H: int, W: int, rng) -> np.ndarray:
    """n images of a few random sinusoids in [0.1, 0.9]."""
    yy, xx = np.mgrid[0:H, 0:W] / 8.0
    out = []
    for _ in range(n):
        f = rng.uniform(0.5, 2.0, (3, 2))
        p = rng.uniform(0, 6, 3)
        out.append(np.stack([0.5 + 0.4 * np.sin(f[c, 0] * xx + f[c, 1] * yy
                                                + p[c]) for c in range(3)],
                            -1))
    return np.stack(out).astype(np.float32)


def family_small_step(family: str, device, seed: int = 0,
                      dtype=torch.float32) -> dict:
    """One train step of a small NeRF ("nerf", two rounds), NeuS ("neus",
    with the eikonal term) or ENeRF ("enerf", 32x48, two sources) on
    `device`, from weights and inputs made on the CPU from `seed` (the
    samplers' draws handed in): -> {"loss", "grads", "params", "mu", "nu"}
    as numpy arrays in the parameter tree's leaf order (the parameters and
    moments after the step), "params0" before it, and the step's "lr".
    `dtype` float64 gives the reference float32 is held to."""
    from envgs_tpu_torch.train.families import tree_flatten
    from envgs_tpu_torch.train.optax_adam import adam_init

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(
            dtype)

    if family == "enerf":
        from envgs_tpu_torch.models import enerf as E

        H, W = 32, 48
        cfg = E.ENeRFConfig(n_planes=(8, 4), n_samples=3, cost_dim=4,
                            ibr_hidden=8, feat_dims=(4, 6))
        net = cfg.init(gen).to(dtype).to(device)
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
        cams = []
        for x in (-0.5, 0.45, 0.0):
            a = 0.15 * x
            R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                          [np.sin(a), 0, np.cos(a)]])
            cams.append((K, R, -R @ np.array([x, 0.05 * x, -3.0])))
        imgs = _smooth_images(3, H, W, rng)
        lr = 5e-4
        _, step = E.make_enerf_train_step(
            cfg, Camera(H, W, t(K), t(cams[2][1]), t(cams[2][2])), 2, 1.0,
            6.0, lr)
        args = (*map(t, cams[2]), t(imgs[:2]),
                *(t(np.stack([c[i] for c in cams[:2]])) for i in range(3)),
                t(imgs[2]))
        kw = {}
    else:
        P = 48
        o = rng.normal(size=(P, 3)) * 0.1 + np.array([0.0, 0.0, -2.0])
        d = rng.normal(size=(P, 3)) * 0.3
        d[:, 2] = 1.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        near, far = np.full(P, 0.5), np.full(P, 4.0)
        target = rng.uniform(0, 1, (P, 3))
        args = tuple(map(t, (o, d, near, far, target)))
        if family == "nerf":
            from envgs_tpu_torch.models import nerf as N

            cfg = N.NerfConfig(xyz_freqs=4, dir_freqs=2, width=32, depth=5,
                               feat_dim=16, n_samples=(16, 16),
                               separate_levels=True)
            net = cfg.init(gen).to(dtype).to(device)
            lr = 5e-3
            _, step = N.make_nerf_train_step(cfg, lr)
            kw = dict(draws=[t(rng.uniform(0, 1, (P, n)))
                             for n in cfg.n_samples])
        else:
            from envgs_tpu_torch.models import neus as NS

            cfg = NS.NeusConfig(width=32, depth=4, feat_dim=8, color_width=16,
                                n_samples=16, eikonal_weight=0.5)
            net = cfg.init(gen).to(dtype).to(device)
            lr = 5e-3
            _, step = NS.make_neus_train_step(cfg, lr)
            kw = dict(u=t(rng.uniform(0, 1, (P, cfg.n_samples))))

    def leaves(xs):
        return [x.detach().cpu().numpy().copy() for x in xs]

    params = tree_flatten(net.jax_params())
    params0 = leaves(params)
    out = {}
    state, info = step(net, adam_init(params), *args, grads_out=out, **kw)
    return dict(loss=float(info["loss"]), grads=leaves(out["grads"]),
                params0=params0, params=leaves(params), mu=leaves(state.mu),
                nu=leaves(state.nu), lr=lr)

"""Benchmarks of the port on one CUDA card, the JAX package's bench scenes:

- render: bench.py::make_render_scene, 1584x1040, 300K base + 32K env
  surfels, rendered through `forward_envgs` (render fps);
- train: bench.py::main_train, 1558x1038, 500K base + 131K env surfels,
  one EnvGS train step (`make_train_step`) at it=25000 (train steps/s);
- gaussiant: the train scene's base draws recast as 500K full 3D
  Gaussians (plain 3DGS, `models/gaussiant.py`) in a pool of 2^20 slots,
  1558x1038, SH degree 3, the train scene's target image (render fps and
  train steps/s).

    python -m envgs_tpu_torch.bench             # one JSON line: render fps
    python -m envgs_tpu_torch.bench train       # one JSON line: steps/s
    python -m envgs_tpu_torch.bench gaussiant   # one JSON line: fps, steps/s

Needs a CUDA card; without one it raises instead of timing the CPU.
"""
from __future__ import annotations

import json
import statistics
import sys
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
    make_gaussiant_train_step,
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
)
from envgs_tpu_torch.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.supervisor import LossConfig
from envgs_tpu_torch.train.trainer import (
    Batch,
    init_train_state,
    make_train_step,
)
from envgs_tpu_torch.utils.camera import Camera, make_camera

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
    gidx, bounds, _ = cull_and_sort(
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
    gidx, bounds, _ = cull_and_sort(
        tiles, scene, splat_radius3(scene),
        per_tile_cap=default_per_tile_cap(scene.mean.shape[0]),
        total_pair_cap=cfg.env_pair_cap)
    k3 = (_pack_scene_table(scene), gidx, tiles.rays, bounds,
          -(-cam.W // TILE), -(-cam.H // TILE))
    return dict(k1=k1, k3=k3, k5=(marks, valid))


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
        gidx, bounds, _ = timed("cull", lambda: cull_and_sort(
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


def make_train_scene(device):
    """(base, env, cam, cfg, batch) of the train bench scene: the same numpy
    draws, in the same default_rng(0) order, as the JAX package's
    bench.py::main_train, the batch image included; caps that drop
    nothing."""
    rng = np.random.default_rng(0)
    P, Pe, Ht, Wt = TRAIN_P_BASE, TRAIN_P_ENV, TRAIN_H, TRAIN_W
    xyz = np.concatenate(
        [rng.normal(size=(P, 2)) * 1.5,
         rng.random((P, 1)) * 5 + 2.0], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                       sh_degree=3, init_opacity=0.8, device=device)
    full = lambda n, k, v: torch.full((n, k), v, dtype=torch.float32,  # noqa: E731
                                      device=device)
    base = base._replace(params=base.params._replace(
        scaling=full(P, 2, float(np.log(0.012))),
        specular=full(P, 1, float(logit(0.3)))))
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 20).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                      sh_degree=3, init_opacity=0.8, device=device)
    env = env._replace(params=env.params._replace(
        scaling=full(Pe, 2, float(np.log(0.5)))))
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


def make_bench_step(cam: Camera, cfg: EnvGSConfig):
    """The train bench's step: every default loss but LPIPS, the default
    LR tables, the monocular normal prior on (bench.py::main_train)."""
    return make_train_step(cam, cfg, LossConfig(perc_loss_weight=0.0),
                           LRConfig(), LRConfig(), has_norm=True)


def train_steps_per_sec(step, state, batch, cam: Camera, n: int = 10,
                        it: int = TRAIN_IT):
    """(steps/s, state, stats of the last step) over n synchronized steps,
    after one warm-up step. The state advances through all of them."""
    state, stats = step(state, batch, cam.K, cam.R, cam.T, it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, stats = step(state, batch, cam.K, cam.R, cam.T, it)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), state, stats


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


def gaussiant_stage_times(pool, cam, cfg: GaussianTConfig,
                          reps: int = 5) -> dict:
    """Median device ms of each stage of a 3DGS render (no autograd), CUDA
    events around the calls render_gaussiant makes, each fed the real
    output of the one before it."""
    events = {}

    def timed(name, fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = fn()
        e1.record()
        events.setdefault(name, []).append((e0, e1))
        return res

    with torch.no_grad():
        for _ in range(reps + 1):  # the first pass warms up
            timed("total", lambda: render_gaussiant(pool, cam, cfg))
            colors = timed("sh_colors", lambda: pool_colors(pool, cam.center))
            prep = timed("prepare",
                         lambda: prepare_gaussiant(pool, cam, cfg, colors))
            packed, bins = timed("bin_pack", lambda: bin_and_pack(
                prep, cam, cfg.pair_cap))
            timed("raster_blend", lambda: blend_tiles(
                packed, bins.gauss_idx, bins.tile_bounds, colors.shape[-1],
                bins.tiles_x, bins.tiles_y, train=True, mode="gauss3d",
                wet=True))
    torch.cuda.synchronize()
    return {k: statistics.median(e0.elapsed_time(e1) for e0, e1 in v[1:])
            for k, v in events.items()}


def gaussiant_steps_per_sec(step, state, cam: Camera, target, n: int = 10):
    """(steps/s, state, aux of the last step) over n synchronized steps,
    after one warm-up step. The state advances through all of them."""
    state, aux = step(state, cam.K, cam.R, cam.T, target)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, aux = step(state, cam.K, cam.R, cam.T, target)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), state, aux


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the render benchmark needs a CUDA card")
    base, env, cam, cfg = make_render_scene("cuda")
    check_render(forward_envgs(base, env, cam, 10, cfg), cfg)
    fps = render_fps(base, env, cam, cfg)
    return {"metric": "envgs_full_render_fps_1584x1040", "value": fps,
            "unit": "fps", "device": torch.cuda.get_device_name(0)}


def main_train() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the train benchmark needs a CUDA card")
    base, env, cam, cfg, batch = make_train_scene("cuda")
    sps, _, stats = train_steps_per_sec(make_bench_step(cam, cfg),
                                        init_train_state(base, env), batch,
                                        cam)
    return {"metric": "envgs_train_steps_per_sec_1558x1038", "value": sps,
            "unit": "steps/s", "loss": float(stats["loss"]),
            "pair_overflow": int(stats["pair_overflow"]),
            "trace_dropped": int(stats["trace_dropped"]),
            "device": torch.cuda.get_device_name(0)}


def main_gaussiant() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the 3DGS benchmark needs a CUDA card")
    state, cam, cfg, _, target = make_gaussiant_scene("cuda")
    with torch.no_grad():
        n_pairs, _ = check_gaussiant(render_gaussiant(state.pool, cam, cfg),
                                     cfg)
    fps = gaussiant_render_fps(state.pool, cam, cfg)
    sps, _, aux = gaussiant_steps_per_sec(
        make_gaussiant_train_step(cfg, cam), state, cam, target)
    return {"metric": "gaussiant_render_fps_1558x1038", "value": fps,
            "unit": "fps", "train_steps_per_sec": sps,
            "loss": float(aux["loss"]), "pairs": n_pairs,
            "pair_overflow": int(aux["pair_overflow"]),
            "device": torch.cuda.get_device_name(0)}


if __name__ == "__main__":
    mains = {"train": main_train, "gaussiant": main_gaussiant}
    print(json.dumps(mains[sys.argv[1]]() if sys.argv[1:] else main()))

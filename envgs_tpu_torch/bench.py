"""Render benchmark of the port: the EnvGS bench scene of the JAX package
(bench.py::make_render_scene) at 1584x1040 with 300K base and 32K env
surfels, rendered through `forward_envgs` on one CUDA card.

    python -m envgs_tpu_torch.bench     # one JSON line: render fps

Needs a CUDA card; without one it raises instead of timing the CPU.
"""
from __future__ import annotations

import json
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
from envgs_tpu_torch.models.gaussians import create_pool, logit
from envgs_tpu_torch.ops.binning import bin_splats
from envgs_tpu_torch.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu_torch.ops.raster import _pack_table
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
from envgs_tpu_torch.utils.camera import Camera, make_camera

H, W = 1040, 1584
P_BASE, P_ENV = 300_000, 32_768


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


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the render benchmark needs a CUDA card")
    base, env, cam, cfg = make_render_scene("cuda")
    check_render(forward_envgs(base, env, cam, 10, cfg), cfg)
    fps = render_fps(base, env, cam, cfg)
    return {"metric": "envgs_full_render_fps_1584x1040", "value": fps,
            "unit": "fps", "device": torch.cuda.get_device_name(0)}


if __name__ == "__main__":
    print(json.dumps(main()))

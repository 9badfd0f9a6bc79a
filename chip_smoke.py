"""Smoke test of the PyTorch + CUDA port (envgs_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: refuses to run without a CUDA card; prints the card's name and
     power limit as nvidia-smi reports them, torch and CUDA versions;
  2. build: compiles the CUDA kernels from the sources in this checkout;
  3. kernels: K1 (raster blend) and K3 (trace blend) against their plain
     PyTorch versions on the bench scene's own inputs, max abs error per
     output against a stated bound, median ms of each over repeated runs;
  4. small render: the whole render path on a small scene, CUDA (kernels)
     against CPU (the plain versions the parity tests hold to the JAX
     package);
  5. the slice: the bench scene (1584x1040, 300K base + 32K env surfels)
     rendered through forward_envgs for 3 camera poses — no truncation,
     finite non-degenerate rgb, each kernel launched exactly once per
     render — then render fps and per-stage device ms.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# max abs error allowed between a kernel and its plain version on the same
# inputs: both round every operation alike (the kernels build with
# -fmad=false), so what is left is expf / division ulps moving a pixel
# across the 1e-4 transmittance test, whose flipped contributions are
# bounded by T ~ 1e-4 times a color or normal component
KERNEL_ATOL = 1e-4
# CUDA against CPU on the small scene: two blends in a row plus the
# reflected-ray chain, the tolerance the parity tests hold against JAX
SMALL_ATOL = 1e-4


def cuda_ms(fn, n):
    """Median device ms of fn over n runs (one warm-up), CUDA events."""
    fn()
    pairs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def compare(name, got, want, names, atol):
    """Max abs error per output plane group; raises past atol."""
    errs = {}
    for key, sl in names.items():
        errs[key] = float((got[sl] - want[sl]).abs().max())
    worst = max(errs.values())
    print(f"[kernels] {name} max_abs_err "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (bound {atol:g})", flush=True)
    if not worst <= atol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errs} > {atol}")
    return worst


def small_scene(device):
    """A 64x64 render of 300 base and 400 env surfels (seeded numpy)."""
    from envgs_tpu_torch.models.envgs import EnvGSConfig
    from envgs_tpu_torch.models.gaussians import create_pool
    from envgs_tpu_torch.utils.camera import make_camera

    rng = np.random.default_rng(3)
    P, Pe, H, W, f = 300, 400, 64, 64, 70.0
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                       sh_degree=3, init_opacity=0.6, device=device)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                      sh_degree=3, init_opacity=0.6, device=device)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    cfg = EnvGSConfig(pair_cap=2 ** 15, env_pair_cap=2 ** 15,
                      reflection_start_iter=0, render_mode=True)
    return base, env, cam, cfg


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    from envgs_tpu_torch import bench, kernels
    from envgs_tpu_torch.models.envgs import forward_envgs
    from envgs_tpu_torch.ops.raster_blend import blend_tiles_torch, out_rows
    from envgs_tpu_torch.ops.trace_blend import trace_blend_torch

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    kernels._load()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernels against their plain versions, bench-scene inputs ----
    base, env, cam, cfg = bench.make_render_scene("cuda")
    k1_args, k3_args = bench.blend_inputs(base, env, cam, cfg)
    packed, gauss_idx, bounds, C, tiles_x, tiles_y = k1_args
    print(f"[kernels] K1 inputs: {tiles_x * tiles_y} tiles, "
          f"{int(bounds[-1])} pairs kept after the row cull, "
          f"{gauss_idx.numel()} slots", flush=True)
    r = out_rows(C)
    k1_err = compare(
        "raster_blend_fwd", kernels.raster_blend_fwd(*k1_args),
        blend_tiles_torch(*k1_args),
        {"color": slice(0, C), "depth": r["depth"], "alpha": r["alpha"],
         "normal": slice(r["normal"], r["normal"] + 3), "T": r["trans"]},
        KERNEL_ATOL)
    k1_ms = cuda_ms(lambda: kernels.raster_blend_fwd(*k1_args), 20)
    k1_plain_ms = cuda_ms(lambda: blend_tiles_torch(*k1_args), 10)
    print(f"[kernels] raster_blend_fwd {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.2f} ms", flush=True)

    packed, gauss_idx, rays, bounds, tiles_x, tiles_y = k3_args
    print(f"[kernels] K3 inputs: {tiles_x * tiles_y} tiles, "
          f"{int(bounds[-1])} candidate slots of {gauss_idx.numel()}",
          flush=True)
    k3_err = compare(
        "trace_blend_fwd", kernels.trace_blend_fwd(*k3_args),
        trace_blend_torch(*k3_args),
        {"rgb": slice(0, 3), "acc": 3, "T": 4}, KERNEL_ATOL)
    k3_ms = cuda_ms(lambda: kernels.trace_blend_fwd(*k3_args), 20)
    k3_plain_ms = cuda_ms(lambda: trace_blend_torch(*k3_args), 10)
    print(f"[kernels] trace_blend_fwd {k3_ms:.4f} ms, plain "
          f"{k3_plain_ms:.2f} ms", flush=True)
    del k1_args, k3_args, packed, gauss_idx, rays, bounds

    # ---- 4. small render: CUDA kernels against the CPU plain path ----
    sb, se, sc, scfg = small_scene("cuda")
    got = forward_envgs(sb, se, sc, 10, scfg)
    sb, se, sc, scfg = small_scene("cpu")
    want = forward_envgs(sb, se, sc, 10, scfg)
    errs = {k: float((getattr(got, k).cpu() - getattr(want, k)).abs().max())
            for k in ("rgb_map", "acc_map", "dpt_map", "norm_map",
                      "env_rgb_map")}
    print("[small] cuda vs cpu max_abs_err "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (bound {SMALL_ATOL:g})", flush=True)
    if not max(errs.values()) <= SMALL_ATOL:
        raise AssertionError(f"small render: cuda vs cpu {errs}")

    # ---- 5. the slice: 3 poses of the bench scene ----
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for deg in (0.0, -2.0, 2.0):
        pose = bench.yawed(cam, deg)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward_envgs(base, env, pose, 10, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_pairs, env_slots, std = bench.check_render(out, cfg)
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        print(f"[slice] yaw {deg:+.1f} deg: {ms:.1f} ms, base pairs "
              f"{n_pairs}/{cfg.pair_cap}, env slots {env_slots}/"
              f"{cfg.env_pair_cap}, rgb std {std:.4f}, launches {rose}",
              flush=True)
        if any(v != 1 for v in rose.values()):
            raise AssertionError(f"a kernel did not run exactly once: {rose}")
    launches = dict(kernels.LAUNCHES)
    fps = bench.render_fps(base, env, cam, cfg, n=10)
    print(f"[slice] render fps over 10 renders: {fps:.3f}", flush=True)
    stages = bench.stage_times(base, env, cam, cfg)
    print("[slice] stage ms (median of 5, CUDA events): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)
    print(f"[slice] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    print(json.dumps({"kernels": [
        {"name": "raster_blend_fwd", "route": "cuda",
         "source": "envgs_tpu_torch/kernels/csrc/raster_blend_fwd.cu",
         "replaces": "envgs_tpu/ops/raster_pallas.py:241",
         "launches": launches["raster_blend_fwd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "trace_blend_fwd", "route": "cuda",
         "source": "envgs_tpu_torch/kernels/csrc/trace_blend_fwd.cu",
         "replaces": "envgs_tpu/ops/tracer.py:645",
         "launches": launches["trace_blend_fwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

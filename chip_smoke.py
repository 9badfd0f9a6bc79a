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
  5. the render slice: the bench scene (1584x1040, 300K base + 32K env
     surfels) rendered through forward_envgs for 3 camera poses — no
     truncation, finite non-degenerate rgb, each kernel launched exactly
     once per render — then render fps and per-stage device ms;
  6. training kernels: K5, K1 and K3 in training mode, K2 and K4 against
     their plain versions on the train bench scene's own inputs (random
     cotangents for the backward kernels), errors against stated bounds
     (K2 also within each decade of row size), median ms of each;
  7. small train step: one make_train_step on a small scene from one
     numpy-made state, CUDA (kernels) against CPU (plain versions): loss,
     every gradient, the new params and moments, densification stats;
  8. the train slice: the train bench scene (1558x1038, 500K base + 131K
     env surfels, it=25000) — one warm-up step, then 10 timed steps: finite
     loss and params, no pair overflow and no dropped trace slots, each of
     K1-K5 launched exactly once per step; train steps/s, forward /
     backward / optimizer device ms, peak device memory;
  9. 3DGS kernels: K1 in gauss3d mode (training planes and the per-pair
     forward wet) and K2 in gauss3d mode against their plain versions on
     the 3DGS bench scene's own inputs, errors (K2 per column and within
     each decade of row size) and median ms;
 10. small 3DGS run: render_gaussiant, one make_gaussiant_train_step and
     one densify_and_prune (the same split draws) on a small scene, CUDA
     against CPU;
 11. the 3DGS slice: the 3DGS bench scene (1558x1038, 500K Gaussians in a
     pool of 2^20) — renders that launch K5 and gauss3d K1 once each and
     nothing else, render fps; 1 + 10 train steps, each launching K5 and
     gauss3d K1 and K2 once, train steps/s; gaussiant_maintenance at
     it=600 (densify) and it=3000 (SH one-up, densify, opacity reset) on
     the statistics those steps gathered, active counts and ms; 3 more
     steps with finite loss and params; peak device memory.
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
# backward kernels against their plain versions, per gradient column (and
# per ray-gradient row): max|d| / max|ref|. The kernels sum each pair's
# column over the tile's pixels with warp shuffles and add a splat's pairs
# with atomics, in another order than the plain versions' torch sums (and
# from run to run); the terms are the same
GRAD_RTOL = 1e-4
# the small train step, CUDA against CPU: loss terms (float32 sums in
# another order, two blends and the reflected-ray chain) and arrays derived
# from gradients (per array max|d| / max|ref|, the JAX package's gradient
# budget); env splats that meet a ray only at the 1/255 alpha floor may
# flip visibility with last-bit ray differences: at most FLIP_MAX, each
# with an accumulated weight below 1e-3, left out of elementwise checks
LOSS_RTOL = 1e-4
STEP_RTOL = 5e-4
FLIP_MAX = 2
# densify_and_prune on one input, CUDA against CPU: per array max|d| /
# max|ref|; masks and slots exactly. Children are offsets R @ (eps * s):
# a 3x3 product and an exp, rounded alike up to last bits
DENSIFY_RTOL = 1e-6
RENDER_KERNELS = ("raster_blend_fwd", "trace_blend_fwd")
TRAIN_KERNELS = ("raster_blend_fwd", "raster_blend_bwd", "trace_blend_fwd",
                 "trace_blend_bwd", "fill_forward")
GAUSSIANT_RENDER_KERNELS = ("fill_forward", "raster_blend_fwd_gauss3d")
GAUSSIANT_TRAIN_KERNELS = GAUSSIANT_RENDER_KERNELS + (
    "raster_blend_bwd_gauss3d",)


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


def train_planes(C):
    """The output groups of K1's training planes, for compare()."""
    from envgs_tpu_torch.ops.raster_blend import rows

    r = rows(C)
    return {"color": slice(0, C), "depth": r["depth"], "alpha": r["alpha"],
            "normal": slice(r["normal"], r["normal"] + 3), "med": r["med"],
            "dist": r["dist"], "T": r["trans"], "d1": r["d1"], "d2": r["d2"],
            "last": r["last"]}


def rel_err(got, want):
    """max|got - want| / max|want| (0 for an all-zero reference)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


def compare_columns(name, got, want, cols, rtol):
    """Per-column relative error of a gradient table; raises past rtol.
    Returns (max abs error, worst relative error)."""
    rels = [rel_err(got[:, k], want[:, k]) for k in cols]
    err = float((got[:, cols] - want[:, cols]).abs().max())
    col_max = want[:, cols].abs().amax(0)
    print(f"[kernels] {name} max_abs_err {err:.3g} (largest |value| "
          f"{float(col_max.max()):.3g}, column {cols[int(col_max.argmax())]})"
          f", worst column max|d|/max|ref| {max(rels):.3g} "
          f"(bound {rtol:g})", flush=True)
    if not max(rels) <= rtol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{dict(zip(cols, rels))}")
    return err, max(rels)


def compare_columns_by_size(name, got, want, cols, rtol):
    """compare_columns within each decade of row size (a row's largest
    reference |value| over cols; rows below 1e-6 form one group), so that
    rows of every size are held to their own scale and not only to the
    largest rows of each column. Returns the worst relative error."""
    scale = want[:, cols].abs().amax(1)
    decade = torch.floor(torch.log10(scale.clamp(min=1e-6))).to(torch.int64)
    table = {}
    for k in torch.unique(decade).tolist():
        sel = decade == k
        g, w = got[sel], want[sel]
        table[k] = (int(sel.sum()), max(rel_err(g[:, c], w[:, c])
                                        for c in cols))
    worst = max(r for _, r in table.values())
    print(f"[kernels] {name} by row size: "
          + ", ".join(f"1e{k}: {n} rows {r:.3g}"
                      for k, (n, r) in table.items())
          + f"; worst column max|d|/max|ref| within a decade {worst:.3g} "
          f"(bound {rtol:g})", flush=True)
    if not worst <= rtol:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"within a decade of row size: {table}")
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


def small_train(device):
    """One train step of the small scene from one numpy-made mid-run state
    (random Adam moments at step 10, so updates are smooth in the
    gradients): (start state, new state, stats, gradients)."""
    from envgs_tpu_torch.models.gaussians import GaussianParams
    from envgs_tpu_torch.train.optimizer import AdamState, LRConfig
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import (
        Batch,
        init_train_state,
        make_train_step,
    )

    base, env, cam, cfg = small_scene(device)
    rng = np.random.default_rng(5)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def mid_run(params):
        return AdamState(
            GaussianParams(*(t(rng.normal(size=p.shape) * 1e-3)
                             for p in params)),
            GaussianParams(*(t(rng.random(p.shape) * 1e-5 + 1e-6)
                             for p in params)),
            torch.tensor(10, dtype=torch.int32, device=device))

    state = init_train_state(base, env)._replace(
        opt_base=mid_run(base.params), opt_env=mid_run(env.params))
    batch = Batch(t(rng.random((cam.H, cam.W, 3))),
                  t(rng.random((cam.H, cam.W, 1)) > 0.1),
                  t(rng.random((cam.H, cam.W, 3))))
    loss_cfg = LossConfig(perc_loss_weight=0.0, gs_dist_loss_weight=0.01,
                          gs_dist_loss_start_iter=0,
                          env_opacity_loss_weight=0.01, msk_loss_weight=0.1,
                          msk_loss_start_iter=0)  # every term on
    step = make_train_step(cam, cfg._replace(render_mode=False), loss_cfg,
                           LRConfig(), LRConfig(), has_norm=True)
    grads = {}
    new, stats = step(state, batch, cam.K, cam.R, cam.T, 25_000,
                      grads_out=grads)
    return state, new, stats, grads


def compare_small_train(got, want):
    """Phase 7's checks of a CUDA step (got) against a CPU step (want)."""
    s0, g_new, g_stats, g_grads = got
    _, w_new, w_stats, w_grads = want
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    worst = {}
    for k, w in w_stats.items():
        g = cpu(g_stats[k])
        if w.dtype.is_floating_point:
            worst[f"stat {k}"] = abs(float(g) - float(w)) / max(abs(float(w)),
                                                               1e-30)
            if not worst[f"stat {k}"] <= LOSS_RTOL:
                raise AssertionError(f"small train: {k} {float(g)} vs "
                                     f"{float(w)}")
        elif int(g) != int(w):
            raise AssertionError(f"small train: {k} {int(g)} vs {int(w)}")
    for k in ("base", "env"):
        for f, g, w in zip(w_grads[k]._fields, g_grads[k], w_grads[k]):
            worst[f"grad {k} {f}"] = rel_err(cpu(g), w)
    for k in ("means2d", "env_means3d"):
        worst[f"grad {k}"] = rel_err(cpu(g_grads[k]), w_grads[k])
    bad = {k: v for k, v in worst.items()
           if k.startswith("grad") and not v <= STEP_RTOL}
    if bad:
        raise AssertionError(f"small train gradients: {bad}")
    for k in ("wet_base", "wet_env"):
        g, w = cpu(g_grads[k]), w_grads[k]
        if not torch.allclose(g, w, rtol=1e-2, atol=1e-3):
            raise AssertionError(f"small train {k}: {rel_err(g, w)}")
    for name in ("base", "env"):
        g_pool, w_pool = getattr(g_new, name), getattr(w_new, name)
        flip = cpu(g_pool.stats.denom) != w_pool.stats.denom
        light = ((cpu(g_pool.stats.weight_accum)[flip] < 1e-3).all()
                 and (w_pool.stats.weight_accum[flip] < 1e-3).all())
        if int(flip.sum()) > FLIP_MAX or not light or (
                name == "base" and flip.any()):
            raise AssertionError(f"small train {name}: {int(flip.sum())} "
                                 "splats flip visibility")
        keep = ~flip
        start = getattr(s0, name)
        opt0 = getattr(s0, "opt_" + name)
        pairs = [(f"param {name} {f}", g, w, p0) for f, g, w, p0 in zip(
            w_pool.params._fields, g_pool.params, w_pool.params,
            start.params)]
        for m in ("mu", "nu"):
            pairs += [(f"{m} {name} {f}", g, w, p0) for f, g, w, p0 in zip(
                w_pool.params._fields, getattr(getattr(g_new, "opt_" + name), m),
                getattr(getattr(w_new, "opt_" + name), m),
                getattr(opt0, m))]
        for key, g, w, p0 in pairs:
            p0 = cpu(p0)
            worst[key] = rel_err((cpu(g) - p0)[keep], (w - p0)[keep])
            if not worst[key] <= STEP_RTOL:
                raise AssertionError(f"small train {key}: {worst[key]}")
        gs, ws = g_pool.stats, w_pool.stats
        if not (torch.equal(cpu(gs.max_radii2d)[keep], ws.max_radii2d[keep])
                and torch.equal(cpu(gs.denom)[keep], ws.denom[keep])):
            raise AssertionError(f"small train {name}: visit counts or radii")
        worst[f"grad_accum {name}"] = rel_err(cpu(gs.grad_accum)[keep],
                                              ws.grad_accum[keep])
        if not worst[f"grad_accum {name}"] <= STEP_RTOL:
            raise AssertionError(f"small train {name} grad_accum")
        worst[f"flips {name}"] = int(flip.sum())
    return worst


def small_gaussiant(device):
    """A 64x64 3DGS scene of 300 Gaussians in a pool of 512, from one
    numpy-made mid-run state (SH degree 1 active, anisotropic scales, Adam
    moments at step 10): (state, cam, cfg, target)."""
    from envgs_tpu_torch.models import gaussiant as G
    from envgs_tpu_torch.models.gaussians import GaussianParams
    from envgs_tpu_torch.train.optimizer import AdamState
    from envgs_tpu_torch.utils.camera import make_camera

    rng = np.random.default_rng(6)
    P, cap, H, W, f = 300, 512, 64, 64, 70.0
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    cfg = G.GaussianTConfig(sh_degree=3, pair_cap=2 ** 15)
    pool = G.init_gaussiant_pool(xyz, rng.random((P, 3)).astype(np.float32),
                                 cap, cfg, init_opacity=0.6, device=device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    p = pool.params
    pool = pool._replace(
        params=p._replace(
            scaling=t(np.log(rng.uniform(0.01, 0.06, (cap, 3)))),
            features_rest=t(rng.normal(size=p.features_rest.shape) * 0.2)),
        stats=pool.stats._replace(
            sh_degree=torch.tensor(1, dtype=torch.int32, device=device)))
    opt = AdamState(
        GaussianParams(*(t(rng.normal(size=x.shape) * 1e-3) for x in p)),
        GaussianParams(*(t(rng.random(x.shape) * 1e-5 + 1e-6) for x in p)),
        torch.tensor(10, dtype=torch.int32, device=device))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    return G.GaussianTState(pool, opt), cam, cfg, t(rng.random((H, W, 3)))


def run_small_gaussiant(device):
    """Phase 10's render and train step on one device -> (render, start
    state, new state, aux), states as numpy dicts."""
    from envgs_tpu_torch.models import gaussiant as G

    state, cam, cfg, target = small_gaussiant(device)
    with torch.no_grad():
        out = G.render_gaussiant(state.pool, cam, cfg)
    new, aux = G.make_gaussiant_train_step(cfg, cam)(state, cam.K, cam.R,
                                                     cam.T, target)
    return (out, G.gaussiant_state_to_numpy(state),
            G.gaussiant_state_to_numpy(new), aux)


def densify_small(src: dict, device, eps):
    """Phase 10's densify_and_prune of the numpy state `src` on one device,
    with the split draws `eps` and the weight-quantile split on -> the
    densified state as a numpy dict."""
    from envgs_tpu_torch.models import gaussiant as G
    from envgs_tpu_torch.models.gaussians import (
        DensifyConfig,
        densify_and_prune,
    )

    state = G.gaussiant_state_from_numpy(src, device)
    pool, (mu, nu) = densify_and_prune(
        state.pool, (state.opt.mu, state.opt.nu),
        DensifyConfig(spatial_scale=1.0, min_weight_threshold=0.3),
        eps=[e.to(device) for e in eps])
    return G.gaussiant_state_to_numpy(G.GaussianTState(
        pool, state.opt._replace(mu=mu, nu=nu)))


def compare_small_gaussiant(got, want, g_dens, w_dens):
    """Phase 10's checks of the CUDA run (got, g_dens) against the CPU run
    (want, w_dens); the densify input is the CPU step's new state."""
    g_out, start, g_new, g_aux = got
    w_out, _, w_new, w_aux = want
    worst = {}
    for k in ("rgb", "depth", "alpha", "trans"):
        worst[f"render {k}"] = float(
            (getattr(g_out, k).cpu() - getattr(w_out, k)).abs().max())
        if not worst[f"render {k}"] <= SMALL_ATOL:
            raise AssertionError(f"small 3DGS render {k}: {worst}")
    if not torch.equal(g_out.radii.cpu(), w_out.radii):
        raise AssertionError("small 3DGS render: radii differ")
    worst["render wet"] = rel_err(g_out.wet.cpu(), w_out.wet)
    for k in ("loss", "psnr"):
        g, w = float(g_aux[k]), float(w_aux[k])
        worst[f"step {k}"] = abs(g - w) / abs(w)
        if not worst[f"step {k}"] <= LOSS_RTOL:
            raise AssertionError(f"small 3DGS step {k}: {g} vs {w}")
    if int(g_aux["n_pts"]) != int(w_aux["n_pts"]):
        raise AssertionError("small 3DGS step: point counts differ")
    for grp in ("params", "mu", "nu"):
        for k, w in w_new[grp].items():
            g = torch.tensor(g_new[grp][k] - start[grp][k])
            worst[f"{grp} {k}"] = rel_err(g, torch.tensor(w - start[grp][k]))
    gs, ws = g_new["stats"], w_new["stats"]
    for k in ("active", "denom", "max_radii2d", "sh_degree"):
        if not np.array_equal(gs[k], ws[k]):
            raise AssertionError(f"small 3DGS step: stats {k} differ")
    worst["grad_accum"] = rel_err(torch.tensor(gs["grad_accum"]),
                                  torch.tensor(ws["grad_accum"]))
    worst["weight_accum"] = rel_err(torch.tensor(gs["weight_accum"]),
                                    torch.tensor(ws["weight_accum"]))
    for k, v in worst.items():
        if not k.startswith(("render", "step")) and not v <= STEP_RTOL:
            raise AssertionError(f"small 3DGS step {k}: {v}")
    if not worst["render wet"] <= STEP_RTOL:
        raise AssertionError(f"small 3DGS render wet: {worst['render wet']}")
    for k, w in w_dens["stats"].items():
        if not np.array_equal(g_dens["stats"][k], w):
            raise AssertionError(f"small 3DGS densify: stats {k} differ")
    for grp in ("params", "mu", "nu"):
        for k, w in w_dens[grp].items():
            worst[f"densify {grp} {k}"] = rel_err(
                torch.tensor(g_dens[grp][k]), torch.tensor(w))
            if not worst[f"densify {grp} {k}"] <= DENSIFY_RTOL:
                raise AssertionError(f"small 3DGS densify {grp} {k}")
    born = int((w_dens["stats"]["active"]
                & ~w_new["stats"]["active"]).sum())
    if born < 5:
        raise AssertionError(f"small 3DGS densify: only {born} children")
    worst["densify children"] = born
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    from envgs_tpu_torch import bench, kernels
    from envgs_tpu_torch.models.envgs import forward_envgs
    from envgs_tpu_torch.models.gaussians import DensifyConfig
    from envgs_tpu_torch.ops.fill_forward import fill_forward_torch
    from envgs_tpu_torch.ops.raster_blend import (
        blend_tiles_bwd_torch,
        blend_tiles_torch,
        out_rows,
    )
    from envgs_tpu_torch.ops.trace_blend import rows as trace_rows
    from envgs_tpu_torch.ops.trace_blend import (
        trace_blend_bwd_torch,
        trace_blend_torch,
    )
    from envgs_tpu_torch.train.trainer import init_train_state

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
        # the render path runs K1 and K3 once each and no training kernel
        if any(v != (k in RENDER_KERNELS) for k, v in rose.items()):
            raise AssertionError(f"render launches off: {rose}")
    render_launches = dict(kernels.LAUNCHES)
    fps = bench.render_fps(base, env, cam, cfg, n=10)
    print(f"[slice] render fps over 10 renders: {fps:.3f}", flush=True)
    stages = bench.stage_times(base, env, cam, cfg)
    print("[slice] stage ms (median of 5, CUDA events): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)
    print(f"[slice] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    del base, env, out

    # ---- 6. training kernels against their plain versions ----
    t0 = time.perf_counter()
    tbase, tenv, tcam, tcfg, tbatch = bench.make_train_scene("cuda")
    print(f"[train] train bench scene built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ins = bench.train_blend_inputs(tbase, tenv, tcam, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)

    marks, valid = ins["k5"]
    got, want = kernels.fill_forward(marks, valid), fill_forward_torch(marks,
                                                                      valid)
    k5_err = int((got != want).sum())
    print(f"[kernels] fill_forward over {marks.shape[1]} slots, "
          f"{int(valid.sum())} markers: {k5_err} positions differ (bound 0)",
          flush=True)
    if k5_err:
        raise AssertionError("fill_forward disagrees with its plain version")
    k5_ms = cuda_ms(lambda: kernels.fill_forward(marks, valid), 20)
    k5_plain_ms = cuda_ms(lambda: fill_forward_torch(marks, valid), 10)
    print(f"[kernels] fill_forward {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} "
          "ms", flush=True)

    k1 = ins["k1"]
    packed, gauss_idx, bounds, C, tiles_x, tiles_y = k1
    print(f"[kernels] K1/K2 training inputs: {tiles_x * tiles_y} tiles, "
          f"{int(bounds[-1])} aligned pair slots of {gauss_idx.numel()}",
          flush=True)
    out1 = kernels.raster_blend_fwd(*k1, 0, True)
    k1t_err = compare(
        "raster_blend_fwd (train)", out1, blend_tiles_torch(*k1, 0, True),
        train_planes(C), KERNEL_ATOL)
    k1t_ms = cuda_ms(lambda: kernels.raster_blend_fwd(*k1, 0, True), 20)
    k1t_plain_ms = cuda_ms(lambda: blend_tiles_torch(*k1, 0, True), 3)
    print(f"[kernels] raster_blend_fwd (train) {k1t_ms:.4f} ms, plain "
          f"{k1t_plain_ms:.2f} ms", flush=True)
    g1 = torch.randn(out1.shape, generator=gen, device="cuda")
    k2_args = (packed, gauss_idx, bounds, out1, g1, C, tiles_x, tiles_y)
    got = kernels.raster_blend_bwd(*k2_args)
    want = blend_tiles_bwd_torch(*k2_args)
    k2_cols = list(range(15 + C)) + [31]
    k2_err, k2_rel = compare_columns(
        "raster_blend_bwd", got, want, k2_cols, GRAD_RTOL)
    k2_rel = max(k2_rel, compare_columns_by_size(
        "raster_blend_bwd", got, want, k2_cols, GRAD_RTOL))
    k2_ms = cuda_ms(lambda: kernels.raster_blend_bwd(*k2_args), 20)
    k2_plain_ms = cuda_ms(lambda: blend_tiles_bwd_torch(*k2_args), 3)
    print(f"[kernels] raster_blend_bwd {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.2f} ms", flush=True)
    del k1, k2_args, out1, g1, got, want

    k3 = ins["k3"]
    packed, gauss_idx, rays, bounds, tiles_x, tiles_y = k3
    print(f"[kernels] K3/K4 training inputs: {tiles_x * tiles_y} tiles, "
          f"{int(bounds[-1])} candidate slots of {gauss_idx.numel()}",
          flush=True)
    r = trace_rows(0)
    out3 = kernels.trace_blend_fwd(*k3, True, 0)
    k3t_err = compare(
        "trace_blend_fwd (train)", out3, trace_blend_torch(*k3, True, 0),
        {"rgb": slice(0, 3), "dpt": r["dpt"], "acc": r["acc"],
         "normal": slice(r["normal"], r["normal"] + 3), "dist": r["dist"],
         "T": r["trans"], "d1": r["d1"], "d2": r["d2"], "last": r["last"]},
        KERNEL_ATOL)
    k3t_ms = cuda_ms(lambda: kernels.trace_blend_fwd(*k3, True, 0), 20)
    k3t_plain_ms = cuda_ms(lambda: trace_blend_torch(*k3, True, 0), 3)
    print(f"[kernels] trace_blend_fwd (train) {k3t_ms:.4f} ms, plain "
          f"{k3t_plain_ms:.2f} ms", flush=True)
    g3 = torch.randn(out3.shape, generator=gen, device="cuda")
    k4_args = (packed, gauss_idx, rays, bounds, out3, g3, tiles_x, tiles_y)
    got, got_rays = kernels.trace_blend_bwd(*k4_args)
    want, want_rays = trace_blend_bwd_torch(*k4_args)
    k4_err, k4_rel = compare_columns(
        "trace_blend_bwd", got, want, list(range(16)) + [31], GRAD_RTOL)
    per_row = lambda x: x[:, :6].transpose(0, 1).reshape(6, -1).T  # noqa: E731
    k4r_err, k4r_rel = compare_columns(
        "trace_blend_bwd (rays)", per_row(got_rays), per_row(want_rays),
        list(range(6)), GRAD_RTOL)
    k4_ms = cuda_ms(lambda: kernels.trace_blend_bwd(*k4_args), 20)
    k4_plain_ms = cuda_ms(lambda: trace_blend_bwd_torch(*k4_args), 3)
    print(f"[kernels] trace_blend_bwd {k4_ms:.4f} ms, plain "
          f"{k4_plain_ms:.2f} ms", flush=True)
    del ins, k3, k4_args, out3, g3, got, want, got_rays, want_rays
    del packed, gauss_idx, rays, bounds, marks, valid

    # ---- 7. small train step: CUDA kernels against the CPU plain path ----
    worst = compare_small_train(small_train("cuda"), small_train("cpu"))
    print("[small-train] cuda vs cpu "
          + json.dumps({k: (v if isinstance(v, int) else float(f"{v:.3g}"))
                        for k, v in worst.items()}), flush=True)
    print(f"[small-train] bounds: loss terms rel {LOSS_RTOL:g}, gradients, "
          f"params, moments and grad_accum max|d|/max|ref| {STEP_RTOL:g}, "
          f"wet rtol 1e-2 atol 1e-3, <= {FLIP_MAX} env visibility flips",
          flush=True)

    # ---- 8. the train slice: the train bench scene, 1 + 10 steps ----
    step = bench.make_bench_step(tcam, tcfg)
    state = init_train_state(tbase, tenv)
    del tbase, tenv
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    per_step, all_stats = [], []
    n_steps = 10
    for i in range(n_steps + 1):
        before = dict(kernels.LAUNCHES)
        if i == 1:  # after the warm-up step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, stats = step(state, tbatch, tcam.K, tcam.R, tcam.T,
                            bench.TRAIN_IT)
        per_step.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        all_stats.append(stats)
    torch.cuda.synchronize()
    sps = n_steps / (time.perf_counter() - t0)
    train_launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (rose, stats) in enumerate(zip(per_step, all_stats)):
        loss = float(stats["loss"])
        of, dr = int(stats["pair_overflow"]), int(stats["trace_dropped"])
        if i in (0, 1, n_steps):
            print(f"[train] step {i}: loss {loss:.6f}, psnr "
                  f"{float(stats['psnr']):.4f}, pair_overflow {of}, "
                  f"trace_dropped {dr}, launches {rose}", flush=True)
        if any(v != (k in TRAIN_KERNELS) for k, v in rose.items()):
            raise AssertionError(f"step {i}: a kernel did not run exactly "
                                 f"once: {rose}")
        if not np.isfinite(loss) or of or dr:
            raise AssertionError(f"step {i}: loss {loss}, pair_overflow {of}"
                                 f", trace_dropped {dr}")
    for pool in (state.base, state.env):
        for name, p in zip(pool.params._fields, pool.params):
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"non-finite {name} after training")
    print(f"[train] train steps/s over {n_steps} steps: {sps:.4f} "
          f"({1e3 / sps:.1f} ms per step); peak device memory "
          f"{peak:.2f} GiB", flush=True)
    stages = bench.train_stage_times(step, state, tbatch, tcam, reps=3)
    print("[train] stage ms (median of 3, CUDA events): "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)

    del step, state, tbatch

    # ---- 9. gauss3d kernels against their plain versions, 3DGS bench ----
    t0 = time.perf_counter()
    gstate, gcam, gcfg, gdcfg, gtarget = bench.make_gaussiant_scene("cuda")
    print(f"[3dgs] 3DGS bench scene built in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    k1g, n_pairs = bench.gaussiant_blend_inputs(gstate.pool, gcam, gcfg)
    packed, gauss_idx, bounds, C, tiles_x, tiles_y = k1g
    print(f"[kernels] gauss3d K1/K2 inputs: {tiles_x * tiles_y} tiles, "
          f"{n_pairs} pairs of pair_cap {gcfg.pair_cap} (nothing dropped), "
          f"{int(bounds[-1])} aligned pair slots used of {gauss_idx.numel()}",
          flush=True)
    if n_pairs > gcfg.pair_cap:
        raise AssertionError("the 3DGS bench scene overflows its pair cap")
    out1, wet1 = kernels.raster_blend_fwd(*k1g, 0, True, "gauss3d", True)
    want1, want_wet = blend_tiles_torch(*k1g, 0, True, "gauss3d", True)
    k1g_err = max(
        compare("raster_blend_fwd (gauss3d)", out1, want1, train_planes(C),
                KERNEL_ATOL),
        compare("raster_blend_fwd (gauss3d) per-pair", wet1, want_wet,
                {"wet": slice(None)}, KERNEL_ATOL))
    print(f"[kernels] gauss3d per-pair wet: largest "
          f"{float(want_wet.max()):.4g}, {int((want_wet > 0).sum())} pairs "
          "with weight", flush=True)
    k1g_ms = cuda_ms(
        lambda: kernels.raster_blend_fwd(*k1g, 0, True, "gauss3d", True), 20)
    k1g_plain_ms = cuda_ms(
        lambda: blend_tiles_torch(*k1g, 0, True, "gauss3d", True), 3)
    print(f"[kernels] raster_blend_fwd (gauss3d) {k1g_ms:.4f} ms, plain "
          f"{k1g_plain_ms:.2f} ms", flush=True)
    g1 = torch.randn(out1.shape, generator=gen, device="cuda")
    k2g_args = (packed, gauss_idx, bounds, out1, g1, C, tiles_x, tiles_y, 0,
                "gauss3d")
    got = kernels.raster_blend_bwd(*k2g_args)
    want = blend_tiles_bwd_torch(*k2g_args)
    # the reference reaches ~1e32 on saturated tiles (the backward rebuilds
    # T through pairs the forward skipped, see PERF.md), so the per-column
    # bound alone would let ordinary rows through: hold each size apart
    g3d_cols = [0, 1, 2, 3, 9, 10, 11] + list(range(15, 15 + C)) + [31]
    k2g_err, k2g_rel = compare_columns(
        "raster_blend_bwd (gauss3d)", got, want, g3d_cols, GRAD_RTOL)
    k2g_rel = max(k2g_rel, compare_columns_by_size(
        "raster_blend_bwd (gauss3d)", got, want, g3d_cols, GRAD_RTOL))
    unused = [4, 5, 6, 7, 8, 12, 13, 14]  # tmat and normal columns
    if got[:, unused].any() or want[:, unused].any():
        raise AssertionError("gauss3d K2 wrote a tmat or normal column")
    k2g_ms = cuda_ms(lambda: kernels.raster_blend_bwd(*k2g_args), 20)
    k2g_plain_ms = cuda_ms(lambda: blend_tiles_bwd_torch(*k2g_args), 3)
    print(f"[kernels] raster_blend_bwd (gauss3d) {k2g_ms:.4f} ms, plain "
          f"{k2g_plain_ms:.2f} ms", flush=True)
    del k1g, k2g_args, out1, wet1, want1, want_wet, g1, got, want
    del packed, gauss_idx, bounds

    # ---- 10. small 3DGS run: CUDA kernels against the CPU plain path ----
    g = torch.Generator().manual_seed(1)
    eps = [torch.randn((512, 3), generator=g)
           for _ in range(DensifyConfig().split_n
                          + DensifyConfig().weight_split_n)]
    want = run_small_gaussiant("cpu")
    got = run_small_gaussiant("cuda")
    worst = compare_small_gaussiant(got, want, densify_small(want[2], "cuda",
                                                             eps),
                                    densify_small(want[2], "cpu", eps))
    print("[small-3dgs] cuda vs cpu "
          + json.dumps({k: (v if isinstance(v, int) else float(f"{v:.3g}"))
                        for k, v in worst.items()}), flush=True)
    print(f"[small-3dgs] bounds: render max abs {SMALL_ATOL:g}, radii and "
          f"stats equal, loss rel {LOSS_RTOL:g}, wet, params, moments and "
          f"grad_accum max|d|/max|ref| {STEP_RTOL:g}, densify masks equal "
          f"and arrays {DENSIFY_RTOL:g}", flush=True)

    # ---- 11. the 3DGS slice: renders, steps, maintenance ----
    from envgs_tpu_torch.models import gaussiant as G

    stages = bench.gaussiant_stage_times(gstate.pool, gcam, gcfg)
    print("[3dgs] render stage ms (median of 5, CUDA events): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0

    def launched(before, want_kernels, what):
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if any(v != (k in want_kernels) for k, v in rose.items()):
            raise AssertionError(f"{what}: launches off: {rose}")
        return {k: v for k, v in rose.items() if v}

    for i in range(2):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = G.render_gaussiant(gstate.pool, gcam, gcfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_pairs, std = bench.check_gaussiant(out, gcfg)
        rose = launched(before, GAUSSIANT_RENDER_KERNELS, f"3DGS render {i}")
        print(f"[3dgs] render {i}: {ms:.1f} ms, pairs {n_pairs}/"
              f"{gcfg.pair_cap}, rgb std {std:.4f}, launches {rose}",
              flush=True)
    del out
    before = dict(kernels.LAUNCHES)
    gfps = bench.gaussiant_render_fps(gstate.pool, gcam, gcfg, n=10)
    if any(kernels.LAUNCHES[k] - before[k] != 11 * (
            k in GAUSSIANT_RENDER_KERNELS) for k in before):
        raise AssertionError("3DGS renders: launches off")
    print(f"[3dgs] render fps over 10 renders: {gfps:.3f}", flush=True)

    gstep = G.make_gaussiant_train_step(gcfg, gcam)

    def steps(state, n, what, timed=False):
        """n steps, each checked; -> (state, steps/s after the first)."""
        t0 = None
        for i in range(n):
            if timed and i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = dict(kernels.LAUNCHES)
            state, aux = gstep(state, gcam.K, gcam.R, gcam.T, gtarget)
            rose = launched(before, GAUSSIANT_TRAIN_KERNELS,
                            f"3DGS {what} step {i}")
            loss, of = float(aux["loss"]), int(aux["pair_overflow"])
            if i in (0, 1, n - 1):
                print(f"[3dgs] {what} step {i}: loss {loss:.6f}, psnr "
                      f"{float(aux['psnr']):.4f}, points {int(aux['n_pts'])},"
                      f" pair_overflow {of}, launches {rose}", flush=True)
            if not np.isfinite(loss) or of:
                raise AssertionError(f"3DGS {what} step {i}: loss {loss}, "
                                     f"pair_overflow {of}")
        torch.cuda.synchronize()
        sps = (n - 1) / (time.perf_counter() - t0) if timed else None
        return state, sps

    gstate, gsps = steps(gstate, 11, "train", timed=True)
    print(f"[3dgs] train steps/s over 10 steps: {gsps:.4f} "
          f"({1e3 / gsps:.1f} ms per step)", flush=True)
    gen_d = torch.Generator(device="cuda").manual_seed(0)
    maint_ms = {}
    for it, what in ((600, "densify"),
                     (3000, "SH one-up + densify + opacity reset")):
        st = gstate.pool.stats
        seen = st.active & (st.denom > 0)
        avg = (st.grad_accum / st.denom.clamp(min=1))[seen]
        q = torch.quantile(avg, avg.new_tensor([0.5, 0.9, 0.99])).tolist()
        print(f"[3dgs] before it={it}: {int(seen.sum())} Gaussians seen, "
              f"screen-gradient norm median {q[0]:.3g}, p90 {q[1]:.3g}, p99 "
              f"{q[2]:.3g}; {int((avg >= gdcfg.densify_grad_threshold).sum())}"
              f" at or above the threshold {gdcfg.densify_grad_threshold:g}",
              flush=True)
        n0 = int(st.active.sum())
        sh0 = int(st.sh_degree)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gstate = G.gaussiant_maintenance(gstate, it, gcfg, gdcfg, gen_d)
        torch.cuda.synchronize()
        maint_ms[it] = (time.perf_counter() - t0) * 1e3
        n1 = int(gstate.pool.stats.active.sum())
        print(f"[3dgs] maintenance it={it} ({what}): {maint_ms[it]:.1f} ms, "
              f"active {n0} -> {n1} of {gstate.pool.cap}, SH degree {sh0} "
              f"-> {int(gstate.pool.stats.sh_degree)}, max opacity "
              f"{float(gstate.pool.get_opacity.max()):.4f}", flush=True)
        gstate, _ = steps(gstate, 3, f"after it={it}")
    for name, p in zip(gstate.pool.params._fields, gstate.pool.params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"3DGS: non-finite {name} after training")
    inf_nu = sum(int((~torch.isfinite(v)).sum()) for v in gstate.opt.nu)
    with torch.no_grad():  # opacity was just reset: rgb is faint here
        n_pairs = int(G.render_gaussiant(gstate.pool, gcam, gcfg).num_pairs)
    if n_pairs > gcfg.pair_cap:
        raise AssertionError(f"3DGS after training: {n_pairs} pairs")
    print(f"[3dgs] after training: params finite, {inf_nu} non-finite Adam "
          f"second moments, {n_pairs} pairs of {gcfg.pair_cap} at "
          f"{int(gstate.pool.stats.active.sum())} Gaussians", flush=True)
    gaussiant_launches = dict(kernels.LAUNCHES)
    print(f"[3dgs] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{ {k: v for k, v in gaussiant_launches.items() if v} }",
          flush=True)

    paths = {"render": render_launches, "train": train_launches,
             "gaussiant": gaussiant_launches}

    def entry(name, src, replaces, err, ms, plain_ms, **extra):
        by_path = {p: n[name] for p, n in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"envgs_tpu_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "launches_by_path": by_path, **extra}

    print(json.dumps({"kernels": [
        entry("raster_blend_fwd", "raster_blend_fwd.cu",
              "envgs_tpu/ops/raster_pallas.py:241", max(k1_err, k1t_err),
              k1t_ms, k1t_plain_ms, render_ms=k1_ms,
              render_plain_ms=k1_plain_ms),
        entry("raster_blend_bwd", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2_err, k2_ms,
              k2_plain_ms, max_rel_err=k2_rel),
        entry("trace_blend_fwd", "trace_blend_fwd.cu",
              "envgs_tpu/ops/tracer.py:645", max(k3_err, k3t_err), k3t_ms,
              k3t_plain_ms, render_ms=k3_ms, render_plain_ms=k3_plain_ms),
        entry("trace_blend_bwd", "trace_blend_bwd.cu",
              "envgs_tpu/ops/tracer.py:799", max(k4_err, k4r_err), k4_ms,
              k4_plain_ms, max_rel_err=max(k4_rel, k4r_rel)),
        entry("fill_forward", "fill_forward.cu",
              "envgs_tpu/ops/fill_forward.py:55", k5_err, k5_ms,
              k5_plain_ms),
        entry("raster_blend_fwd_gauss3d", "raster_blend_fwd.cu",
              "envgs_tpu/ops/raster_pallas.py:241", k1g_err, k1g_ms,
              k1g_plain_ms, mode="gauss3d"),
        entry("raster_blend_bwd_gauss3d", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2g_err, k2g_ms,
              k2g_plain_ms, max_rel_err=k2g_rel, mode="gauss3d"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

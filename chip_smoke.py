"""Smoke test of the PyTorch + CUDA port (envgs_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: refuses to run without a CUDA card; prints the card's name and
     power limit as nvidia-smi reports them, torch and CUDA versions;
  2. build: compiles the CUDA kernels from the sources in this checkout;
     registers, shared bytes, spill bytes and resident blocks per SM of K1
     (render, training, gauss3d with the wet), K2 (both modes), K3 (render
     and training), K4 and K5 as compiled;
  3. kernels: K1 (raster blend) and K3 (trace blend) against their plain
     PyTorch versions on the bench scene's own inputs, max abs error per
     output against a stated bound, median ms of each over repeated runs;
     K1's training variant on the render layout, which a render with the
     median depth (depth_ratio > 0) launches in the render kernel's place;
     what K1's inputs ask (the blend probe's counts: windows walked,
     (pair, warp) combinations a pixel can take, within the footprint,
     evaluated, contributing);
  4. small render: the whole render path on a small scene, CUDA (kernels)
     against CPU (the plain versions the parity tests hold to the JAX
     package), also with depth_ratio = 1 (the median depth);
  5. the render slice: the bench scene (1584x1040, 300K base + 32K env
     surfels) rendered through forward_envgs for 3 camera poses — no
     truncation, finite non-degenerate rgb, each kernel launched exactly
     once per render — then render fps and per-stage device ms;
  6. training kernels: K5, K1 and K3 in training mode, K2 and K4 against
     their plain versions on the train bench scene's own inputs (random
     cotangents for the backward kernels), errors against stated bounds
     (K2 and K4 also within each decade of row size), median ms of each
     (K5 also queued behind a sleep of the card: its time without the
     host's); K1's counts; the spread of 64-slot chunks K4 walks per tile;
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
     each decade of row size), median ms; K1's counts;
 10. small 3DGS run: render_gaussiant, one make_gaussiant_train_step and
     one densify_and_prune (the same split draws) on a small scene, CUDA
     against CPU;
 11. the 3DGS slice: the 3DGS bench scene (1558x1038, 500K Gaussians in a
     pool of 2^20) — renders that launch K5 and gauss3d K1 once each and
     nothing else, render fps; 1 + 10 train steps, each launching K5 and
     gauss3d K1 and K2 once, train steps/s; gaussiant_maintenance at
     it=600 (densify) and it=3000 (SH one-up, densify, opacity reset) on
     the statistics those steps gathered, active counts and ms; 3 more
     steps with finite loss and params; peak device memory;
 12. K6 (segmented scan) on (2^21, 128) f32 with about 500 000 random
     segment starts and one segment of 5000 rows, and P1 / P2 (row gathers)
     at the probe's sizes (a 500 000-row table, 2^21 indices) for bf16 and
     f32, against their plain versions (K6 rtol 1e-5 / atol 1e-4, P1 / P2
     bit-equal); median ms of each, of `table[idx]`, the bytes each moved;
     P2 also at ragged sizes (n = 1, 15, 17, 2^21 - 3) with repeated,
     first, last and out-of-range indices, bit-equal to the clamped
     `table[idx]`;
 13. small run: the compressed 30-iteration schedule (every maintenance
     event) through the Runner on a small scene, CUDA against CPU: each
     iteration starts from the CPU run's state and the same draws; the
     event logs, the state after maintenance (masks exactly) and after the
     step (phase 7's bounds) compared per iteration;
 14. the run at full width: a Runner on the train bench scene with pools
     a third larger than their surfels, 4 views on an orbit, the compressed
     schedule: finite loss and params, every event fired, active counts
     and opacities as the events leave them, K1-K5 once per step (K3/K4
     from the reflection gate on), nothing dropped or the cap growth
     printed; save, resume into a fresh runner (state equal); evaluation
     of two held-out views in exact order (K1 alone) and radial order (K1
     and K3); steps/s with maintenance, ms per event, render ms, memory.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
import json
import os
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
# the small run's steps (phase 13). The step's gradients are held per array
# at STEP_RTOL of the array's largest, past GRAD_FLOOR. A row may miss that
# where a discrete choice of the blends falls differently on inputs that
# differ in their last bits between the devices: the surfel footprint is
# min(exact, low-pass), and a pixel where the two meet sends its gradient to
# the transform columns or to the centre (the forward is continuous there,
# the gradient is not); an env surfel met by a single reflected ray follows
# that ray's last digits. A surfel of a few pixels shows one such pixel. At
# most BRANCH_ROWS rows of a pool in one step, each within BRANCH_RTOL
# (H100 80GB HBM3 against the CPU of its host: 2 rows in the 30 steps, the
# worse at 4.7e-3; a plain K2 that is 5% off on 2% of the splats fails in
# every step; phase 6 holds the backward kernels to their plain versions on
# one set of inputs). The optimizer is held apart: Adam on the
# CPU, fed the card's gradients, must give the card's parameters and moments
# within ADAM_RTOL of each array's largest change. Parameters are not
# compared across the two sets of gradients: Adam's quotient turns a
# gradient of rounding noise into a move of the size of the learning rate
# wherever the second moment is as small (a child of a densify, a rotation
# of an isotropic surfel), whatever the gradient's size
BRANCH_ROWS = 3
BRANCH_RTOL = 2e-2
ADAM_RTOL = 1e-6
# base surfels of a few pixels, as 0.012 gives at the bench's full size
SMALL_RUN = dict(P=1500, Pe=400, Ht=48, Wt=64, base_scale=0.1)
# what float32 cannot tell from rounding in the small run's gradients: the
# losses are means over the image, so a pixel's cotangent is at most about
# 1 / pixels, and the blends carry accumulators of size 1 (total alpha, the
# depth moments, prefixes as total minus suffix) to 2^-23 of themselves.
# After an opacity reset a pool's largest gradient is only some hundred
# times this
GRAD_FLOOR = 2.0 ** -23 / (SMALL_RUN["Ht"] * SMALL_RUN["Wt"])
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
# K1's compiled configurations (train, mode, wet): the render kernel, the
# training kernel (also what a render with the median depth launches), and
# the 3DGS kernel with the per-pair wet
K1_CONFIGS = {"render": (False, "surfel", False),
              "train": (True, "surfel", False),
              "gauss3d": (True, "gauss3d", True)}
# the card's published peaks (H100 SXM, dense, at the 700 W limit): device
# memory rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations per evaluated (slot, pixel) or (slot, ray) pair, read
# off the kernels' sources: the geometry terms every walked slot pays (a
# transcendental or a division counted as one operation). The backward
# kernels add one multiply-add per gradient column they produce. A lower
# count than the kernels execute (blending, tests, reductions are left
# out), so the bound stays a bound.
OPS_SURFEL_TERMS = 44  # raster pixel_terms, surfel: 3x3 transform, low-pass
OPS_GAUSS3D_TERMS = 16  # raster pixel_terms, gauss3d: the EWA conic
OPS_RAY_TERMS = 41  # trace: plane hit t, local (u, v), alpha
# K6 against its plain version: the JAX test's own bound. The kernel sums
# a 1024-row block sequentially in float32 and adds a carry, the plain
# version rounds a float64 running sum once
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4
# row counts that fill no whole stage, run or block of P2's ring
RAGGED_N = (1, 15, 17, 2 ** 21 - 3)


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


def bound_ms(n_bytes, n_ops=0.0):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes moved once over the memory rate and the float32 operations
    over the peak rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def walked(last_plane):
    """(slot, pixel) pairs a blend must evaluate on these inputs: each
    pixel's slots up to its last contributing one (`last` plane of the
    training outputs, -1 where nothing contributes). What a pixel walks
    after that to learn that nothing more contributes is left out."""
    return float((last_plane + 1).clamp(min=0).sum())


def blend_bound(table, slots, planes_in, planes_out, evals, ops_per_eval,
                extra_bytes=0):
    """bound_ms of a blend kernel: the splat table, the walked slots' int32
    indices, the image planes read and written, `extra_bytes` (rays, the
    gradient table), against evals * ops_per_eval operations."""
    n_bytes = (table.numel() * 4 + slots * 4 + extra_bytes
               + (planes_in + planes_out) * 4)
    return bound_ms(n_bytes, evals * ops_per_eval)


def chunk_spread(name, bounds, last_plane, tiles_x, tiles_y):
    """Print the 64-slot chunks a backward blend walks per tile (each
    tile's chunks up to its last contributor's): the spread is the
    imbalance the kernel's grid has to absorb."""
    from envgs_tpu_torch.ops.raster_blend import CHUNK, _to_tiles

    last = _to_tiles(last_plane[None], tiles_x, tiles_y)[0].amax(1)
    nchunks = (bounds[1:] - bounds[:-1]) // CHUNK
    walked_chunks = torch.minimum(
        nchunks, ((last.to(torch.int64) + CHUNK) // CHUNK).clamp(min=0)
    ).to(torch.float32)
    q = torch.quantile(walked_chunks, walked_chunks.new_tensor(
        [0.5, 0.99, 1.0])).tolist()
    total = int(walked_chunks.sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[kernels] {name} chunks walked per tile: median {q[0]:g}, p99 "
          f"{q[1]:g}, max {q[2]:g}, {int((walked_chunks == 0).sum())} empty "
          f"tiles, {total} in all ({total / sms:.0f} per SM; the largest "
          f"tile is {q[2] * sms / max(total, 1):.1%} of that)", flush=True)


def ragged_gather(name, fn, table, idx, n):
    """fn(table, idx') for n indices of idx with a repeated, the first, the
    last and two out-of-range rows among them, bit-equal to table[idx']
    with idx' clamped into the table."""
    S = table.shape[0]
    sub = idx[:n].clone()
    sub[0] = -5
    sub[-1] = S + 7
    if n > 4:
        sub[1], sub[2], sub[3] = 0, S - 1, sub[4]
    got = fn(table, sub)
    torch.cuda.synchronize()
    if not torch.equal(got, table[sub.to(torch.int64).clamp(0, S - 1)]):
        raise AssertionError(f"{name} {table.dtype} n={n}: differs from the "
                             "clamped table[idx]")


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


def seg_inputs(device, n_rows=2 ** 21, n_starts=500_000, long_at=700_000,
               long_len=5000):
    """Phase 12's K6 inputs: (n_rows, 128) standard normals and segment
    starts at n_starts random rows, none inside one stretch of long_len
    rows nor at row 0 (seeded numpy)."""
    rng = np.random.default_rng(0)
    rows = torch.tensor(rng.standard_normal((n_rows, 128)).astype(np.float32),
                        device=device)
    seg = np.zeros(n_rows, np.int32)
    seg[rng.choice(n_rows, n_starts, replace=False)] = 1
    seg[long_at:long_at + long_len] = 0
    seg[0] = 0
    return rows, torch.tensor(seg, device=device)


def run_draws(sched, it, cap_b, cap_e):
    """The random numbers of iteration `it`'s maintenance events, drawn on
    the CPU from a generator seeded with `it`, so that runs on two devices
    use the same ones."""
    from envgs_tpu_torch.models.gaussians import DensifyConfig
    from envgs_tpu_torch.train.trainer import due_events

    g = torch.Generator().manual_seed(1000 + it)
    n_eps = DensifyConfig().split_n + DensifyConfig().weight_split_n
    draws = {}
    for name in due_events(sched, it):
        if name in ("densify_base", "densify_env"):
            cap = cap_b if name == "densify_base" else cap_e
            draws[name] = [torch.randn((cap, 3), generator=g)
                           for _ in range(n_eps)]
        elif name == "color_sabotage":
            draws[name] = torch.rand((cap_b, 1, 3), generator=g)
    return draws


def small_run(device, out_root, start_from=None):
    """Phase 13's run on one device: the compressed schedule through the
    Runner on a small run scene (SMALL_RUN), from mid-run Adam moments
    (seeded numpy), the maintenance draws from run_draws. With
    `start_from` (another run's result), the views take that run's target
    images (a target rendered on the other device differs in its last
    digits, enough to turn the sign of an L1 gradient where a render meets
    it) and every iteration after the first starts from that run's state
    instead of its own. -> (event log, [state after maintenance], [state
    after the step], [target images], [the step's gradients], the two
    LRConfigs), states and gradients as numpy dicts."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.gaussians import (
        DensifyConfig,
        GaussianParams,
    )
    from envgs_tpu_torch.train.optimizer import AdamState, LRConfig
    from envgs_tpu_torch.train.runner import Runner
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import (
        state_from_numpy,
        state_to_numpy,
    )

    views, _, base, env, cfg = bench.make_run_scene(device, **SMALL_RUN)
    if start_from is not None:
        views = [dict(v, rgb=rgb) for v, rgb in zip(views, start_from[3])]
    sched = bench.compressed_schedule()
    runner = Runner(views, base, env,
                    cfg._replace(pair_cap=2 ** 16, env_pair_cap=2 ** 17,
                                 reflection_start_iter=(
                                     sched.reflection_start_iter)),
                    LossConfig(perc_loss_weight=0.0), sched,
                    DensifyConfig(**bench.RUN_DENSIFY),
                    DensifyConfig(**bench.RUN_DENSIFY_ENV),
                    LRConfig(), LRConfig(), exp_name="small",
                    out_root=out_root, resume=False, log_every=10)
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

    runner.state = runner.state._replace(opt_base=mid_run(base.params),
                                         opt_env=mid_run(env.params))
    maintain, after_maint, after_step = runner.maintain, [], []

    def wrapped(st, it, log=None):
        if it > 0:
            after_step.append(state_to_numpy(st))
            if start_from is not None:
                st = state_from_numpy(start_from[2][it - 1],
                                      device)._replace(gen=st.gen)
        st = maintain(st, it, log=log,
                      draws=run_draws(sched, it, base.cap, env.cap))
        after_maint.append(state_to_numpy(st))
        return st

    runner.maintain = wrapped
    step_for, grads = runner._step_fn, []

    def recording(cam):
        step = step_for(cam)

        def with_grads(*args):
            out = {}
            res = step(*args, grads_out=out)
            grads.append({name: {k: v.cpu().numpy() for k, v in
                                 out[name]._asdict().items()}
                          for name in ("base", "env")})
            return res

        return with_grads

    runner._step_fn = recording
    after_step.append(state_to_numpy(runner.train()))
    return (runner.events, after_maint, after_step,
            [v["rgb"] for v in views], grads, (runner.lr_base, runner.lr_env))


def compare_small_run(got, want):
    """Phase 13's checks of the CUDA run (got) against the CPU run (want),
    iteration by iteration (each started from the CPU run's state): events,
    the state after maintenance, visibility, the step's gradients, and the
    optimizer on the card against the CPU's on the card's gradients."""
    from envgs_tpu_torch.train.optimizer import (
        lr_tree_for,
        sparse_adam_update,
    )
    from envgs_tpu_torch.train.trainer import state_from_numpy

    g_events, g_maint, g_step, _, g_grads, _ = got
    w_events, w_maint, w_step, _, w_grads, lrs = want
    if g_events != w_events:
        raise AssertionError(f"small run: events {g_events} vs {w_events}")
    worst = {"maintenance": 0.0, "grads": 0.0, "flips": 0, "branch_rows": 0,
             "branch": 0.0, "adam": 0.0}
    branch_log, failed = [], []
    for it, (gm, wm, gs, ws) in enumerate(zip(g_maint, w_maint, g_step,
                                              w_step)):
        start = state_from_numpy(gm, "cpu")  # the card's own start
        for name, lr in zip(("base", "env"), lrs):
            for k, w in wm[name]["stats"].items():
                if not np.array_equal(gm[name]["stats"][k], w):
                    raise AssertionError(
                        f"small run it {it}: {name} {k} after maintenance")
            for grp in ("params", "mu", "nu"):
                for k, w in wm[name][grp].items():
                    worst["maintenance"] = max(worst["maintenance"], rel_err(
                        torch.tensor(gm[name][grp][k]), torch.tensor(w)))
            if not np.array_equal(gs[name]["stats"]["active"],
                                  ws[name]["stats"]["active"]):
                raise AssertionError(f"small run it {it}: {name} active")
            flip = gs[name]["stats"]["denom"] != ws[name]["stats"]["denom"]
            light = (ws[name]["stats"]["weight_accum"][flip]
                     - wm[name]["stats"]["weight_accum"][flip] < 1e-3).all()
            if int(flip.sum()) > FLIP_MAX or not light:
                raise AssertionError(f"small run it {it}: {int(flip.sum())} "
                                     f"{name} splats flip visibility")
            worst["flips"] = max(worst["flips"], int(flip.sum()))
            # the gradients: per row, the error of every array past
            # GRAD_FLOOR against the array's largest gradient
            ratio = np.zeros(flip.shape[0])
            for k, w in w_grads[it][name].items():
                scale = float(np.abs(w[~flip]).max())
                err = np.abs(g_grads[it][name][k] - w).reshape(
                    flip.shape[0], -1).max(1)
                ratio = np.maximum(ratio, np.maximum(err - GRAD_FLOOR, 0.0)
                                   / max(scale, 1e-30))
            ratio[flip] = 0.0
            branch = np.nonzero(ratio > STEP_RTOL)[0]
            for row in branch:
                branch_log.append((it, name, int(row),
                                   float(f"{ratio[row]:.3g}")))
            if len(branch) > BRANCH_ROWS or ratio.max() > BRANCH_RTOL:
                failed.append((it, name, "gradients", len(branch),
                               float(ratio.max())))
            worst["branch_rows"] = max(worst["branch_rows"], len(branch))
            worst["branch"] = max(worst["branch"], float(ratio.max()))
            ratio[branch] = 0.0
            worst["grads"] = max(worst["grads"], float(ratio.max()))
            # the optimizer: the CPU's Adam from the card's state after
            # maintenance on the card's gradients, against what it stored
            pool = getattr(start, name)
            grads = type(pool.params)(*(torch.tensor(g_grads[it][name][k])
                                        for k in pool.params._fields))
            new_p, new_opt = sparse_adam_update(
                pool.params, grads, getattr(start, "opt_" + name),
                lr_tree_for(it, lr))
            for grp, tree in (("params", new_p), ("mu", new_opt.mu),
                              ("nu", new_opt.nu)):
                for k, ref in zip(tree._fields, tree):
                    z = gm[name][grp][k]
                    d_want = ref.numpy() - z
                    # in the xyz learning rate's warm-up a step moves a
                    # position by tens of float32 ulps of the position
                    # itself: the stored value is allowed two of them
                    ulps = (2 * float(np.spacing(np.abs(z).max()))
                            if grp == "params" else 0.0)
                    err = max(float(np.abs(gs[name][grp][k] - z
                                           - d_want).max()) - ulps, 0.0)
                    r = err / max(float(np.abs(d_want).max()), 1e-30)
                    worst["adam"] = max(worst["adam"], r)
                    if not r <= ADAM_RTOL:
                        failed.append((it, name, f"adam {grp}.{k}", 0, r))
    if branch_log:
        print("[small-run] rows past the gradient bound (iteration, pool, "
              f"row, max|d|/max|ref|): {branch_log}", flush=True)
    if failed:
        raise AssertionError("small run: (iteration, pool, what, rows past "
                             f"the bound, worst): {failed}")
    if not worst["maintenance"] <= DENSIFY_RTOL:
        raise AssertionError(f"small run: maintenance {worst}")
    return worst


def full_run(device, out_root, kernels, size=None):
    """Phase 14: the compressed schedule through the Runner on the run
    scene (full width unless `size` shrinks it), then save, resume and
    evaluation. Returns (per-path launch counts of the run, figures)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.gaussians import DensifyConfig
    from envgs_tpu_torch.train import trainer
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.runner import Runner
    from envgs_tpu_torch.train.supervisor import LossConfig

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    views, eval_views, base, env, cfg = bench.make_run_scene(device,
                                                             **(size or {}))
    print(f"[run] scene: {len(views)} + {len(eval_views)} views of "
          f"{views[0]['camera'].W}x{views[0]['camera'].H}, "
          f"{int(base.stats.active.sum())} base surfels in {base.cap} slots, "
          f"{int(env.stats.active.sum())} env in {env.cap}; targets rendered "
          f"and pools perturbed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # normal propagation once (it=16), not twice: it sets every opacity to
    # 0.9, and on this scene's ~100 surfel layers per pixel the backward's
    # T rebuild (an open fault of both packages, see PERF.md) then reaches
    # 1e20; after a second one at it=24 it passed float32's range on some
    # surfels and their parameters turned NaN. The last line of this phase
    # says how far the next normal propagation would go.
    sched = bench.compressed_schedule(normal_prop_interval=16)
    cfg = cfg._replace(reflection_start_iter=sched.reflection_start_iter)

    def make_runner(resume):
        return Runner(
            views, base, env, cfg, LossConfig(perc_loss_weight=0.0), sched,
            DensifyConfig(max_gs=base.cap, **bench.RUN_DENSIFY),
            DensifyConfig(max_gs=env.cap, **bench.RUN_DENSIFY_ENV),
            LRConfig(),
            LRConfig(), exp_name="run", out_root=out_root,
            eval_views=eval_views, resume=resume, log_every=5,
            save_latest_every=0)

    runner = make_runner(False)
    maintain = runner.maintain
    event_ms, per_iter, snaps = {}, [], []

    class TimedLog(list):
        """The runner's event log; times each event as it is appended."""

        def __init__(self):
            super().__init__()
            self.t = 0.0

        def append(self, item):
            sync()
            now = time.perf_counter()
            event_ms.setdefault(item[1], []).append((now - self.t) * 1e3)
            self.t = now
            super().append(item)

    runner.events = TimedLog()

    def wrapped(st, it, log=None):
        sync()
        snaps.append((time.perf_counter(), dict(kernels.LAUNCHES)))
        n0 = (int(st.base.stats.active.sum()), int(st.env.stats.active.sum()))
        log.t = time.perf_counter()
        st = maintain(st, it, log=log)
        fired = [e for i, e in log if i == it]
        n1 = (int(st.base.stats.active.sum()), int(st.env.stats.active.sum()))
        op = (float(st.base.get_opacity.max()), float(st.env.get_opacity.max()))
        per_iter.append(dict(it=it, events=fired, before=n0, after=n1,
                             max_opacity=op,
                             sh=(int(st.base.stats.sh_degree),
                                 int(st.env.stats.sh_degree))))
        if fired:
            print(f"[run] it {it}: {', '.join(fired)}; active base {n0[0]} -> "
                  f"{n1[0]}, env {n0[1]} -> {n1[1]}; max opacity base "
                  f"{op[0]:.4f}, env {op[1]:.4f}; SH degrees "
                  f"{per_iter[-1]['sh']}", flush=True)
        return st

    runner.maintain = wrapped
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    cap0 = (runner.model_cfg.pair_cap, runner.model_cfg.env_pair_cap)
    t_train = time.perf_counter()
    runner.save = lambda *a, **k: None  # timed apart, below
    state = runner.train()
    sync()
    t_end = time.perf_counter()
    del runner.save
    snaps.append((t_end, dict(kernels.LAUNCHES)))
    run_launches = dict(kernels.LAUNCHES)
    total = sched.total_iters

    # ---- checks of the run ----
    fired = {e for _, e in runner.events}
    if fired != set(trainer.EVENTS):
        raise AssertionError(f"run: events not fired: "
                             f"{set(trainer.EVENTS) - fired}")
    for which, i in (("base", 0), ("env", 1)):
        moved = [r["it"] for r in per_iter if f"densify_{which}" in r["events"]
                 and r["before"][i] != r["after"][i]]
        if not moved:  # (a densify right after a reset may find nothing)
            raise AssertionError(f"run: no densify_{which} changed the "
                                 "active count")
    for rec in per_iter:
        ev = rec["events"]
        for which, i in (("base", 0), ("env", 1)):
            if (f"reset_opacity_{which}" in ev
                    and not rec["max_opacity"][i] <= 0.0100001):
                raise AssertionError(f"run it {rec['it']}: max {which} "
                                     f"opacity {rec['max_opacity'][i]}")
    if per_iter[-1]["sh"][0] < 3 or per_iter[-1]["sh"][1] < 3:
        raise AssertionError(f"run: SH degrees {per_iter[-1]['sh']}")
    for it in range(total):
        rose = {k: snaps[it + 1][1][k] - snaps[it][1][k]
                for k in kernels.LAUNCHES}
        want = TRAIN_KERNELS if it >= sched.reflection_start_iter else (
            "raster_blend_fwd", "raster_blend_bwd", "fill_forward")
        if cuda and any(v != (k in want) for k, v in rose.items()):
            raise AssertionError(f"run it {it}: launches off: {rose}")
    for pool in (state.base, state.env):
        for name, p in zip(pool.params._fields, pool.params):
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"run: non-finite {name}")
    grown = (runner.model_cfg.pair_cap, runner.model_cfg.env_pair_cap)
    sps = total / (t_end - t_train)
    step_ms = [(snaps[i + 1][0] - snaps[i][0]) * 1e3 for i in range(total)]
    figures = dict(
        steps_per_s=sps, caps=(cap0, grown),
        event_ms={k: statistics.median(v) for k, v in event_ms.items()},
        iter_ms_before_gate=statistics.median(
            step_ms[1:sched.reflection_start_iter]),
        iter_ms_after_gate=statistics.median(
            step_ms[sched.reflection_start_iter:]),
        active=(per_iter[0]["before"], per_iter[-1]["after"]))
    print(f"[run] {total} iterations with maintenance: {sps:.4f} steps/s; "
          f"median iteration {figures['iter_ms_before_gate']:.1f} ms before "
          f"the reflection gate, {figures['iter_ms_after_gate']:.1f} ms after;"
          f" pair caps {cap0} -> {grown}"
          + ("" if grown == cap0 else " (the cap growth fired)")
          + "; event ms (median): " + json.dumps(
              {k: round(v, 2) for k, v in figures["event_ms"].items()}),
          flush=True)

    # ---- save, resume into a fresh runner ----
    t0 = time.perf_counter()
    runner.save(total)
    figures["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = make_runner(True)
    figures["load_s"] = time.perf_counter() - t0
    if again.start_iter != total:
        raise AssertionError(f"resume: iteration {again.start_iter}")
    for which in ("base", "env"):
        a, b = getattr(again.state, which), getattr(state, which)
        act = b.stats.active
        n = int(act.sum())
        oa, ob = (getattr(x, "opt_" + which) for x in (again.state, state))
        if int(a.stats.active.sum()) != n or int(oa.step) != int(ob.step):
            raise AssertionError(f"resume: {which} counts")
        for trees in ((a.params, b.params), (oa.mu, ob.mu), (oa.nu, ob.nu)):
            for x, y in zip(*trees):
                if not torch.equal(x[:n], y[act]):
                    raise AssertionError(f"resume: {which} arrays differ")
    files = sorted(os.listdir(again.model_dir))
    size_mb = os.path.getsize(os.path.join(again.model_dir,
                                           "latest.npz")) / 2 ** 20
    print(f"[run] saved {files} in {figures['save_s']:.1f} s (latest.npz "
          f"{size_mb:.0f} MiB), resumed into a fresh runner in "
          f"{figures['load_s']:.1f} s: iteration {again.start_iter}, active "
          "rows, moments and steps equal", flush=True)

    # ---- evaluation: exact order (K1 alone), radial order (K1 and K3) ----
    cam = eval_views[0]["camera"]
    for exact, want in ((True, ("raster_blend_fwd",)),
                        (False, RENDER_KERNELS)):
        before = dict(kernels.LAUNCHES)
        out = again.render_view(cam, exact_order=exact)
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if cuda and any(v != (k in want) for k, v in rose.items()):
            raise AssertionError(f"eval render exact={exact}: {rose}")
        if not bool(torch.isfinite(out.rgb_map).all()):
            raise AssertionError("eval render: non-finite rgb")
        print(f"[run] render exact_order={exact}: launches "
              f"{ {k: v for k, v in rose.items() if v} }", flush=True)
    eval_launches = {k: kernels.LAUNCHES[k] - run_launches[k]
                     for k in run_launches}
    exact = again.test(exact_order=True)["summary"]
    radial = again.test(save_images=False, tag="radial",
                        exact_order=False)["summary"]
    for name, sm in (("exact", exact), ("radial", radial)):
        if not (np.isfinite(sm["psnr_mean"]) and np.isfinite(sm["ssim_mean"])):
            raise AssertionError(f"eval {name}: {sm}")
    with open(os.path.join(again.result_dir, "metrics.json")) as f:
        on_disk = json.load(f)
    if (on_disk["summary"]["tracer_order"] != "exact"
            or len(on_disk["frames"]) != len(eval_views)):
        raise AssertionError("metrics.json is not the exact-order evaluation")
    figures.update(
        exact_ms=exact["time_mean"] * 1e3, radial_ms=radial["time_mean"] * 1e3,
        psnr=(exact["psnr_mean"], radial["psnr_mean"]),
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                  else float("nan")))
    print(f"[run] eval of {len(eval_views)} held-out views: exact order "
          f"{figures['exact_ms']:.1f} ms per render, psnr "
          f"{exact['psnr_mean']:.4f}, ssim {exact['ssim_mean']:.4f}; radial "
          f"order {figures['radial_ms']:.1f} ms, psnr "
          f"{radial['psnr_mean']:.4f}, ssim {radial['ssim_mean']:.4f}; stage "
          f"ms {json.dumps({k: round(v, 2) for k, v in exact['stage_ms'].items()})}"
          f"; peak device memory {figures['peak_gib']:.2f} GiB", flush=True)

    # ---- fault probe: the gradients of a step after one more normal
    # propagation, on a copy of the final state (nothing is kept) ----
    from envgs_tpu_torch.models import gaussians as G

    pool = G.enlarge_scaling(*G.enlarge_opacity(state.base, None))[0]
    grads = {}
    view = views[0]
    runner._step_fn(view["camera"])(
        state._replace(base=pool), runner._batch(view), view["camera"].K,
        view["camera"].R, view["camera"].T, total, grads_out=grads)
    g = grads["base"].xyz
    bad = ~torch.isfinite(g).all(-1)
    figures["probe_nonfinite"] = int(bad.sum())
    figures["probe_max"] = float(g[~bad].abs().max())
    print(f"[run] fault probe: one step after another normal propagation "
          f"(every opacity 0.9): {figures['probe_nonfinite']} of "
          f"{int(pool.stats.active.sum())} surfels get a non-finite position "
          f"gradient, the largest finite one is {figures['probe_max']:.3g} "
          "(the backward's T rebuild over pairs the forward skipped)",
          flush=True)
    return run_launches, eval_launches, figures


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
        gauss3d_slot_columns,
        out_rows,
    )
    from envgs_tpu_torch.ops.raster_blend import rows as raster_rows
    from envgs_tpu_torch.ops.trace_blend import rows as trace_rows
    from envgs_tpu_torch.ops.trace_blend import (
        bwd_slot_columns,
        trace_blend_bwd_torch,
        trace_blend_torch,
    )
    from envgs_tpu_torch.probes.blend_variants import raster_counts
    from envgs_tpu_torch.probes.blend_variants import cuda_ms as queued_ms
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
    k2_resources = {mode: kernels.raster_blend_bwd_resources(mode)
                    for mode in kernels.MODES}
    for mode, res in k2_resources.items():
        print(f"[build] raster_blend_bwd ({mode}): {res['registers']} "
              f"registers, {res['shared_bytes']} B shared, "
              f"{res['blocks_per_sm']} blocks of 256 threads per SM",
              flush=True)
        if res["blocks_per_sm"] < 1:
            raise AssertionError(f"K2 ({mode}) fits no block on an SM")
    k1_resources = {cfg: kernels.raster_blend_fwd_resources(*args)
                    for cfg, args in K1_CONFIGS.items()}
    k3_resources = {"render": kernels.trace_blend_fwd_resources(False),
                    "train": kernels.trace_blend_fwd_resources(True, 0)}
    k4_resources = kernels.trace_blend_bwd_resources(0)
    k5_resources = kernels.fill_forward_resources()
    for name, res, threads in (
            *((f"raster_blend_fwd ({cfg})", res, 256)
              for cfg, res in k1_resources.items()),
            ("trace_blend_fwd (render)", k3_resources["render"], 256),
            ("trace_blend_fwd (train)", k3_resources["train"], 256),
            ("trace_blend_bwd", k4_resources, 32),
            ("fill_forward", k5_resources, 256)):
        print(f"[build] {name}: {res['registers']} registers, "
              f"{res['shared_bytes']} B shared, {res['local_bytes']} B "
              f"spilled, {res['blocks_per_sm']} blocks of {threads} threads "
              "per SM", flush=True)
        if res["blocks_per_sm"] < 1:
            raise AssertionError(f"{name} fits no block on an SM")

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
    npix = tiles_x * tiles_y * 256
    k1_bound = blend_bound(
        packed, int(bounds[-1]), 0, (C + 6) * npix,
        walked(kernels.raster_blend_fwd(*k1_args, 0, True)[
            raster_rows(C)["last"]]), OPS_SURFEL_TERMS)
    print(f"[kernels] raster_blend_fwd {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.2f} ms, bound {k1_bound[0]:.4f} ms by "
          f"{k1_bound[1]}", flush=True)
    k1_med_err = compare(
        "raster_blend_fwd (render layout, median depth)",
        kernels.raster_blend_fwd(*k1_args, 0, True),
        blend_tiles_torch(*k1_args, 0, True), train_planes(C), KERNEL_ATOL)
    k1_med_ms = cuda_ms(lambda: kernels.raster_blend_fwd(*k1_args, 0, True),
                        20)
    print(f"[kernels] raster_blend_fwd with the median depth (its training "
          f"variant on the render layout, what depth_ratio > 0 launches in "
          f"render mode): {k1_med_ms:.4f} ms, {k1_med_ms - k1_ms:+.4f} ms "
          "against the render kernel", flush=True)
    raster_counts(k1_args, "surfel", "K1 render")

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
    npix = tiles_x * tiles_y * 256
    k3_bound = blend_bound(
        packed, int(bounds[-1]), 0, 5 * npix,
        walked(kernels.trace_blend_fwd(*k3_args, True, 0)[
            trace_rows(0)["last"]]), OPS_RAY_TERMS,
        extra_bytes=rays.numel() * 4)
    print(f"[kernels] trace_blend_fwd {k3_ms:.4f} ms, plain "
          f"{k3_plain_ms:.2f} ms, bound {k3_bound[0]:.4f} ms by "
          f"{k3_bound[1]}", flush=True)
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
    # render mode with the median depth (depth_ratio = 1): K1 once, as ever
    med = {}
    for dev in ("cuda", "cpu"):
        sb, se, sc, scfg = small_scene(dev)
        before = dict(kernels.LAUNCHES)
        med[dev] = forward_envgs(sb, se, sc, 10,
                                 scfg._replace(depth_ratio=1.0))
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if dev == "cuda" and any(v != (k in RENDER_KERNELS)
                                 for k, v in rose.items()):
            raise AssertionError(f"median-depth render launches off: {rose}")
    errs = {k: float((getattr(med["cuda"], k).cpu()
                      - getattr(med["cpu"], k)).abs().max())
            for k in ("rgb_map", "acc_map", "dpt_map", "norm_map",
                      "surf_norm_map", "env_rgb_map")}
    moved = float((med["cpu"].dpt_map - want.dpt_map).abs().max())
    print("[small] depth_ratio = 1 (median depth), cuda vs cpu max_abs_err "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (bound {SMALL_ATOL:g}); the depth map moves by up to "
          f"{moved:.3g} against depth_ratio = 0", flush=True)
    if not max(errs.values()) <= SMALL_ATOL or not moved > 0:
        raise AssertionError(f"small render with the median depth: {errs}")

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
    pos = torch.arange(marks.shape[1], device="cuda")
    k5_lib_ms = cuda_ms(
        lambda: torch.cummax(torch.where(valid.bool(), pos, -1), 0), 20)
    k5_dev_ms = queued_ms(lambda: kernels.fill_forward(marks, valid), 20)
    k5_bound = bound_ms(valid.numel() * 4 + int(valid.sum()) * marks.shape[0]
                        * 4 + marks.numel() * 4)
    print(f"[kernels] fill_forward {k5_ms:.4f} ms ({k5_dev_ms:.4f} ms queued "
          f"behind a sleep of the card: its time without the host's), plain "
          f"{k5_plain_ms:.4f} ms, torch.cummax of the marker positions "
          f"{k5_lib_ms:.4f} ms, bound {k5_bound[0]:.4f} ms by {k5_bound[1]}",
          flush=True)
    del pos

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
    npix = tiles_x * tiles_y * 256
    ev1 = walked(out1[raster_rows(C)["last"]])
    k1t_bound = blend_bound(packed, int(bounds[-1]), 0, (C + 11) * npix, ev1,
                            OPS_SURFEL_TERMS)
    print(f"[kernels] raster_blend_fwd (train) {k1t_ms:.4f} ms, plain "
          f"{k1t_plain_ms:.2f} ms, bound {k1t_bound[0]:.4f} ms by "
          f"{k1t_bound[1]} ({ev1:.4g} slot-pixel pairs walked)", flush=True)
    raster_counts(k1, "surfel", "K1 train")
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
    k2_bound = blend_bound(
        packed, int(bounds[-1]), 2 * (C + 11) * npix, 0, ev1,
        OPS_SURFEL_TERMS + 2 * len(k2_cols), extra_bytes=packed.numel() * 4)
    print(f"[kernels] raster_blend_bwd {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.2f} ms, bound {k2_bound[0]:.4f} ms by "
          f"{k2_bound[1]}", flush=True)
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
    npix = tiles_x * tiles_y * 256
    ev3 = walked(out3[r["last"]])
    k3t_bound = blend_bound(packed, int(bounds[-1]), 0, 13 * npix, ev3,
                            OPS_RAY_TERMS, extra_bytes=rays.numel() * 4)
    print(f"[kernels] trace_blend_fwd (train) {k3t_ms:.4f} ms, plain "
          f"{k3t_plain_ms:.2f} ms, bound {k3t_bound[0]:.4f} ms by "
          f"{k3t_bound[1]} ({ev3:.4g} slot-ray pairs walked)", flush=True)
    chunk_spread("trace_blend_bwd", bounds, out3[r["last"]], tiles_x,
                 tiles_y)
    g3 = torch.randn(out3.shape, generator=gen, device="cuda")
    k4_args = (packed, gauss_idx, rays, bounds, out3, g3, tiles_x, tiles_y)
    got, got_rays = kernels.trace_blend_bwd(*k4_args)
    want, want_rays = trace_blend_bwd_torch(*k4_args)
    k4_cols = sum(bwd_slot_columns(0), [])
    k4_err, k4_rel = compare_columns(
        "trace_blend_bwd", got, want, k4_cols, GRAD_RTOL)
    k4_rel = max(k4_rel, compare_columns_by_size(
        "trace_blend_bwd", got, want, k4_cols, GRAD_RTOL))
    per_row = lambda x: x[:, :6].transpose(0, 1).reshape(6, -1).T  # noqa: E731
    k4r_err, k4r_rel = compare_columns(
        "trace_blend_bwd (rays)", per_row(got_rays), per_row(want_rays),
        list(range(6)), GRAD_RTOL)
    k4_ms = cuda_ms(lambda: kernels.trace_blend_bwd(*k4_args), 20)
    k4_plain_ms = cuda_ms(lambda: trace_blend_bwd_torch(*k4_args), 3)
    k4_bound = blend_bound(
        packed, int(bounds[-1]), 2 * 13 * npix, 0, ev3,
        OPS_RAY_TERMS + 2 * (17 + 6),
        extra_bytes=(packed.numel() + 2 * rays.numel()) * 4)
    print(f"[kernels] trace_blend_bwd {k4_ms:.4f} ms, plain "
          f"{k4_plain_ms:.2f} ms, bound {k4_bound[0]:.4f} ms by "
          f"{k4_bound[1]}", flush=True)
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
    npix = tiles_x * tiles_y * 256
    ev1g = walked(out1[raster_rows(C)["last"]])
    k1g_bound = blend_bound(packed, int(bounds[-1]), 0, (C + 11) * npix, ev1g,
                            OPS_GAUSS3D_TERMS,
                            extra_bytes=int(bounds[-1]) * 4)  # per-pair wet
    print(f"[kernels] raster_blend_fwd (gauss3d) {k1g_ms:.4f} ms, plain "
          f"{k1g_plain_ms:.2f} ms, bound {k1g_bound[0]:.4f} ms by "
          f"{k1g_bound[1]} ({ev1g:.4g} slot-pixel pairs walked)", flush=True)
    raster_counts(k1g, "gauss3d", "K1 gauss3d")
    g1 = torch.randn(out1.shape, generator=gen, device="cuda")
    k2g_args = (packed, gauss_idx, bounds, out1, g1, C, tiles_x, tiles_y, 0,
                "gauss3d")
    got = kernels.raster_blend_bwd(*k2g_args)
    want = blend_tiles_bwd_torch(*k2g_args)
    # the reference reaches ~1e32 on saturated tiles (the backward rebuilds
    # T through pairs the forward skipped, see PERF.md), so the per-column
    # bound alone would let ordinary rows through: hold each size apart
    g3d_cols = gauss3d_slot_columns(C) + [31]
    k2g_err, k2g_rel = compare_columns(
        "raster_blend_bwd (gauss3d)", got, want, g3d_cols, GRAD_RTOL)
    k2g_rel = max(k2g_rel, compare_columns_by_size(
        "raster_blend_bwd (gauss3d)", got, want, g3d_cols, GRAD_RTOL))
    unused = [4, 5, 6, 7, 8, 12, 13, 14]  # tmat and normal columns
    if got[:, unused].any() or want[:, unused].any():
        raise AssertionError("gauss3d K2 wrote a tmat or normal column")
    k2g_ms = cuda_ms(lambda: kernels.raster_blend_bwd(*k2g_args), 20)
    k2g_plain_ms = cuda_ms(lambda: blend_tiles_bwd_torch(*k2g_args), 3)
    k2g_bound = blend_bound(
        packed, int(bounds[-1]), 2 * (C + 11) * npix, 0, ev1g,
        OPS_GAUSS3D_TERMS + 2 * len(g3d_cols),
        extra_bytes=packed.numel() * 4)
    print(f"[kernels] raster_blend_bwd (gauss3d) {k2g_ms:.4f} ms, plain "
          f"{k2g_plain_ms:.2f} ms, bound {k2g_bound[0]:.4f} ms by "
          f"{k2g_bound[1]}", flush=True)
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

    del gstate, gtarget

    # ---- 12. K6, P1, P2 against their plain versions, the probes' sizes ----
    from envgs_tpu_torch.ops.gather import (
        gather_rows_torch,
        gather_rows_win8_torch,
    )
    from envgs_tpu_torch.ops.segsum import segmented_inclusive_sum_torch
    from envgs_tpu_torch.probes import dmagather

    rows, seg = seg_inputs("cuda")
    got = kernels.segscan(rows, seg)
    torch.cuda.synchronize()
    want = segmented_inclusive_sum_torch(rows, seg)
    k6_err = float((got - want).abs().max())
    k6_ok = bool(torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL))
    starts = torch.nonzero(seg)[:, 0]
    print(f"[kernels] segscan over {tuple(rows.shape)} f32, "
          f"{starts.numel()} segment starts, longest segment "
          f"{int((starts[1:] - starts[:-1]).max())} rows, none at row 0: "
          f"max_abs_err {k6_err:.3g} at largest |sum| "
          f"{float(want.abs().max()):.4g} (bound rtol {SEG_RTOL:g} / atol "
          f"{SEG_ATOL:g}: {'within' if k6_ok else 'OUTSIDE'})", flush=True)
    if not k6_ok:
        raise AssertionError("segscan disagrees with its plain version")
    k6_ms = cuda_ms(lambda: kernels.segscan(rows, seg), 20)
    k6_plain_ms = cuda_ms(lambda: segmented_inclusive_sum_torch(rows, seg), 3)
    k6_bytes = 2 * rows.numel() * 4 + seg.numel() * 4
    k6_bound = bound_ms(k6_bytes, rows.numel())
    print(f"[kernels] segscan {k6_ms:.4f} ms, plain {k6_plain_ms:.2f} ms, "
          f"bound {k6_bound[0]:.4f} ms by {k6_bound[1]} "
          f"({k6_bytes / 2 ** 30:.3f} GiB read + written once)", flush=True)
    del got, want, starts

    tbf16, t32, idx = dmagather.probe_inputs("cuda")
    long_idx = idx.to(torch.int64)
    gathers = {}
    for label, table in (("bf16", tbf16), ("f32", t32)):
        ref = table[long_idx]
        # each input byte once: the distinct rows idx names (it repeats
        # rows about four times over), the indices, the output
        moved = dmagather.least_bytes(table, idx)
        lib_ms = cuda_ms(lambda: table[long_idx], 20)
        for name, fn, plain in (
                ("gather_rows", kernels.gather_rows, gather_rows_torch),
                ("gather_rows_win8", kernels.gather_rows_win8,
                 gather_rows_win8_torch)):
            out = fn(table, idx)
            torch.cuda.synchronize()
            want = plain(table, idx)
            n_bad = int((out.view(torch.int16) != want.view(torch.int16))
                        .sum())
            if n_bad or not torch.equal(want, ref):
                raise AssertionError(f"{name} {label}: {n_bad} values differ")
            ms = cuda_ms(lambda: fn(table, idx), 20)
            plain_ms = cuda_ms(lambda: plain(table, idx), 10)
            b = bound_ms(moved)
            gathers[(name, label)] = dict(ms=ms, plain_ms=plain_ms,
                                          library_ms=lib_ms, bound=b)
            print(f"[kernels] {name} {label}: {tuple(table.shape)} table, "
                  f"{idx.numel()} indices, bit-equal to its plain version "
                  f"and to table[idx]; {ms:.4f} ms ({ms / idx.numel() * 1e6:.3f}"
                  f" ns/row), plain {plain_ms:.4f} ms, table[idx] "
                  f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms by {b[1]} "
                  f"({moved / 2 ** 30:.3f} GiB: {int(idx.unique().numel())} "
                  "distinct rows and the indices read once, the output "
                  "written once)", flush=True)
        for n in RAGGED_N:
            ragged_gather("gather_rows_win8", kernels.gather_rows_win8,
                          table, idx, n)
        print(f"[kernels] gather_rows_win8 {label}: bit-equal to the clamped "
              f"table[idx] at n = {', '.join(map(str, RAGGED_N))} (repeated,"
              " first, last and out-of-range indices)", flush=True)
        del ref, out, want
    del tbf16, t32, idx, long_idx
    # the three kernels' own entry points, driven as a user would: no path
    # of the system reaches them
    from envgs_tpu_torch.ops.segsum import segmented_inclusive_sum

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    out = segmented_inclusive_sum(rows, seg)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("segmented_inclusive_sum: non-finite sums")
    del rows, seg, out
    dmagather.main(n=3)
    probe_launches = dict(kernels.LAUNCHES)
    if not all(probe_launches[k] for k in ("segscan", "gather_rows",
                                           "gather_rows_win8")):
        raise AssertionError(f"probe launches: {probe_launches}")
    print(f"[probe] entry points launched "
          f"{ {k: v for k, v in probe_launches.items() if v} }", flush=True)

    # ---- 13. small run: the compressed schedule, CUDA against CPU ----
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        want = small_run("cpu", os.path.join(tmp, "cpu"))
        t1 = time.perf_counter()
        got = small_run("cuda", os.path.join(tmp, "cuda"), start_from=want)
        worst = compare_small_run(got, want)
    print(f"[small-run] {len(want[1])} iterations, {len(want[0])} events "
          f"(all {len({e for _, e in want[0]})} kinds) equal on both devices; "
          f"cuda vs cpu per iteration: after maintenance masks and "
          f"statistics equal, arrays max|d|/max|ref| "
          f"{worst['maintenance']:.3g} (bound {DENSIFY_RTOL:g}); the step's "
          f"gradients {worst['grads']:.3g} (bound {STEP_RTOL:g}) but for at "
          f"most {worst['branch_rows']} rows of a pool at a branch of the "
          f"blend, the worst at {worst['branch']:.3g} (bounds {BRANCH_ROWS} "
          f"rows, {BRANCH_RTOL:g}), at most {worst['flips']} visibility "
          f"flips (bound {FLIP_MAX}); Adam on the card against the CPU's on "
          f"the card's gradients {worst['adam']:.3g} of each array's largest "
          f"change (bound {ADAM_RTOL:g}); cpu run "
          f"{t1 - t0:.1f} s, cuda run {time.perf_counter() - t1:.1f} s",
          flush=True)
    del want, got

    # ---- 14. the run at full width ----
    with tempfile.TemporaryDirectory() as tmp:
        run_launches, eval_launches, _ = full_run("cuda", tmp, kernels)

    paths = {"render": render_launches, "train": train_launches,
             "gaussiant": gaussiant_launches, "run": run_launches,
             "run_eval": eval_launches, "probe": probe_launches}

    def entry(name, src, replaces, err, ms, plain_ms, bound, library_ms=None,
              **extra):
        """A kernel's line: `launches` sums the paths driven above, each
        with the counts set to 0 before it and read after it."""
        by_path = {p: n[name] for p, n in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"envgs_tpu_torch/kernels/csrc/{src}",
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, "launches_by_path": by_path,
                **extra}

    def gather_entry(name, replaces):
        g = gathers[(name, "bf16")]
        f = gathers[(name, "f32")]
        return entry(name, "gather_rows.cu", replaces, 0.0, g["ms"],
                     g["plain_ms"], g["bound"], g["library_ms"],
                     f32_ms=f["ms"], f32_plain_ms=f["plain_ms"],
                     f32_bound_ms=f["bound"][0],
                     f32_library_ms=f["library_ms"])

    print(json.dumps({"kernels": [
        entry("raster_blend_fwd", "raster_blend_fwd.cu",
              "envgs_tpu/ops/raster_pallas.py:241",
              max(k1_err, k1t_err, k1_med_err), k1t_ms, k1t_plain_ms,
              k1t_bound, render_ms=k1_ms, render_plain_ms=k1_plain_ms,
              render_bound_ms=k1_bound[0], render_median_ms=k1_med_ms,
              resources={cfg: k1_resources[cfg] for cfg in ("render",
                                                           "train")}),
        entry("raster_blend_bwd", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2_err, k2_ms,
              k2_plain_ms, k2_bound, max_rel_err=k2_rel,
              resources=k2_resources["surfel"]),
        entry("trace_blend_fwd", "trace_blend_fwd.cu",
              "envgs_tpu/ops/tracer.py:645", max(k3_err, k3t_err), k3t_ms,
              k3t_plain_ms, k3t_bound, render_ms=k3_ms,
              render_plain_ms=k3_plain_ms, render_bound_ms=k3_bound[0],
              resources=k3_resources),
        entry("trace_blend_bwd", "trace_blend_bwd.cu",
              "envgs_tpu/ops/tracer.py:799", max(k4_err, k4r_err), k4_ms,
              k4_plain_ms, k4_bound, max_rel_err=max(k4_rel, k4r_rel),
              resources=k4_resources),
        entry("fill_forward", "fill_forward.cu",
              "envgs_tpu/ops/fill_forward.py:55", k5_err, k5_ms,
              k5_plain_ms, k5_bound, k5_lib_ms, queued_ms=k5_dev_ms,
              resources=k5_resources),
        entry("raster_blend_fwd_gauss3d", "raster_blend_fwd.cu",
              "envgs_tpu/ops/raster_pallas.py:241", k1g_err, k1g_ms,
              k1g_plain_ms, k1g_bound, mode="gauss3d",
              resources=k1_resources["gauss3d"]),
        entry("raster_blend_bwd_gauss3d", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2g_err, k2g_ms,
              k2g_plain_ms, k2g_bound, max_rel_err=k2g_rel, mode="gauss3d",
              resources=k2_resources["gauss3d"]),
        entry("segscan", "segscan.cu", "envgs_tpu/ops/segsum.py:30", k6_err,
              k6_ms, k6_plain_ms, k6_bound),
        gather_entry("gather_rows", "scripts/tpu_micro_dmagather.py:49"),
        gather_entry("gather_rows_win8",
                     "scripts/tpu_micro_dmagather.py:112"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

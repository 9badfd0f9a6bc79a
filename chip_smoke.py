"""Smoke test of the PyTorch + CUDA port (envgs_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: refuses to run without a CUDA card; prints the card's name and
     power limit as nvidia-smi reports them, torch and CUDA versions;
  2. build: compiles the CUDA kernels from the sources in this checkout;
     registers, shared bytes, spill bytes and resident blocks per SM of K1
     (each compiled configuration: the surfel mode's 12 switch sets, gauss3d
     with the wet), K2 (both modes), K3 (render,
     training, geometry with A = 2, the forward wet with A = 0 and 2), K4,
     K5 and K6 as compiled;
  3. kernels: K1 (raster blend) in each configuration of the render
     layout (`needs` all off, the median depth alone, the distortion alone,
     both) and K3 (trace blend) against their plain PyTorch versions on the
     bench scene's own inputs, max abs error per output against a stated
     bound (0 for the configurations held there since PR 7), each K1
     configuration's written planes equal to the all-on one's to the bit
     and its stripped planes as JAX leaves them, median ms of each over
     repeated runs, plain ms, bound; (3b) rasterize through every `needs`
     triple with and without the wet hook, under no_grad and (aligned)
     under autograd, on the bench scene's base pass: K1 once a call in the
     configuration JAX's switches pick, K2 once a backward;
     what K1's inputs ask (the blend probe's counts: windows walked,
     (pair, warp) combinations a pixel can take, within the footprint,
     evaluated, contributing);
  4. small render: the whole render path on a small scene, CUDA (kernels)
     against CPU (the plain versions the parity tests hold to the JAX
     package), also with depth_ratio = 1 (the median depth: K1's
     median-only configuration, never the training one);
  5. the render slice: the bench scene (1584x1040, 300K base + 32K env
     surfels) rendered through forward_envgs for 3 camera poses — no
     truncation, finite non-degenerate rgb, each kernel launched exactly
     once per render — then one render with depth_ratio = 1 (K1's
     median-only configuration and K3 once each), render fps and per-stage
     device ms;
  6. training kernels: K5, K1 in each configuration of the aligned layout
     (as phase 3), K3 in training mode, K2 (also after a forward without
     the median) and K4 against their plain versions on the train bench
     scene's own inputs (random cotangents for the backward kernels),
     errors against stated bounds (K2 and K4 also within each decade of row
     size), median ms of each
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
 9b. the 3DGS projection's kernels at the gs3d pool's 2^22 slots
     (anisotropic Gaussians) in the four filter settings against the
     plain version: ms each way, the outputs within the card test's
     tolerances, each leaf's gradient (quaternions and opacities too)
     within 1e-5 in relative norm; the plain chain's ms, the byte bounds;
 9c. the env cull's kernels: tests/test_torch_env_cull.py's card tests
     once more, then the kernels and the plain version at envgs-train's
     shapes and at the render default, integer-equal, ms, the (tile,
     chunk) pairs met, the bound, peak memory;
 10. small 3DGS run: render_gaussiant, one make_gaussiant_train_step and
     one densify_and_prune (the same split draws) on a small scene, CUDA
     against CPU;
 11. the 3DGS slice: the 3DGS bench scene (1558x1038, 500K Gaussians in a
     pool of 2^20) — the render's spans (render, render.project,
     render.bin: device ms under the profiler) and the binning's counters;
     renders that launch K5 and gauss3d K1 once each and nothing else,
     render fps; 1 + 10 train steps, each launching K5 and
     gauss3d K1 and K2 once, train steps/s; gaussiant_maintenance at
     it=600 (densify) and it=3000 (SH one-up, densify, opacity reset) on
     the statistics those steps gathered, active counts and ms; 3 more
     steps with finite loss and params; peak device memory;
 12. K6 (segmented scan, one pass) on (2^21, 128) f32 with about 500 000
     random segment starts and one segment of 5000 rows (two calls
     bit-equal), and P1 / P2 (row gathers)
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
     and K3); steps/s with maintenance, ms per event, render ms, memory;
     the state entering the base opacity reset after the normal
     propagation (every opacity 0.9) copied to the host, out of the timed
     run, and saved as a second checkpoint for phase 18's mesh;
 15. a camera path: Runner.render_path(8, "orbit") through phase 14's
     trained scene from a fresh runner resumed from its checkpoint (views
     on a ring about the scene's centre, caps no frame can overflow): 8
     RENDER PNGs, each frame finite and not flat, nothing truncated or
     dropped, K1 and K3 once per frame
     and nothing else, ms per frame; then `cli.main(["smoke", ...])` (30
     iterations) and `cli.main(["render", "-c", <its config>,
     "--path-kind", "spiral", "--path-frames", "4"])` from its checkpoint
     in a temporary directory: 4 frames, K1 and K3 at least once a frame
     (the synthetic scene renders its own views first) and nothing else.
 16. a capture on disk at full width: 24 views of the train bench scene
     on a ring, written as 3116x2076 JPEGs, normals, a COLMAP model and
     the env ply (write_capture); `cli.main(["train", "-c", <a config
     stacking envgs_sedan.yaml on it>])` at ratio 0.5 (1558x1038), the
     config's pools of 2,000,000 / 700,000, 60 iterations with the
     reflection gate at 20, then its evaluation of the 3 held-out views and
     `render --path-frames 4` from the checkpoint: K1, K2, K5 once a step
     and K3 / K4 from the gate, finite loss and params, the cap growth
     printed if it fired, rgb load ms and the decoder that ran, iteration
     ms either side of the gate, eval ms per view, peak memory; the ratio
     moderator (40 iterations: one step built per bucket) and the
     alternating one with 512x512 patches (20); `train -c` a config
     stacking gaussiant_synthetic.yaml on the capture (30 iterations: K5
     and gauss3d K1 / K2 once a step, point_cloud.ply, PSNR / SSIM).
 17. the train bench scene with the base pass traced along the camera rays
     (use_base_tracing, pair cap 2^24) and with two bounces
     (max_trace_depth = 1, env cap 2^23): K3's geometry configuration
     (A = 2), its training one with A = 2 and K4 with A = 2 on the traced
     base's inputs, K3 with the forward wet (A = 0 and 2, the per-slot and
     per-splat wet) on the reflected rays' against their plain versions,
     times and bounds; the traced base's dropped slots read from
     trace_rays on its inputs (forward_envgs reports none); 3 renders and
     1 + 10 steps of each configuration with their exact launches (traced
     base: K3 geometry + K3 render a render, K3 twice + K4 twice a step;
     two bounces: K1 + K3 wet twice a render, K1, K2, K5, K3 wet twice and
     K4 twice a step), render and step stage ms, fps, steps/s, peak memory;
     the rays the second bounce traces and a fault probe of its backward
     (the T rebuild, ROADMAP Queue 3: the two-bounce steps restart from the
     scene's state and report the non-finite gradients instead of refusing
     them); the committed golden scenes (tests/golden) rendered with the
     kernels: PSNR against golden.png at its threshold, equal to the plain
     blends on the card's own inputs, and against the CPU render within
     SMALL_ATOL but for at most BRANCH_ROWS pixels within BRANCH_RTOL (a
     blend's discrete choice at the alpha floor on last-bit differences).
 18. the aux supervisors, LPIPS and the mesh: (a) the train bench scene's
     step with the shipped perceptual loss (0.01 past iteration 21000) on a
     random VGG16 written as the npz ops/lpips.py reads, and the aux depth
     loss (weight 1) on the scene's own rendered depth with 5% seeded
     noise, once with smoothl1 and once with ssimse: 1 + 5 steps each, K1-K5
     once a step, finite loss and params, aux_dpt_loss and perc_loss in the
     stats, nothing dropped; steps/s, stage ms, LPIPS forward and forward +
     backward ms, peak memory; (b) phase 7's small step with the perceptual
     loss and the aux supervisors, CUDA against CPU at phase 7's bounds;
     (c) LPIPS of a 1558x1038 pair on the card against the CPU within
     LPIPS_RTOL; (d) Runner.extract_mesh(res=256) at the mesh mode's own
     acc_thresh of 0.5 from a runner resumed from phase 14's checkpoint
     taken before its last opacity reset (the run ends three iterations
     after one, where no pixel reaches 0.5): K1 and K3 once per fused view
     and nothing else, a non-empty mesh, ms of the renders, the fusion,
     the extraction and the ply, the TSDF and weights against the CPU's
     from the same depths within TSDF_RTOL of their range; then
     `cli.main(["mesh", "-c", <phase 15's smoke config>, "--mesh-res",
     "128"])` from phase 15's smoke checkpoint; (e) make_scene's default
     capture (12 views of 128x128 through the reference renderers): ms per
     view, no kernel.
 19. the other gauss3d families: (a) small Spacetime Gaussian (STGS) runs
     with the static SH and with sh_degree_t = 1: render_stgs, one step
     (every gradient, t / scaling_t / motion among them), stgs_maintenance
     on the same split draws and reset_t, CUDA against CPU at phase 10's
     bounds; (b) the 3DGS bench scene's 500K Gaussians as STGS (times in
     [0, 1], temporal scale 0.1414, motions N(0, 0.05^2)), its renders at 4
     times as the targets, trained from its motion zeroed: renders that
     launch K5 and gauss3d K1 once and nothing else, render fps; 1 + 10
     steps launching K5 and gauss3d K1 / K2 once each, the motion
     gradients live, steps/s, forward / backward / optimizer device ms;
     stgs_maintenance and reset_t, 3 more steps; peak memory; (c)
     PointPlanes (the JAX defaults) on 2^18 points, 8 frames at 1558x1038
     of a teacher's renders, the pair cap printed, 1 + 10 steps, steps/s,
     peak memory, a small step CUDA against CPU; (d) `cli.main(["train",
     "-c", ...])` of stgs_synthetic.yaml and point_planes_synthetic.yaml
     (launches per step, metrics.json, point_cloud.ply, latest.npz), a run
     of 60 iterations killed at iteration 55 and resumed from its
     checkpoint of iteration 50, train_stgs on phase 16's capture (ratio 0.5, 30 iterations),
     train_point_planes on an 8-view 8-frame video capture written here
     (20 iterations).
 20. the kernel-free families and serving: (a) a small NeRF, NeuS and
     ENeRF step (bench.family_small_step) CUDA against CPU at phase 10's
     bounds; NeRF (NerfConfig(): 256 x 8, 64 + 64 samples, 1024 rays) and
     NeuS (NeusConfig(): 128 x 4, 48 samples, 512 rays) through
     `cli.main(["train", "-c", <nerf|neus>_synthetic.yaml, ...])` on phase
     16's capture at ratio 0.25 (779x519; 22 views train, 2 held out), 30
     steps each, and ENeRF (ENeRFConfig(): 64 + 8 planes, 2 sources)
     through train_enerf on phase 19d's 1558x1038 video capture
     (ImageBasedDataset, 20 steps): steps/s, forward / backward /
     optimizer device ms, peak memory, finite losses and parameters, the
     held-out PSNR, no kernel of the repo launched; (b) a RenderServer in
     watch mode on a runner resumed from phase 14's checkpoint, on a
     loopback websocket: the training view, an 8-step yaw sweep, each of
     the 8 render types, then a later checkpoint and one more frame; each
     frame K1 and K3 once and nothing else, its JPEG the render's in this
     process, nothing truncated; frames/s, the server's render_ms /
     encode_ms medians, the new iteration and state after the reload.
 21. multi-process training (parallel/) on the card: (a) the train scene
     at 1558x1024 rendered in training mode in 2 and 4 bands
     (forward_envgs(band=...)): each band's base-pass maps equal to the
     full render's rows (max abs 0), K1 / K3 / K5 once a band; K1 train
     and K2 on a band's layout at row offset 512 against their plain
     versions (K1's planes also equal to the full image's rows), times,
     bounds; (b) the band-parallel step on 2 and 4 ranks spawned on the
     card in a gloo group (NCCL refuses two ranks of one card): the loss
     and every summed gradient against the single-card step, the CPU's
     Adam on them, the new state bit-equal on every rank, K1 / K2 / K3 /
     K4 / K5 once a rank, steps/s of the 2-rank step, bytes all-reduced,
     peak memory a rank; (c) on 2 ranks the splat-slab base pass against
     the same slabs composed in one process and against the single render,
     the env pass's deviation, phase 7's small step through 2 slabs card
     against CPU; on 4 ranks one 2 x 2 ('band', 'splat') step; (d)
     Runner.test of phase 14's checkpoint on 2 ranks against one process:
     the merged means, the split views, rank 0's files alone.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
import contextlib
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
# (phase 17 allows the golden renders, card against CPU, as many pixels
# past SMALL_ATOL, each within BRANCH_RTOL, for the same cause: a pair at
# the blend's alpha floor taken on one device and not on the other; the
# kernels themselves equal the plain blends on the card's own inputs)
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
# K1's LAUNCHES keys of the paths' configurations (kernels.
# raster_blend_fwd_key): a render (unaligned, `needs` all off), a render
# with the median depth (depth_ratio > 0), a train step (aligned,
# distortion and median, the wet through the hook)
K1_RENDER, K1_MED = "raster_blend_fwd", "raster_blend_fwd_med"
K1_TRAIN = "raster_blend_fwd_aligned_dist_med"
TRAIN_NEEDS = (True, True, False)
RENDER_KERNELS = (K1_RENDER, "env_cull", "trace_blend_fwd")
TRAIN_KERNELS = (K1_TRAIN, "raster_blend_bwd", "env_cull", "trace_blend_fwd",
                 "trace_blend_bwd", "fill_forward")
GAUSSIANT_RENDER_KERNELS = ("fill_forward", "raster_blend_fwd_gauss3d",
                            "project3d_fwd")
GAUSSIANT_TRAIN_KERNELS = GAUSSIANT_RENDER_KERNELS + (
    "raster_blend_bwd_gauss3d", "project3d_bwd")
# K1's configurations held at max abs 0 against their plain versions (the
# others at KERNEL_ATOL): the render, the train step with and without the
# forward wet, 3DGS
K1_EXACT = (K1_RENDER, K1_TRAIN, "raster_blend_fwd_aligned_dist_med_wet",
            "raster_blend_fwd_gauss3d")
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
# each thread's 16 rows in order, the 8 row groups of a 128-row tile in
# order, then the carry (a left fold of the tiles' sums), in float32; the
# plain version rounds a float64 running sum once
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4
# row counts that fill no whole stage, run or block of P2's ring
RAGGED_N = (1, 15, 17, 2 ** 21 - 3)
# phase 18: timed aux steps after one warm-up, per depth-loss kind; LPIPS
# on the card against the CPU (relative: the same graph, convolutions in
# another order); the mesh's TSDF grid (the mesh mode's default) and its
# TSDF and weights card against CPU from the same depths, of their range
# (fusion.py projects with separate products and sums: no device rounds a
# matmul its own way into another nearest pixel)
AUX_STEPS = 5
LPIPS_RTOL = 1e-4
MESH_RES = 256
TSDF_RTOL = 1e-5


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


def k1_compiled(kernels) -> dict:
    """{LAUNCHES key: (needs, aligned, mode)} of K1's compiled
    configurations: the surfel mode's legal switch sets, gauss3d all on."""
    out = {kernels.raster_blend_fwd_key(c[:3], c[3]): (c[:3], c[3], "surfel")
           for c in kernels.K1_CONFIGS}
    out["raster_blend_fwd_gauss3d"] = ((True, True, True), True, "gauss3d")
    return out


def k1_configurations(kernels, k1, aligned, label):
    """K1 in each compiled surfel configuration of one layout on a bench
    scene's inputs (phase 3: the render scene's unaligned layout; phase 6:
    the train scene's aligned one): against its plain version (K1_EXACT at
    max abs 0, the others at KERNEL_ATOL), every plane it writes and its
    wet equal to the layout's all-on configuration's to the bit, the planes
    it strips zero (`last` -1); median ms of 20 runs, the plain version's of
    3, the bound (the all-on run's walked pairs). -> {key: dict(needs, err,
    ms, plain_ms, bound)}, the all-on planes."""
    from envgs_tpu_torch.ops.raster_blend import blend_tiles_torch, rows

    packed, _, bounds, C, tiles_x, tiles_y = k1
    r = rows(C)
    full = kernels.raster_blend_fwd(*k1, 0, (True, True, aligned),
                                    aligned=aligned)
    full, full_wet = full if aligned else (full, None)
    evals = walked(full[r["last"]])
    npix = tiles_x * tiles_y * 256
    render_groups = {"color": slice(0, C), "depth": C, "alpha": C + 1,
                     "normal": slice(C + 2, C + 5), "T": C + 5}
    res = {}
    for *needs, a in kernels.K1_CONFIGS:
        if a != aligned:
            continue
        key = kernels.raster_blend_fwd_key(needs, aligned)
        run = lambda: kernels.raster_blend_fwd(  # noqa: E731
            *k1, 0, needs, aligned=aligned)
        plain = lambda: blend_tiles_torch(  # noqa: E731
            *k1, 0, needs, aligned=aligned)
        got, want = run(), plain()
        bound = 0.0 if key in K1_EXACT else KERNEL_ATOL
        planes = needs[0] or needs[1]
        if needs[2]:
            (got, wet), (want, want_wet) = got, want
        err = compare(f"{key} ({label})", got, want,
                      train_planes(C) if planes else render_groups, bound)
        if needs[2]:
            err = max(err, compare(f"{key} ({label}) per-pair", wet,
                                   want_wet, {"wet": slice(None)}, bound))
            if not torch.equal(wet, full_wet):
                raise AssertionError(f"{key}: its wet differs from the "
                                     "all-on configuration's")
        if planes:
            kept = [k for k in range(C + 11)
                    if (needs[0] or k not in (r["dist"], r["d1"], r["d2"],
                                              r["last"]))
                    and (needs[1] or k != r["med"])]
            same = torch.equal(got[kept], full[kept])
            stripped = ((needs[0] or (not got[[r["dist"], r["d1"],
                                                r["d2"]]].any()
                                      and bool((got[r["last"]] == -1).all())))
                        and (needs[1] or not got[r["med"]].any()))
        else:
            same = (torch.equal(got[:C + 5], full[:C + 5])
                    and torch.equal(got[C + 5], full[r["trans"]]))
            stripped = True
        if not (same and stripped):
            raise AssertionError(f"{key}: the planes it writes differ from "
                                 f"the all-on configuration's ({same}) or "
                                 f"a stripped plane is not JAX's ({stripped})")
        ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 3)
        bnd = blend_bound(packed, int(bounds[-1]), 0,
                          (C + 11 if planes else C + 6) * npix, evals,
                          OPS_SURFEL_TERMS)
        print(f"[kernels] {key} ({label}) {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({evals:.4g} slot-pixel pairs walked); written planes equal "
              "to the all-on configuration's, stripped ones as JAX leaves "
              "them", flush=True)
        res[key] = dict(needs=list(needs), aligned=aligned, err=err, ms=ms,
                        plain_ms=plain_ms, bound=bnd)
    return res, full


def needs_matrix(kernels, base, cam, cfg) -> dict:
    """Phase 3b, a path: rasterize (the entry point) on the render bench
    scene's base pass in every `needs` triple, with and without the wet
    hook, under no_grad and, where the layout is aligned, under autograd
    with a backward. Each call launches K1 once in the configuration JAX's
    switches pick (need_dist forced on under autograd), K5 once on the
    aligned layout (its binning) and K2 once after a backward, nothing
    else; what a call writes is equal to the bit across
    the calls of one layout; what it strips is zero. -> the launches."""
    import itertools

    from envgs_tpu_torch.models.envgs import _pool_colors
    from envgs_tpu_torch.ops.common import prepare_splats
    from envgs_tpu_torch.ops.raster import rasterize

    colors = torch.cat([_pool_colors(base, cam.center), base.get_specular,
                        base.get_roughness], dim=-1)
    prep = prepare_splats(base.params.xyz, base.params.rotation,
                          base.get_scaling, base.get_opacity[:, 0], colors,
                          cam, active=base.stats.active)
    P, dev = prep.depth.shape[0], prep.depth.device
    bg = torch.zeros(3, device=dev)
    seen, calls = {}, 0
    _zero_counts(kernels)
    for needs in itertools.product((False, True), repeat=3):
        for hook, grad in itertools.product((False, True), repeat=2):
            aligned = needs[2] or hook
            if grad and not aligned:  # not differentiable (JAX refuses)
                continue
            fwd = (needs[0], needs[1], needs[2] and not hook)
            key = kernels.raster_blend_fwd_key(
                (True, needs[1], fwd[2]) if grad else fwd, aligned)
            m2z = torch.zeros((P, 2), device=dev, requires_grad=grad)
            wz = (torch.zeros(P, device=dev, requires_grad=grad)
                  if hook else None)
            before = dict(kernels.LAUNCHES)
            with contextlib.nullcontext() if grad else torch.no_grad():
                out = rasterize(prep, cam, bg, pair_cap=cfg.pair_cap,
                                means2d_zero=m2z, needs=needs, wet_zero=wz)
                if grad:
                    (out.rgb.sum() + out.distortion.sum()).backward()
            torch.cuda.synchronize()
            calls += 1
            rose = {k: v for k, v in _launch_delta(kernels, before).items()
                    if v}
            want = {key: 1, **({"fill_forward": 1} if aligned else {}),
                    **({"raster_blend_bwd": 1} if grad else {})}
            what = f"rasterize needs={needs} hook={hook} grad={grad}"
            if rose != want:
                raise AssertionError(f"{what}: launches {rose}, not {want}")
            written = {"rgb", "alpha", "depth_expected", "normal", "trans"}
            if needs[0] or grad:
                written |= {"distortion", "d1", "d2"}
            if needs[1]:
                written.add("depth_median")
            if fwd[2]:
                written.add("wet")
            for k in ("rgb", "alpha", "depth_expected", "normal", "trans",
                      "distortion", "d1", "d2", "depth_median", "wet"):
                x = getattr(out, k).detach()
                if k not in written:
                    if x.any():
                        raise AssertionError(f"{what}: {k} not zero")
                    continue
                ref = seen.setdefault((aligned, k), x)
                # the per-splat wet sums pairs by atomics (index_add_), in
                # another order from call to call
                same = (torch.allclose(x, ref, rtol=1e-5, atol=0)
                        if k == "wet" else torch.equal(x, ref))
                if not (bool(torch.isfinite(x).all()) and same):
                    raise AssertionError(f"{what}: {k} differs from the "
                                         "other calls on its layout")
            if grad and not (bool(torch.isfinite(m2z.grad).all())
                             and bool(m2z.grad.any())
                             and (wz is None or bool(wz.grad.any()))):
                raise AssertionError(f"{what}: gradients {m2z.grad} {wz}")
    launches = dict(kernels.LAUNCHES)
    print(f"[needs] rasterize on the render bench scene's base pass "
          f"({cam.W}x{cam.H}, {P} surfels), {calls} calls: every `needs` "
          "triple with and without the wet hook under no_grad, the aligned "
          "ones also under autograd with a backward: K1 once a call in the "
          "configuration JAX's switches pick, K5 once an aligned call, K2 "
          "once a backward, the "
          "outputs written equal on each layout, those stripped zero; "
          "launches " + json.dumps({k: v for k, v in launches.items() if v}),
          flush=True)
    return launches


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


def small_train(device, vgg_path=None, make_step=None):
    """One train step of the small scene from one numpy-made mid-run state
    (random Adam moments at step 10, so updates are smooth in the
    gradients): (start state, new state, stats, gradients). With
    `vgg_path` (a VGG16 npz) the perceptual loss is on from iteration 0
    and the aux supervisors (depth on a seeded prior with holes, mask,
    entropy) are chained in (phase 18b). `make_step` replaces
    make_train_step (phase 21c: the splat-slab step of a mesh)."""
    import functools

    from envgs_tpu_torch.models.gaussians import GaussianParams
    from envgs_tpu_torch.ops.lpips import load_weights, lpips_pair
    from envgs_tpu_torch.train.aux_supervisors import AuxLossConfig
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
                             for p in params if p is not None)),
            GaussianParams(*(t(rng.random(p.shape) * 1e-5 + 1e-6)
                             for p in params if p is not None)),
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
    extra = {}
    if vgg_path is not None:
        loss_cfg = loss_cfg._replace(perc_loss_weight=0.01,
                                     perc_loss_start_iter=0)
        extra = dict(
            lpips_fn=functools.partial(lpips_pair,
                                       load_weights(vgg_path, device)),
            aux_cfg=AuxLossConfig(dpt_loss_weight=1.0, msk_loss_weight=0.1,
                                  ent_loss_weight=0.01))
        dpt = rng.random((cam.H, cam.W, 1)) * 3 + 2
        batch = batch._replace(dpt=t(np.where(
            rng.random(dpt.shape) < 0.2, 0.0, dpt)))
    step = (make_step or make_train_step)(
        cam, cfg._replace(render_mode=False), loss_cfg, LRConfig(),
        LRConfig(), has_norm=True, **extra)
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
            if w is not None:
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
            start.params) if w is not None]
        for m in ("mu", "nu"):
            pairs += [(f"{m} {name} {f}", g, w, p0) for f, g, w, p0 in zip(
                w_pool.params._fields, getattr(getattr(g_new, "opt_" + name), m),
                getattr(getattr(w_new, "opt_" + name), m),
                getattr(opt0, m)) if w is not None]
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
        GaussianParams(*(t(rng.normal(size=x.shape) * 1e-3) for x in p
                         if x is not None)),
        GaussianParams(*(t(rng.random(x.shape) * 1e-5 + 1e-6) for x in p
                         if x is not None)),
        torch.tensor(10, dtype=torch.int32, device=device))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    return G.GaussianTState(pool, opt), cam, cfg, t(rng.random((H, W, 3)))


# the 3DGS projection at the gs3d-mipnerf360 pool (benchmark/configs):
# 3.0M Gaussians in 2^22 slots (the free slots zero, as a padded pool's),
# 1558x1038, focal 0.9 W; each scale axis the configuration's 0.0049 times
# exp(U(-0.7, 0.7)), as in the card test (tests/test_torch_project3d.py),
# so that the rotation shapes the covariance
PROJECT3D_SLOTS, PROJECT3D_GAUSSIANS = 2 ** 22, 3_000_000
# (lowpass2d, compensate2d, with filter3d): classic 3DGS, mip-splatting, and
# each of mip's two filters alone
PROJECT3D_SETTINGS = {"classic": (0.3, False, False),
                      "mip": (0.1, True, True),
                      "filter3d": (0.3, False, True),
                      "compensate2d": (0.1, True, False)}
# the card test's tolerances: the float outputs within ATOL + RTOL |plain|;
# each gradient's distance within GRAD_RTOL of the plain one's 2-norm
PROJECT3D_RTOL, PROJECT3D_ATOL, PROJECT3D_GRAD_RTOL = 1e-5, 1e-6, 1e-5
# bytes a slot: the forward reads mean, quaternion, scales, mask and writes
# conic, center, depth, radius, validity, extents, row-cull parameters; the
# backward reads the inputs and the conic, center and depth cotangents and
# writes the three gradients
PROJECT3D_FWD_BYTES = 12 + 16 + 12 + 1 + 12 + 8 + 4 + 4 + 1 + 8 + 24
PROJECT3D_BWD_BYTES = 12 + 16 + 12 + 12 + 8 + 4 + 12 + 16 + 12


def project3d_run(kernels) -> dict:
    """The 3DGS projection's kernels against the plain version at
    PROJECT3D_SLOTS slots in each of PROJECT3D_SETTINGS: the forward and
    backward kernels' ms (median of 20); the layer's forward against the
    plain version's on the same inputs (every float output, the opacity
    too, within PROJECT3D_RTOL / PROJECT3D_ATOL; valid equal; radius and
    ext off by at most 1 px on at most 0.01% of slots) and its VJP of
    seeded random cotangents of conic, center, depth and (where a filter
    changes it) opacity against autograd through the plain version: the
    means', quaternions', scales' and (so) opacities' gradients each within
    PROJECT3D_GRAD_RTOL in relative 2-norm, over the pool and over its
    Gaussians. Classic also: the plain version's ms with and without its
    backward, the layer's call with and without autograd's backward, the
    byte bounds. Prints one line a setting; raises on a disagreement; ->
    the fields of the kernels line."""
    from envgs_tpu_torch.ops import project3d as p3
    from envgs_tpu_torch.utils.camera import make_camera

    P, n, dev = PROJECT3D_SLOTS, PROJECT3D_GAUSSIANS, "cuda"
    g = torch.Generator(device=dev).manual_seed(19)
    means = torch.zeros(P, 3, device=dev)
    means[:n, :2] = torch.randn((n, 2), generator=g, device=dev) * 1.5
    means[:n, 2] = 2.0 + 5.0 * torch.rand(n, generator=g, device=dev)
    quats = torch.zeros(P, 4, device=dev)
    quats[:n] = torch.randn((n, 4), generator=g, device=dev)
    scales = torch.ones(P, 3, device=dev)
    scales[:n] = 0.0049 * torch.exp(
        1.4 * torch.rand((n, 3), generator=g, device=dev) - 0.7)
    opac = torch.full((P,), 0.5, device=dev)
    opac[:n] = 0.05 + 0.9 * torch.rand(n, generator=g, device=dev)
    active = torch.arange(P, device=dev) < n
    H, W = 1038, 1558
    f = 0.9 * W
    cam = make_camera(H, W, [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                      np.eye(3), np.zeros(3), device=dev)
    buf = p3.camera_buffer(cam)
    filt = 1e-3 + 1e-2 * torch.rand(P, generator=g, device=dev)
    cots = [torch.randn(s, generator=g, device=dev)
            for s in ((P, 3), (P, 2), (P,), (P,))]
    leaf_names = ("means", "quats", "scales", "opacities")
    fields = ("conic", "center_pix", "depth", "opacity", "rowcull")

    def vjp(fn, kw, changed):
        """fn's outputs (detached) and the gradients of sum(cot * output)
        over conic, center, depth and, where changed, opacity."""
        leaves = [x.clone().requires_grad_(True)
                  for x in (means, quats, scales, opac)]
        out = fn(*leaves, None, cam, 1.0, active, **kw)
        outs = [out.conic, out.center_pix, out.depth, out.opacity]
        loss = sum((o * c).sum() for o, c in zip(outs[:3 + changed], cots))
        grads = torch.autograd.grad(loss, leaves[:3 + changed])
        return out._replace(**{k: getattr(out, k).detach()
                               for k in out._fields if k != "color"}), grads

    res, worst = {}, dict(err=0.0, over=0.0, grad_rel=0.0, grad_err=0.0)
    for setting, (lp, comp, has_f) in PROJECT3D_SETTINGS.items():
        flt, changed = (filt if has_f else None), has_f or comp
        args, conf = (means, quats, scales, opac), (W, H, 1.0, lp, comp)
        g_op = cots[3] if changed else None
        res[f"{setting}_fwd_ms"] = cuda_ms(lambda: kernels.project3d_fwd(
            *args, active, flt, buf, *conf), 20)
        res[f"{setting}_bwd_ms"] = cuda_ms(lambda: kernels.project3d_bwd(
            *args, flt, buf, *conf, *cots[:3], g_op), 20)
        kw = dict(lowpass2d=lp, compensate2d=comp, filter3d=flt)
        got, grads = vjp(p3.project3d, kw, changed)
        want, want_g = vjp(p3.project3d_torch, kw, changed)
        err, over = {}, {}
        for k in fields:
            a, b = getattr(got, k), getattr(want, k)
            d = torch.where(a == b, 0.0, (a - b).abs())  # equal infinities
            err[k] = float(d.max())
            over[k] = float((d / (PROJECT3D_ATOL
                                  + PROJECT3D_RTOL * b.abs())).max())
        valid_eq = bool(torch.equal(got.valid, want.valid))
        px = {k: (getattr(got, k) - getattr(want, k)).abs().reshape(P, -1)
              for k in ("radius", "ext")}
        off = {k: int((d > 0).any(1).sum()) for k, d in px.items()}
        px_max = max(float(d.max()) for d in px.values())
        grad_rel, grad_live, grad_err = {}, {}, {}
        for k, a, b in zip(leaf_names, grads, want_g):
            grad_rel[k] = float((a - b).norm() / b.norm())
            grad_live[k] = float((a[:n] - b[:n]).norm() / b[:n].norm())
            grad_err[k] = float((a - b).abs().max())
        print(f"[kernels] project3d {setting} at {P} slots ({n} Gaussians, "
              f"{int(want.valid.sum())} valid): forward "
              f"{res[f'{setting}_fwd_ms']:.4f} ms, backward "
              f"{res[f'{setting}_bwd_ms']:.4f} ms; max abs err "
              + json.dumps({k: float(f"{v:.3g}") for k, v in err.items()})
              + ", |err| / (atol + rtol |plain|) at most "
              f"{max(over.values()):.3g}, valid equal {valid_eq}, radius / "
              f"ext off on {off['radius']} / {off['ext']} slots (at most "
              f"{px_max:g} px); gradients' relative norm over the pool "
              + json.dumps({k: float(f"{v:.3g}") for k, v in
                            grad_rel.items()})
              + ", over the Gaussians "
              + json.dumps({k: float(f"{v:.3g}") for k, v in
                            grad_live.items()})
              + ", max abs err "
              + json.dumps({k: float(f"{v:.3g}") for k, v in
                            grad_err.items()}), flush=True)
        if (not valid_eq or max(over.values()) > 1.0 or px_max > 1.0
                or max(off.values()) > max(1, int(1e-4 * P))
                or not max(grad_rel.values()) <= PROJECT3D_GRAD_RTOL
                or not max(grad_live.values()) <= PROJECT3D_GRAD_RTOL):
            raise AssertionError(
                f"project3d ({setting}) disagrees with its plain version")
        worst = dict(err=max(worst["err"], *err.values()),
                     over=max(worst["over"], *over.values()),
                     grad_rel=max(worst["grad_rel"], *grad_rel.values(),
                                  *grad_live.values()),
                     grad_err=max(worst["grad_err"], *grad_err.values()))
        del got, want, grads, want_g

    kw = dict(lowpass2d=0.3, compensate2d=False, filter3d=None)
    with torch.no_grad():
        res["plain_ms"] = cuda_ms(lambda: p3.project3d_torch(
            means, quats, scales, opac, None, cam, 1.0, active, **kw), 5)
        res["layer_ms"] = cuda_ms(lambda: p3.project3d(
            means, quats, scales, opac, None, cam, 1.0, active, **kw), 20)
    res["plain_fwd_bwd_ms"] = cuda_ms(
        lambda: vjp(p3.project3d_torch, kw, False), 3)
    res["layer_fwd_bwd_ms"] = cuda_ms(lambda: vjp(p3.project3d, kw, False),
                                      10)
    fwd_bound = bound_ms(P * PROJECT3D_FWD_BYTES)
    bwd_bound = bound_ms(P * PROJECT3D_BWD_BYTES)
    print(f"[kernels] project3d classic: bound {fwd_bound[0]:.4f} ms by "
          f"{fwd_bound[1]} forward, {bwd_bound[0]:.4f} backward; the "
          f"layer's call {res['layer_ms']:.4f} ms, with autograd's backward "
          f"{res['layer_fwd_bwd_ms']:.4f} ms; plain {res['plain_ms']:.2f} "
          f"ms, with its backward {res['plain_fwd_bwd_ms']:.2f} ms",
          flush=True)
    return dict(worst, fwd_bound=fwd_bound, bwd_bound=bwd_bound, **res)


# the env cull (csrc/env_cull.cu): float32 operations per coarse (tile,
# chunk) test, per refined candidate's sphere test and per probe of a
# candidate the sphere test keeps, read off csrc/env_cull.cuh (a square root
# or a division counted as one; the keys and the sort left out, so the
# bound stays a bound); the bytes each chunk's rows and index take
CULL_COARSE_OPS, CULL_SPHERE_OPS, CULL_PROBE_OPS = 35, 26, 140
CULL_CHUNK_BYTES = 12 + 4 + 1 + (8 + 1) * 64 * 4


def env_cull_run(kernels) -> dict:
    """The env cull's kernels (ops/tracer.py::cull_and_sort on CUDA
    tensors): the card tests of tests/test_torch_env_cull.py once more (the
    kernels integer-equal to the plain version over probe, tile mask, slot
    budget, per-tile cap and key regime and at envgs-train's full size; no
    host synchronisation; a training step's launch), then the kernels and
    the plain version timed on the same inputs (median of 20 and of 2) at
    envgs-train's shapes (its scene, 2^19 a tile, 2^26 slots) and at the
    render default (the bench scene, 2048 a tile), equal there too; the
    (tile, chunk) pairs met against tiles x Kc, the bound (the chunk table
    read and the slots written once; the coarse tests, the met chunks'
    sphere tests and the kept candidates' probes), the peak memory of each.
    -> the fields of the kernels line."""
    from envgs_tpu_torch.ops import tracer
    from envgs_tpu_torch.ops.raster_blend import CHUNK

    root = os.path.dirname(os.path.abspath(__file__))
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "cuda", "-q", "-p",
         "no:cacheprovider", "tests/test_torch_env_cull.py"], cwd=root,
        capture_output=True, text=True)
    last = tests.stdout.strip().splitlines()[-1] if tests.stdout else ""
    print(f"[kernels] env_cull card tests: {last}", flush=True)
    if tests.returncode != 0:
        raise AssertionError(f"env_cull card tests failed:\n"
                             f"{tests.stdout[-4000:]}")
    sys.path.insert(0, os.path.join(root, "tests"))
    from test_torch_env_cull import bench_env_inputs, cell_env_inputs

    scene, tiles, total = bench_env_inputs("cuda")
    cases = {"cell": cell_env_inputs("cuda"),
             "render": (scene, tiles, 2048, total)}
    res = {}
    for label, (scene, tiles, cap, total) in cases.items():
        r3 = tracer.splat_radius3(scene)
        kw = dict(per_tile_cap=cap, total_pair_cap=total)
        T, P = tiles.n_tiles, scene.mean.shape[0]
        NC = -(-P // CHUNK)
        Kc = max(min(cap // CHUNK, NC), 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        got = tracer.cull_and_sort(tiles, scene, r3, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        ms = cuda_ms(lambda: tracer.cull_and_sort(tiles, scene, r3, **kw), 20)
        torch.cuda.reset_peak_memory_stats()
        want = tracer.cull_and_sort_torch(tiles, scene, r3, **kw)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated() - held
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        del want
        plain_ms = cuda_ms(lambda: tracer.cull_and_sort_torch(
            tiles, scene, r3, **kw), 2)
        idx = tracer.build_chunk_index(scene, r3)
        radial = tracer.coarse_radial(
            idx, tiles.apex, tiles.axis, tiles.tan_half, tiles.spread,
            torch.ones(T, dtype=torch.bool, device="cuda"))
        met = int((radial < float("inf")).sum())
        del radial
        kept = int((got[0] != P).sum())
        bound = bound_ms(NC * CULL_CHUNK_BYTES + got[0].numel() * 4
                         + (T + 1) * 4,
                         T * NC * CULL_COARSE_OPS
                         + min(met, T * Kc) * CHUNK * CULL_SPHERE_OPS
                         + kept * CULL_PROBE_OPS)
        print(f"[kernels] env_cull {label}: {T} tiles, {NC} chunks, P {P}, "
              f"Kc {Kc}: {met} (tile, chunk) pairs met against tiles x Kc "
              f"{T * Kc}, {int(got[3])} cut, {kept} slots kept of "
              f"{got[0].numel()}; kernels {ms:.4f} ms (peak "
              f"{peak / 2 ** 30:.2f} GiB), plain {plain_ms:.2f} ms (peak "
              f"{plain_peak / 2 ** 30:.2f} GiB), integer-equal {equal}; "
              f"bound {bound[0]:.4f} ms by {bound[1]}", flush=True)
        if not equal:
            raise AssertionError(f"env_cull {label} disagrees with the "
                                 "plain version")
        res[label] = dict(ms=ms, plain_ms=plain_ms, bound=bound, met=met,
                          tiles_x_kc=T * Kc, peak=peak, plain_peak=plain_peak)
        del got, idx
    return res


def render_spans(render, reps: int = 5):
    """({span: median device ms}, the last render's counters) of `reps`
    renders under the profiler, after one more that warms up, read from
    the program's spans (utils/timer.py)."""
    from envgs_tpu_torch.utils import timer

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    timer.RECORD.clear()
    with torch.no_grad(), torch.profiler.profile(activities=acts):
        for _ in range(reps + 1):
            render()
    roots = timer.read_spans()[1:]
    stages = {k: statistics.median(r["device_ms"][k] for r in roots)
              for k in roots[-1]["device_ms"]}
    return stages, roots[-1]["counts"]


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
                             for p in params if p is not None)),
            GaussianParams(*(t(rng.random(p.shape) * 1e-5 + 1e-6)
                             for p in params if p is not None)),
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
                                 out[name]._asdict().items()
                                 if v is not None}
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
            grads = type(pool.params)(**{
                k: torch.tensor(v) for k, v in g_grads[it][name].items()})
            new_p, new_opt = sparse_adam_update(
                pool.params, grads, getattr(start, "opt_" + name),
                lr_tree_for(it, lr))
            for grp, tree in (("params", new_p), ("mu", new_opt.mu),
                              ("nu", new_opt.nu)):
                for k, ref in zip(tree._fields, tree):
                    if ref is None:
                        continue
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


def _to_cpu(tree):
    """A copy on the host of a tree of NamedTuples holding tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_cpu(x) for x in tree))
    return tree


def run_schedule():
    """The schedule of phase 14's run: the compressed schedule with one
    normal propagation."""
    from envgs_tpu_torch import bench

    return bench.compressed_schedule(normal_prop_interval=16)


def run_runner(views, eval_views, base, env, cfg, sched, out_root, resume,
               exp="run"):
    """The Runner of phase 14's run (phase 21 builds it again in each
    rank)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.gaussians import DensifyConfig
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.runner import Runner
    from envgs_tpu_torch.train.supervisor import LossConfig

    return Runner(
        views, base, env, cfg, LossConfig(perc_loss_weight=0.0), sched,
        DensifyConfig(max_gs=base.cap, **bench.RUN_DENSIFY),
        DensifyConfig(max_gs=env.cap, **bench.RUN_DENSIFY_ENV), LRConfig(),
        LRConfig(), exp_name=exp, out_root=out_root, eval_views=eval_views,
        resume=resume, log_every=5, save_latest_every=0)


def full_run(device, out_root, kernels, size=None):
    """Phase 14: the compressed schedule through the Runner on the run
    scene (full width unless `size` shrinks it), then save, resume and
    evaluation. Returns (launch counts of the run, of the evaluation,
    figures, make_runner(resume, run_views=None, exp="run"): a Runner of
    the run scene, resumed with `resume` from the run's checkpoint, or with
    exp="run_dense" from the one taken before the last opacity reset, the
    views)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.train import checkpoints as ckpt
    from envgs_tpu_torch.train import trainer

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
    sched = run_schedule()
    cfg = cfg._replace(reflection_start_iter=sched.reflection_start_iter)

    def make_runner(resume, run_views=None, exp="run"):
        return run_runner(run_views or views, eval_views, base, env, cfg,
                          sched, out_root, resume, exp)

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
    # the state entering the first base opacity reset after the normal
    # propagation (which sets every opacity to 0.9): the last opaque one,
    # kept on the host for phase 18's mesh, its copy's time taken out of
    # the run's
    dense_it = next(i for i in range(sched.opacity_reset_interval,
                                     sched.total_iters,
                                     sched.opacity_reset_interval)
                    if i > sched.normal_prop_interval)
    dense = {}

    def wrapped(st, it, log=None):
        sync()
        if it == dense_it:
            t0 = time.perf_counter()
            dense.update(state=_to_cpu(st), s=time.perf_counter() - t0)
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
            K1_TRAIN, "raster_blend_bwd", "fill_forward")
        if cuda and any(v != (k in want) for k, v in rose.items()):
            raise AssertionError(f"run it {it}: launches off: {rose}")
    for pool in (state.base, state.env):
        for name, p in zip(pool.params._fields, pool.params):
            if p is not None and not bool(torch.isfinite(p).all()):
                raise AssertionError(f"run: non-finite {name}")
    grown = (runner.model_cfg.pair_cap, runner.model_cfg.env_pair_cap)
    sps = total / (t_end - t_train - dense["s"])
    step_ms = [(snaps[i + 1][0] - snaps[i][0]) * 1e3 for i in range(total)]
    step_ms[dense_it - 1] -= dense["s"] * 1e3
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
                if x is not None and not torch.equal(x[:n], y[act]):
                    raise AssertionError(f"resume: {which} arrays differ")
    ckpt.save_checkpoint(os.path.join(out_root, "trained_model", "run_dense",
                                      "latest.npz"), dense["state"], dense_it)
    op = float(dense["state"].base.get_opacity.max())
    if not op >= 0.5:
        raise AssertionError(f"run: max base opacity {op} at it {dense_it}")
    del dense["state"]
    files = sorted(os.listdir(again.model_dir))
    size_mb = os.path.getsize(os.path.join(again.model_dir,
                                           "latest.npz")) / 2 ** 20
    print(f"[run] saved {files} in {figures['save_s']:.1f} s (latest.npz "
          f"{size_mb:.0f} MiB), resumed into a fresh runner in "
          f"{figures['load_s']:.1f} s: iteration {again.start_iter}, active "
          f"rows, moments and steps equal; the state entering it {dense_it} "
          f"(max base opacity {op:.4f}) copied to the host in "
          f"{dense['s'] * 1e3:.1f} ms (taken out of the run's times) and "
          "saved for the mesh", flush=True)

    # ---- evaluation: exact order (K1 alone), radial order (K1 and K3) ----
    cam = eval_views[0]["camera"]
    for exact, want in ((True, ("raster_blend_fwd", "env_cull")),
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
    return run_launches, eval_launches, figures, make_runner, views


def ring_views(cam, center, radius, n=4):
    """n views on a level ring of `radius` about `center`, each facing it,
    the first behind `cam` on its optical axis: keyframes for an orbit.
    (The run scene's views are `cam` turned in place; with one centre
    among them an orbit has no radius.)"""
    from envgs_tpu_torch.utils.camera import make_camera

    views = []
    for i in range(n):
        t = 2 * np.pi * i / n
        c = np.asarray(center) + radius * np.array([np.sin(t), 0.0,
                                                    -np.cos(t)])
        fwd = (np.asarray(center) - c) / radius
        down = np.array([0.0, 1.0, 0.0])
        R = np.stack([np.cross(down, fwd), down, fwd])
        views.append(dict(camera=make_camera(
            cam.H, cam.W, cam.K.cpu().numpy(), R, -R @ c, cam.znear,
            cam.zfar, device=cam.K.device), name=f"ring{i}"))
    return views


def path_run(make_runner, cam, kernels, n_frames=8):
    """Phase 15: an orbit of n_frames through the run's trained scene by
    Runner.render_path, from a fresh runner resumed from the run's
    checkpoint (as the `render` mode does) whose views are a ring about
    the scene's centre, made from the run's camera `cam`. -> (launch
    counts of the path, median ms per frame)."""
    from envgs_tpu_torch import bench

    from envgs_tpu_torch.ops.raster_blend import CHUNK

    cuda = cam.K.is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the train scene's surfels: x, y ~ N(0, 1.5), depth 2..7 before `cam`
    runner = make_runner(True, ring_views(cam, (0.0, 0.0, 4.5), 9.0))
    # caps for views from every side, as a user's render config sets them:
    # seen from the side the whole cloud is in view and the env cull hands
    # its tiles more than the run's 2^22 slots (2.2M dropped in one frame);
    # a tile takes at most 2048 candidates (default_per_tile_cap) in
    # 64-slot chunks, so this env cap cannot overflow
    tiles = -(-cam.W // 16) * -(-cam.H // 16)
    runner.model_cfg = runner.model_cfg._replace(
        pair_cap=2 * runner.model_cfg.pair_cap,
        env_pair_cap=tiles * (2048 + CHUNK))
    outs, render_ms = [], []
    render_view = runner.render_view

    def timed_render(c, *args, **kw):
        sync()
        t0 = time.perf_counter()
        out = render_view(c, *args, **kw)
        sync()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        return out

    runner.render_view = timed_render
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out_dir = runner.render_path(n_frames=n_frames, kind="orbit",
                                 tag="orbit")
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    want = {k: n_frames if k in RENDER_KERNELS else 0 for k in launches}
    if cuda and launches != want:
        raise AssertionError(f"render path launches off: {launches}")
    frames = sorted(os.listdir(os.path.join(out_dir, "RENDER")))
    if frames != [f"frame0000_camera{i:04d}.png" for i in range(n_frames)]:
        raise AssertionError(f"render path frames: {frames}")
    stats = [bench.check_render(o, runner.model_cfg) for o in outs]
    print(f"[path] orbit of {n_frames} frames at {cam.W}x{cam.H} through "
          f"the trained run scene (resumed at iteration "
          f"{runner.start_iter}): {n_frames} RENDER PNGs, rgb finite, std "
          f"{min(s[2] for s in stats):.3f}-{max(s[2] for s in stats):.3f}, "
          f"base pairs {min(s[0] for s in stats)}-"
          f"{max(s[0] for s in stats)} of {runner.model_cfg.pair_cap}, env "
          f"slots {min(s[1] for s in stats)}-{max(s[1] for s in stats)} of "
          f"{runner.model_cfg.env_pair_cap}, none dropped; "
          f"launches { {k: v for k, v in launches.items() if v} }; "
          f"{statistics.median(render_ms):.1f} ms per frame rendered "
          f"(median), {total_ms / n_frames:.1f} ms per frame with the PNGs",
          flush=True)
    if runner.start_iter == 0:
        raise AssertionError("render path: the runner did not resume")
    return launches, statistics.median(render_ms)


def cli_run(kernels, tmp):
    """Phase 15's entry points: `smoke` (cut to 30 iterations), then
    `render -c <its config> --path-kind spiral --path-frames 4`, which
    resumes the checkpoint smoke left, in `tmp`. -> launch counts."""
    import yaml

    from envgs_tpu_torch import cli

    small = ["runner_cfg.ep_iter=30", "runner_cfg.log_interval=10",
             "model_cfg.sampler_cfg.reflection_start_iter=10"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        cli.main(["smoke", *small])
        t1 = time.perf_counter()
        cfg = cli.smoke_config().to_dict()
        cfg["runner_cfg"]["resume"] = True
        with open("smoke.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        before = dict(kernels.LAUNCHES)
        # (make_runner renders the synthetic scene's views before the path)
        out = cli.main(["render", "-c", "smoke.yaml", "--path-kind",
                        "spiral", "--path-frames", "4", *small])
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)
        rose = {k: launches[k] - before[k] for k in launches}
        frames = sorted(os.listdir(os.path.join(out, "RENDER")))
    finally:
        os.chdir(cwd)
    if frames != [f"frame0000_camera{i:04d}.png" for i in range(4)]:
        raise AssertionError(f"cli render frames: {frames}")
    if (any(rose[k] < 4 for k in RENDER_KERNELS)
            or any(v for k, v in rose.items() if k not in RENDER_KERNELS)):
        raise AssertionError(f"cli render launches off: {rose}")
    print(f"[path] cli: smoke (30 iterations) in {t1 - t0:.1f} s, then "
          f"render -c smoke.yaml --path-kind spiral --path-frames 4 from its "
          f"checkpoint in {t2 - t1:.1f} s: 4 frames in {out}; render "
          f"launches { {k: v for k, v in rose.items() if v} }", flush=True)
    return launches


CAPTURE_VIEWS = 24  # cameras of phase 16's capture, on a ring
CAPTURE_ITERS = 60  # phase 16a: iterations, the reflection gate at 20
CAPTURE_GATE = 20
SEDAN = "configs/exps/envgs/ref_real/envgs_sedan.yaml"
GAUSSIANT = "configs/exps/gaussiant_synthetic.yaml"


def write_capture(root):
    """Phase 16's capture of the train bench scene in easyvolcap layout
    under `root`: CAPTURE_VIEWS cameras on a level ring of radius 9 about
    the scene's centre, each view rendered by the port at 1558x1038 (render
    mode), upsampled 2x on the host (each pixel repeated) and written as
    images/<cam>/000000.jpg (3116x2076, PIL, quality 95) with its K doubled,
    the view-space normals as normals/<cam>/000000.png (also 2x), the base
    surfels' centres and colours as a binary COLMAP model under sparse/0,
    the env surfels' as envs/points3D.ply. -> (seconds, spatial scale)."""
    from PIL import Image

    from envgs_tpu_torch import bench
    from envgs_tpu_torch.data.synthetic import capture_view
    from envgs_tpu_torch.utils import colmap
    from envgs_tpu_torch.utils.easycam import write_cameras
    from envgs_tpu_torch.utils.ply import save_sfm_ply
    from envgs_tpu_torch.utils.sh import C0

    t0 = time.perf_counter()
    base, env, cam, cfg, _ = bench.make_train_scene("cuda")
    cfg = cfg._replace(render_mode=True)
    ring = ring_views(cam, (0.0, 0.0, 4.5), 9.0, n=CAPTURE_VIEWS)
    cams, ccams, ims = {}, {}, {}

    def up2(a):
        return np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)

    def u8(a):
        return (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)

    for i, v in enumerate(ring):
        c = v["camera"]
        name = f"{i:02d}"
        image, _, normal = capture_view(base, env, c, cfg)
        for sub, arr, ext, kw in (("images", image, ".jpg", {"quality": 95}),
                                  ("normals", normal, ".png",
                                   {"compress_level": 1})):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
            Image.fromarray(up2(u8(arr))).save(
                os.path.join(root, sub, name, "000000" + ext), **kw)
        K2 = c.K.cpu().numpy().astype(np.float64) * [[2], [2], [1]]
        R, T = c.R.cpu().numpy(), c.T.cpu().numpy()
        cams[name] = dict(K=K2, R=R, T=T.reshape(3, 1), H=2 * c.H,
                          W=2 * c.W)
        ccams[i + 1] = colmap.ColmapCamera(
            i + 1, "PINHOLE", 2 * c.W, 2 * c.H,
            np.array([K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]]))
        ims[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat_to_qvec(R), T.astype(np.float64), i + 1,
            f"{name}.jpg", np.zeros((0, 2)), np.zeros(0, np.int64))
    write_cameras(cams, root)

    def points(pool):
        act = pool.stats.active
        rgb = pool.params.features_dc[act][:, 0, :] * C0 + 0.5
        return (pool.params.xyz[act].cpu().numpy(),
                u8(rgb.cpu().numpy()))

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), ccams)
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), ims)
    colmap.write_points3D_binary(os.path.join(sparse, "points3D.bin"),
                                 *points(base))
    os.makedirs(os.path.join(root, "envs"))
    save_sfm_ply(os.path.join(root, "envs", "points3D.ply"), *points(env))
    centres = np.stack([-c["R"].T @ c["T"][:, 0] for c in cams.values()])
    scale = float(np.linalg.norm(centres - centres.mean(0), axis=-1).max())
    return time.perf_counter() - t0, scale


def instrumented_cli(argv, kernels):
    """cli.main(argv) with the Runner it makes instrumented: the kernel
    counts and the host clock at each iteration's maintenance and at the
    end of train(), each step's loss, the resolutions whose train step was
    built, ms and decoder of each rgb load, the outputs of render_view.
    -> (cli.main's result, info)."""
    from envgs_tpu_torch import cli
    from envgs_tpu_torch.data.dataset import MultiViewDataset
    from envgs_tpu_torch.train import runner as runner_mod

    info = dict(snaps=[], losses=[], dropped=[], built=[], loads=[],
                renders=[], runner=None)
    make_runner, load_rgb = cli.make_runner, MultiViewDataset._load_rgb
    make_step, render_view = runner_mod.make_train_step, \
        runner_mod.Runner.render_view

    def timed_load(self, v):
        before = dict(self.decoders)
        t0 = time.perf_counter()
        im = load_rgb(self, v)
        info["loads"].append(((time.perf_counter() - t0) * 1e3, next(
            k for k, n in self.decoders.items() if n != before.get(k, 0))))
        return im

    def counted_step(cam, *a, **kw):
        info["built"].append((cam.H, cam.W))
        step = make_step(cam, *a, **kw)

        def recorded(*args, **kwargs):
            out = step(*args, **kwargs)
            stats = out[-1]
            info["losses"].append(stats["loss"])
            info["dropped"].append(stats.get("pair_overflow", 0)
                                   + stats.get("trace_dropped", 0))
            return out
        return recorded

    def recorded_render(self, *a, **kw):
        out = render_view(self, *a, **kw)
        info["renders"].append(out)
        return out

    def made(cfg, device="cuda"):
        r = make_runner(cfg, device)
        info["runner"] = r
        info["caps"] = (r.model_cfg.pair_cap, r.model_cfg.env_pair_cap)
        maintain, train = r.maintain, r.train

        def snap(it):
            torch.cuda.synchronize()
            info["snaps"].append((it, time.perf_counter(),
                                  dict(kernels.LAUNCHES)))

        def snapped(st, it, log=None):
            snap(it)
            return maintain(st, it, log=log)

        def train_then_snap():
            st = train()
            snap(None)
            return st

        r.maintain, r.train = snapped, train_then_snap
        return r

    cli.make_runner = made
    MultiViewDataset._load_rgb = timed_load
    runner_mod.make_train_step = counted_step
    runner_mod.Runner.render_view = recorded_render
    try:
        out = cli.main(argv)
    finally:
        cli.make_runner = make_runner
        MultiViewDataset._load_rgb = load_rgb
        runner_mod.make_train_step = make_step
        runner_mod.Runner.render_view = render_view
    return out, info


def check_capture_run(name, info, kernels, gate):
    """The checks of a training run of phase 16: every step's loss finite,
    the final params finite, per iteration K1, K2 and K5 once and K3 / K4
    once from `gate` on, nothing else; the cap growth printed if it fired.
    -> (iteration ms before / after the gate: medians, the first and last
    iteration left out; the run's launches)."""
    r = info["runner"]
    snaps = info["snaps"]
    losses = torch.stack(info["losses"]).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    for pool in (r.state.base, r.state.env):
        for field, p in zip(pool.params._fields, pool.params):
            if p is not None and not bool(torch.isfinite(p).all()):
                raise AssertionError(f"{name}: non-finite {field}")
    total = r.sched.total_iters
    if len(snaps) != total + 1 or len(losses) != total:
        raise AssertionError(f"{name}: {len(snaps)} snapshots, "
                             f"{len(losses)} steps for {total} iterations")
    ms = {True: [], False: []}
    for i in range(total):
        rose = {k: snaps[i + 1][2][k] - snaps[i][2][k] for k in snaps[i][2]}
        want = TRAIN_KERNELS if i >= gate else (
            K1_TRAIN, "raster_blend_bwd", "fill_forward")
        if any(v != (k in want) for k, v in rose.items()):
            raise AssertionError(f"{name} it {i}: launches off: {rose}")
        if 0 < i < total - 1:
            ms[i >= gate].append((snaps[i + 1][1] - snaps[i][1]) * 1e3)
    launches = {k: snaps[-1][2][k] - snaps[0][2][k] for k in snaps[0][2]}
    return (statistics.median(ms[False]) if ms[False] else float("nan"),
            statistics.median(ms[True]) if ms[True] else float("nan"),
            launches)


def capture_runs(kernels, tmp, card):
    """Phase 16: a capture on disk at full width (write_capture) trained
    through the shipped configs' entry points:
    a. `train -c` a config stacking envgs_sedan.yaml (data_root, both
       view_sample lists null with the every-8th split, ratio 0.5 so the
       decode and resize run at 3116x2076 and the model at 1558x1038,
       spatial_scale, the preload paths, 60 iterations, the reflection
       gate at 20; the config's own pools of 2,000,000 / 700,000), which
       evaluates the held-out views, then `render --path-frames 4` from
       its checkpoint (with the render caps of phase 15);
    b. the same with the ratio moderator for 40 iterations, then the
       alternating moderator with 512x512 patches for 20;
    c. `train -c` a config stacking gaussiant_synthetic.yaml on the same
       capture (the multiview source), 30 iterations.
    `card`: nvidia-smi's name and power limit, printed beside the numbers.
    -> {path: launch counts}."""
    import yaml

    from envgs_tpu_torch import bench, cli
    from envgs_tpu_torch.data import native_loader
    from envgs_tpu_torch.ops.raster_blend import CHUNK
    from envgs_tpu_torch.train import gaussiant_loop

    repo = os.path.dirname(os.path.abspath(__file__))
    cap = os.path.join(tmp, "capture")
    secs, sphere = write_capture(cap)
    try:
        import cv2  # noqa: F401
        python_decoder = "cv2"
    except ImportError:
        python_decoder = "PIL"
    print(f"[capture] {CAPTURE_VIEWS} views of 3116x2076 (jpg, normals png),"
          f" a COLMAP model of the base surfels and the env ply written in "
          f"{secs:.1f} s; native loader "
          + ("built: " + native_loader.library_path().name
             if native_loader.available() else "not built (no compiler or "
             "library)") + f"; python decoder {python_decoder}", flush=True)

    def write(name, cfg):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    sedan = write("capture_sedan.yaml", {
        "configs": [os.path.join(repo, SEDAN)],
        "out_root": os.path.join(tmp, "out"),
        "dataset_cfg": {"data_root": cap, "view_sample": None, "ratio": 0.5,
                        "eval_every": 8},
        "val_dataset_cfg": {"view_sample": None},
        "model_cfg": {"sampler_cfg": {
            "spatial_scale": sphere,
            "preload_gs": os.path.join(cap, "sparse", "0", "points3D.ply"),
            "env_preload_gs": os.path.join(cap, "envs", "points3D.ply"),
            "render_reflection_start_iter": CAPTURE_GATE}},
        "runner_cfg": {"epochs": 1, "ep_iter": CAPTURE_ITERS}})
    paths = {}

    # ---- a. train, test, render ----
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, info = instrumented_cli(["train", "-c", sedan], kernels)
    train_s = time.perf_counter() - t0
    r = info["runner"]
    cam0 = r.views[0]["camera"]
    if (cam0.W, cam0.H) != (1558, 1038):
        raise AssertionError(f"capture: views of {cam0.W}x{cam0.H}")
    if (r.state.base.cap, r.state.env.cap) != (2_000_000, 700_000):
        raise AssertionError(f"capture: pools {r.state.base.cap}, "
                             f"{r.state.env.cap}")
    before, after, run = check_capture_run("capture", info, kernels,
                                           CAPTURE_GATE)
    paths["capture_train"] = run
    paths["capture_eval"] = {k: kernels.LAUNCHES[k] - info["snaps"][-1][2][k]
                             for k in kernels.LAUNCHES}
    frames = summary["frames"]
    s = summary["summary"]
    if (len(frames) != 3 or not np.isfinite(s["psnr_mean"])
            or not os.path.exists(os.path.join(r.result_dir,
                                               "metrics.json"))):
        raise AssertionError(f"capture eval: {s}")
    loads = [ms for ms, _ in info["loads"]]
    decoders = sorted({d for _, d in info["loads"]})
    grown = (r.model_cfg.pair_cap, r.model_cfg.env_pair_cap)
    n_dropped = sum(float(d) > 0 for d in info["dropped"])
    if n_dropped and grown == info["caps"]:
        raise AssertionError(f"capture: {n_dropped} steps dropped pairs and "
                             "the caps did not grow")
    eval_ms = 1e3 * np.mean([f["time"] for f in frames])
    print(f"[capture] train -c {SEDAN} (+ the capture): "
          f"{len(r.views)} + {len(r.eval_views)} views at 1558x1038 from "
          f"3116x2076, {int(r.state.base.stats.active.sum())} base surfels "
          f"in {r.state.base.cap} slots, "
          f"{int(r.state.env.stats.active.sum())} env in {r.state.env.cap}; "
          f"rgb load (decode + resize) {statistics.median(loads):.1f} ms "
          f"(median of {len(loads)}) by {', '.join(decoders)}; "
          f"{CAPTURE_ITERS} iterations: median {before:.1f} ms before the "
          f"reflection gate, {after:.1f} ms after; caps (pair, env) "
          f"{info['caps']} -> {grown}" + (
              "" if grown == info["caps"] else " (the cap growth fired: "
              f"{n_dropped} steps dropped pairs)")
          + f"; loss {float(info['losses'][0]):.4f} -> "
          f"{float(info['losses'][-1]):.4f}; eval of {len(frames)} held-out "
          f"views (exact order) {eval_ms:.1f} ms per view, PSNR {s['psnr_mean']:.3f}, SSIM "
          f"{s['ssim_mean']:.4f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{train_s:.1f} s in all [{card}]", flush=True)

    tiles = -(-1558 // 16) * -(-1038 // 16)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out, info = instrumented_cli(
        ["render", "-c", sedan, "--path-frames", "4",
         f"model_cfg.sampler_cfg.pair_cap={2 * grown[0]}",
         f"model_cfg.sampler_cfg.env_pair_cap={tiles * (2048 + CHUNK)}"],
        kernels)
    render_s = time.perf_counter() - t0
    paths["capture_render"] = dict(kernels.LAUNCHES)
    frames = sorted(os.listdir(os.path.join(out, "RENDER")))
    if frames != [f"frame0000_camera{i:04d}.png" for i in range(4)]:
        raise AssertionError(f"capture render frames: {frames}")
    if info["runner"].start_iter != CAPTURE_ITERS:
        raise AssertionError("capture render: not resumed")
    want = {k: 4 if k in RENDER_KERNELS else 0 for k in kernels.LAUNCHES}
    if paths["capture_render"] != want:
        raise AssertionError(f"capture render launches off: "
                             f"{paths['capture_render']}")
    stats = [bench.check_render(o, info["runner"].model_cfg)
             for o in info["renders"]]
    print(f"[capture] render -c ... --path-frames 4 from the checkpoint of "
          f"iteration {info['runner'].start_iter}: 4 frames, K1 and K3 once "
          f"a frame, base pairs {min(p for p, _, _ in stats)}-"
          f"{max(p for p, _, _ in stats)}, env slots "
          f"{min(e for _, e, _ in stats)}-{max(e for _, e, _ in stats)}, "
          f"none dropped; {render_s:.1f} s with the dataset, resume and "
          f"PNGs", flush=True)

    # ---- b. the moderators ----
    for name, mod, iters, extra in (
            ("ratio", {"type": "DatasetRatioModerator",
                       "milestone_start": 0.25, "milestone_end": 1.0,
                       "iter_start": 0, "iter_end": 30}, 40, {}),
            ("alternating", {"type": "AlternatingModerator"}, 20,
             {"patch_size": [512, 512]})):
        cfg = write(f"capture_{name}.yaml", {
            "configs": [sedan], "exp_name": f"capture_{name}",
            "model_cfg": {"sampler_cfg": extra},
            "runner_cfg": {"ep_iter": iters, "moderator_cfg": mod}})
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        _, info = instrumented_cli(["train", "-c", cfg], kernels)
        secs = time.perf_counter() - t0
        before, after, run = check_capture_run(f"capture {name}", info,
                                               kernels, CAPTURE_GATE)
        paths[f"capture_{name}"] = run
        r = info["runner"]
        built = info["built"]
        grew = r.model_cfg.pair_cap, r.model_cfg.env_pair_cap
        if len(set(built)) != len(built) and grew == info["caps"]:
            raise AssertionError(f"capture {name}: steps built {built}")
        H, W = cam0.H, cam0.W
        want_sizes = ({(int(H * b) // 16 * 16, int(W * b) // 16 * 16)
                       for b in (0.25, 0.5, 0.75)} | {(H, W)}
                      if name == "ratio" else {(512, 512), (H, W)})
        if set(built) != want_sizes:
            raise AssertionError(f"capture {name}: step sizes {built}")
        print(f"[capture] {name} moderator, {iters} iterations: train steps "
              f"built for (H, W) {built} (step cache "
              f"{sorted(r._step_cache)}), caps {grew}; K1, K2, K5 once a "
              f"step, K3/K4 from {CAPTURE_GATE}; loss "
              f"{float(info['losses'][0]):.4f} -> "
              f"{float(info['losses'][-1]):.4f}; median iteration "
              f"{before:.1f} / {after:.1f} ms either side of the gate; "
              f"{secs:.1f} s in all", flush=True)

    # ---- c. the 3DGS family from its config ----
    cfg = write("capture_gaussiant.yaml", {
        "configs": [os.path.join(repo, GAUSSIANT)],
        "out_root": os.path.join(tmp, "out"),
        "dataset_cfg": {"source": "multiview", "data_root": cap,
                        "ratio": 0.5, "eval_every": 8},
        "model_cfg": {"sampler_cfg": {
            "raster_backend": "pallas", "pool_cap": 2 ** 20,
            "pair_cap": 2 ** 24}},
        "runner_cfg": {"ep_iter": 30, "log_interval": 10}})
    make_step = gaussiant_loop.make_gaussiant_train_step
    steps = []

    def counted(gcfg, cam):
        step = make_step(gcfg, cam)

        def recorded(*a):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            out = step(*a)
            steps.append(({k: kernels.LAUNCHES[k] - before[k]
                           for k in before}, out[1]["loss"],
                          out[1]["pair_overflow"]))
            return out
        return recorded

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    gaussiant_loop.make_gaussiant_train_step = counted
    t0 = time.perf_counter()
    try:
        state, summary = cli.main(["train", "-c", cfg])
    finally:
        gaussiant_loop.make_gaussiant_train_step = make_step
    secs = time.perf_counter() - t0
    paths["capture_gaussiant"] = dict(kernels.LAUNCHES)
    if len(steps) != 30:
        raise AssertionError(f"capture 3DGS: {len(steps)} steps")
    for i, (rose, loss, overflow) in enumerate(steps):
        if any(v != (k in GAUSSIANT_TRAIN_KERNELS) for k, v in rose.items()):
            raise AssertionError(f"capture 3DGS step {i}: {rose}")
        if not np.isfinite(float(loss)) or float(overflow) > 0:
            raise AssertionError(f"capture 3DGS step {i}: loss {loss}, "
                                 f"pairs over the cap {overflow}")
    ply = os.path.join(tmp, "out", "trained_model", "gaussiant_synthetic",
                       "point_cloud.ply")
    s = summary["summary"]
    if not os.path.exists(ply) or not np.isfinite(s["psnr_mean"]):
        raise AssertionError(f"capture 3DGS: ply or metrics missing: {s}")
    print(f"[capture] train -c {GAUSSIANT} (+ the capture): 30 iterations, "
          f"K5 and gauss3d K1 / K2 once a step, loss "
          f"{float(steps[0][1]):.4f} -> {float(steps[-1][1]):.4f}, "
          f"{int(state.pool.stats.active.sum())} Gaussians in "
          f"{state.pool.cap} slots, point_cloud.ply "
          f"{os.path.getsize(ply) / 2 ** 20:.0f} MiB; held-out PSNR "
          f"{s['psnr_mean']:.3f}, SSIM {s['ssim_mean']:.4f} over "
          f"{len(summary['frames'])} views; {secs:.1f} s in all", flush=True)
    return paths


def _rose(before, kernels):
    """The launches since `before`, the kernels that ran alone."""
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


def stage_ms(stages, reps=3):
    """Median device ms (CUDA events) of each of `stages`, (name, fn)
    pairs called in order, the first call of all a warm-up; fn takes the
    result of the stage before it (None for the first)."""
    times = {}
    for rep in range(reps + 1):
        res = None
        for name, fn in stages:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(res)
            e1.record()
            if rep:
                times.setdefault(name, []).append((e0, e1))
    torch.cuda.synchronize()
    return {k: round(statistics.median(a.elapsed_time(b) for a, b in v), 4)
            for k, v in times.items()}


@contextlib.contextmanager
def plain_forward_blends(kernels):
    """Within it the forward blends' wrappers (K1, K3) run their plain
    versions on the card's own tensors and count nothing: a render through
    them differs from the kernels' by the kernels alone."""
    from envgs_tpu_torch.ops.raster_blend import blend_tiles_torch
    from envgs_tpu_torch.ops.trace_blend import trace_blend_torch

    saved = kernels.raster_blend_fwd, kernels.trace_blend_fwd
    kernels.raster_blend_fwd = blend_tiles_torch
    kernels.trace_blend_fwd = trace_blend_torch
    try:
        yield
    finally:
        kernels.raster_blend_fwd, kernels.trace_blend_fwd = saved


def nonfinite(tree) -> dict:
    """{name: count} of the non-finite entries of a dict of tensors and
    GaussianParams (the names of those with any)."""
    out = {}
    for k, v in tree.items():
        for f, x in (zip(v._fields, v) if hasattr(v, "_fields")
                     else ((None, v),)):
            if x is None:
                continue
            n = int((~torch.isfinite(x)).sum())
            if n:
                out[k if f is None else f"{k}.{f}"] = n
    return out


def traced_slice(name, kernels, base, env, cam, cfg, batch, render_rose,
                 step_rose, restart=False):
    """3 renders and 1 + 10 train steps of one configuration of the train
    bench scene: each render and step launching exactly `render_rose` /
    `step_rose`, finite loss and params, nothing dropped by the env trace;
    fps, steps/s, the step's stage ms, peak memory. With `restart` every
    step starts from the scene's state, and the non-finite entries of the
    first step's gradients and of the state it leaves are reported rather
    than refused (the blend backward's T-rebuild fault, ROADMAP Queue 3).
    -> (launches of the renders, launches of the steps, stats of the last
    step)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.envgs import forward_envgs
    from envgs_tpu_torch.train.trainer import init_train_state

    rcfg = cfg._replace(render_mode=True)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    render_ms = []
    for i in range(3):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward_envgs(base, env, cam, bench.TRAIN_IT, rcfg)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        rose = _rose(before, kernels)
        rgb = out.rgb_map
        if rose != render_rose or not bool(torch.isfinite(rgb).all()) or not (
                float(rgb.std()) > 0.01) or int(out.env_dropped_pairs):
            raise AssertionError(f"{name} render {i}: launches {rose}, rgb "
                                 f"std {float(rgb.std())}, env dropped "
                                 f"{int(out.env_dropped_pairs)}")
    renders = dict(kernels.LAUNCHES)
    print(f"[{name}] 3 renders: {', '.join(f'{m:.1f}' for m in render_ms)} "
          f"ms ({2e3 / sum(render_ms[1:]):.3f} fps over the last two), "
          f"launches each {render_rose}, env slots "
          f"{int(out.env_num_pairs)}/{cfg.env_pair_cap}, rgb std "
          f"{float(rgb.std()):.4f}", flush=True)
    del out, rgb
    step = bench.make_bench_step(cam, cfg)
    start = state = init_train_state(base, env)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # what the steps find
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    n_steps = 10
    grads = {}
    for i in range(n_steps + 1):
        before = dict(kernels.LAUNCHES)
        if i == 1:  # after the warm-up step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, stats = step(start if restart else state, batch, cam.K, cam.R,
                            cam.T, bench.TRAIN_IT,
                            grads_out=grads if i == 0 else None)
        rose = _rose(before, kernels)
        loss, dr = float(stats["loss"]), int(stats["trace_dropped"])
        if rose != step_rose or not np.isfinite(loss) or dr:
            raise AssertionError(f"{name} step {i}: launches {rose}, loss "
                                 f"{loss}, trace_dropped {dr}")
    torch.cuda.synchronize()
    sps = n_steps / (time.perf_counter() - t0)
    steps = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = nonfinite({"base": state.base.params, "env": state.env.params})
    if restart:
        print(f"[{name}] fault probe: non-finite entries of the first "
              f"step's gradients {nonfinite(grads)}, of the state one step "
              f"leaves {bad}", flush=True)
    elif bad:
        raise AssertionError(f"{name}: non-finite params {bad}")
    print(f"[{name}] train steps/s over {n_steps} steps: {sps:.4f} "
          f"({1e3 / sps:.1f} ms per step), loss {loss:.6f}, launches each "
          f"{step_rose}, stats keys {sorted(stats)}, peak device memory "
          f"{peak:.2f} GiB ({held:.2f} held before the first step)",
          flush=True)
    stages = bench.train_stage_times(step, state, batch, cam, reps=3)
    print(f"[{name}] step stage ms (median of 3, CUDA events): "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)
    return renders, steps, stats


def traced_runs(kernels):
    """Phase 17: the base pass traced along the camera rays and two-bounce
    reflections on the train bench scene at full width, K3's geometry and
    forward-wet configurations and K4 with A = 2 against their plain
    versions on those inputs, and the committed golden scenes rendered
    with the kernels. -> (numbers for the kernels line, launches by
    path)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.envgs import (
        render_base,
        render_base_traced,
        render_env,
        reflect_rays,
    )
    from envgs_tpu_torch.ops import tracer
    from envgs_tpu_torch.ops.trace_blend import (
        bwd_slot_columns,
        trace_blend_bwd_torch,
        trace_blend_torch,
    )
    from envgs_tpu_torch.ops.trace_blend import rows as trace_rows
    from envgs_tpu_torch.utils import golden

    res, paths = {}, {}
    t0 = time.perf_counter()
    base, env, cam, cfg, batch = bench.make_train_scene("cuda")
    print(f"[traced] train bench scene built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    def held(label, got, want, names):
        return compare(label, got, want, names, KERNEL_ATOL)

    def planes(A, train):
        r = trace_rows(A)
        out = {"rgb": slice(0, 3), "dpt": r["dpt"], "acc": r["acc"],
               "normal": slice(r["normal"], r["normal"] + 3),
               "dist": r["dist"], "T": r["trans"]}
        if A:
            out["aux"] = slice(r["aux"], r["aux"] + A)
        if train:
            out.update(d1=r["d1"], d2=r["d2"], last=r["last"])
        return out

    # ---- a. the traced base: K3 geometry (render), training + K4 (step)
    bcfg = cfg._replace(use_base_tracing=True, pair_cap=2 ** 24)
    scene, ray_o, ray_d = bench.traced_base_scene(base, cam, bcfg)
    k3, dropped = bench.trace_inputs(scene, ray_o, ray_d, bcfg.pair_cap)
    packed, gidx, rays, bounds, tx, ty = k3
    npix = tx * ty * 256
    print(f"[traced] base K3 inputs: {tx * ty} tiles, {int(bounds[-1])} "
          f"candidate slots of {gidx.numel()}, {int(dropped)} dropped by "
          f"the cap of {bcfg.pair_cap}", flush=True)
    if int(dropped):
        raise AssertionError("the traced base's cull dropped slots")
    geo = kernels.trace_blend_fwd(*k3, False, 2, True)
    res["geo_err"] = held("trace_blend_fwd (geometry, A = 2)", geo,
                          trace_blend_torch(*k3, False, 2, True),
                          planes(2, False))
    del geo
    out = kernels.trace_blend_fwd(*k3, True, 2)
    res["a2_fwd_err"] = held("trace_blend_fwd (train, A = 2, traced base)",
                             out, trace_blend_torch(*k3, True, 2),
                             planes(2, True))
    ev = walked(out[trace_rows(2)["last"]])
    res["a2_fwd_ms"] = cuda_ms(lambda: kernels.trace_blend_fwd(*k3, True, 2),
                               10)
    res["a2_fwd_plain_ms"] = cuda_ms(lambda: trace_blend_torch(
        *k3, True, 2), 1)
    res["a2_fwd_bound"] = blend_bound(packed, int(bounds[-1]), 0, 15 * npix,
                                      ev, OPS_RAY_TERMS,
                                      extra_bytes=rays.numel() * 4)
    print(f"[kernels] trace_blend_fwd (train, A = 2, traced base) "
          f"{res['a2_fwd_ms']:.4f} ms, plain {res['a2_fwd_plain_ms']:.2f} ms, "
          f"bound {res['a2_fwd_bound'][0]:.4f} ms by "
          f"{res['a2_fwd_bound'][1]}", flush=True)
    res["geo_ms"] = cuda_ms(lambda: kernels.trace_blend_fwd(
        *k3, False, 2, True), 10)
    res["geo_plain_ms"] = cuda_ms(lambda: trace_blend_torch(
        *k3, False, 2, True), 1)
    res["geo_bound"] = blend_bound(packed, int(bounds[-1]), 0, 12 * npix, ev,
                                   OPS_RAY_TERMS,
                                   extra_bytes=rays.numel() * 4)
    print(f"[kernels] trace_blend_fwd (geometry, A = 2) {res['geo_ms']:.4f} "
          f"ms, plain {res['geo_plain_ms']:.2f} ms, bound "
          f"{res['geo_bound'][0]:.4f} ms by {res['geo_bound'][1]} ({ev:.4g} "
          f"slot-ray pairs walked)", flush=True)
    chunk_spread("trace_blend_bwd (traced base)", bounds,
                 out[trace_rows(2)["last"]], tx, ty)
    g = torch.randn(out.shape, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    k4 = (packed, gidx, rays, bounds, out, g, tx, ty, 2)
    got, got_rays = kernels.trace_blend_bwd(*k4)
    want, want_rays = trace_blend_bwd_torch(*k4)
    cols = sum(bwd_slot_columns(2), [])
    err, rel = compare_columns("trace_blend_bwd (A = 2)", got, want, cols,
                               GRAD_RTOL)
    rel = max(rel, compare_columns_by_size("trace_blend_bwd (A = 2)", got,
                                           want, cols, GRAD_RTOL))
    per_row = lambda x: x[:, :6].transpose(0, 1).reshape(6, -1).T  # noqa: E731
    rerr, rrel = compare_columns("trace_blend_bwd (A = 2, rays)",
                                 per_row(got_rays), per_row(want_rays),
                                 list(range(6)), GRAD_RTOL)
    res["a2_err"], res["a2_rel"] = max(err, rerr), max(rel, rrel)
    res["a2_ms"] = cuda_ms(lambda: kernels.trace_blend_bwd(*k4), 10)
    res["a2_plain_ms"] = cuda_ms(lambda: trace_blend_bwd_torch(*k4), 1)
    res["a2_bound"] = blend_bound(
        packed, int(bounds[-1]), 2 * 15 * npix, 0, ev,
        OPS_RAY_TERMS + 2 * (len(cols) + 6),
        extra_bytes=(packed.numel() + 2 * rays.numel()) * 4)
    print(f"[kernels] trace_blend_bwd (A = 2, traced base) "
          f"{res['a2_ms']:.4f} ms, plain {res['a2_plain_ms']:.2f} ms, bound "
          f"{res['a2_bound'][0]:.4f} ms by {res['a2_bound'][1]}", flush=True)
    del k3, k4, out, g, got, want, got_rays, want_rays, packed, gidx, rays
    # the traced base's dropped slots reach no output of forward_envgs (as
    # in the JAX package): read them from trace_rays on the same inputs
    with torch.no_grad():
        t = tracer.trace_rays(scene, ray_o, ray_d,
                              torch.zeros(3, device="cuda"),
                              total_pair_cap=bcfg.pair_cap,
                              needs=(False, False))
        print(f"[traced] trace_rays on the base pass's inputs: "
              f"{int(t.num_pairs)} slots, {int(t.dropped_pairs)} dropped; "
              f"acc > 0.5 on {float((t.acc > 0.5).float().mean()):.1%} of "
              f"the rays", flush=True)
        if int(t.dropped_pairs):
            raise AssertionError("the traced base pass dropped slots")
        del t, scene, ray_o, ray_d
    res["traced_stage_ms"] = stage_ms([
        ("base_traced", lambda _: render_base_traced(
            base, cam, bcfg._replace(render_mode=True))),
        ("reflect", lambda b: reflect_rays(cam, b)),
        ("env_trace", lambda r: render_env(
            env, r[0], r[1], bcfg._replace(render_mode=True)))])
    print("[traced] render stage ms (median of 3, CUDA events): "
          + json.dumps(res["traced_stage_ms"]), flush=True)
    paths["traced_render"], paths["traced_train"], stats = traced_slice(
        "traced", kernels, base, env, cam, bcfg, batch,
        {"env_cull": 2, "trace_blend_fwd_geo": 1, "trace_blend_fwd": 1},
        {"env_cull": 2, "trace_blend_fwd": 2, "trace_blend_bwd": 2})
    if "pair_overflow" in stats:
        raise AssertionError("a traced base pass reports raster pairs")

    # ---- b. two bounces: K3 with the forward wet (A = 0 and 2) ----
    # the second bounce starts on the env dome and its tiles hold more
    # candidates than the reflected rays': a cap that drops none
    mcfg = cfg._replace(max_trace_depth=1, env_pair_cap=2 ** 23)
    for A in (0, 2):
        k3, dropped = bench.trace_inputs(
            *bench.bounce_scene(base, env, cam, mcfg, aux=A > 0),
            mcfg.env_pair_cap)
        packed, gidx, rays, bounds, tx, ty = k3
        out, wet = kernels.trace_blend_fwd(*k3, True, A, False, True)
        want, want_wet = trace_blend_torch(*k3, True, A, False, True)
        err = held(f"trace_blend_fwd (forward wet, A = {A})", out, want,
                   planes(A, True))
        werr = float((wet - want_wet).abs().max())
        # per splat, summed in float64: index_add_'s float32 atomics add in
        # another order on every call (the port's own per-splat sum)
        splat = lambda w: torch.zeros(  # noqa: E731
            packed.shape[0], dtype=torch.float64, device="cuda").index_add_(
                0, gidx.to(torch.int64), w.double())
        serr = float((splat(wet) - splat(want_wet)).abs().max())
        print(f"[kernels] trace_blend_fwd (forward wet, A = {A}) per-slot "
              f"wet max_abs_err {werr:.3g}, per-splat {serr:.3g} (bound "
              f"{KERNEL_ATOL:g}; wet up to {float(want_wet.max()):.4g}), "
              f"{int(bounds[-1])} slots, {int(dropped)} dropped", flush=True)
        if not max(werr, serr) <= KERNEL_ATOL or int(dropped):
            raise AssertionError("the forward wet disagrees with its plain "
                                 "version, or the cull dropped slots")
        ev = walked(out[trace_rows(A)["last"]])
        ms = cuda_ms(lambda: kernels.trace_blend_fwd(
            *k3, True, A, False, True), 10)
        plain_ms = cuda_ms(lambda: trace_blend_torch(
            *k3, True, A, False, True), 1)
        bound = blend_bound(packed, int(bounds[-1]), 0, (13 + A) * npix, ev,
                            OPS_RAY_TERMS, extra_bytes=rays.numel() * 4
                            + gidx.numel() * 4)
        print(f"[kernels] trace_blend_fwd (forward wet, A = {A}) {ms:.4f} "
              f"ms, plain {plain_ms:.2f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]} ({ev:.4g} slot-ray pairs walked)", flush=True)
        res[f"wet_a{A}"] = dict(err=max(err, werr, serr), ms=ms,
                                plain_ms=plain_ms, bound=bound)
        del k3, out, wet, want, want_wet, packed, gidx, rays
    # the rays the second bounce traces, and both bounces' dropped slots
    with torch.no_grad():
        scene, ref_o, ref_d = bench.bounce_scene(base, env, cam, mcfg)
        e = render_env(env, ref_o, ref_d, mcfg._replace(render_mode=True))
        _, mids = tracer.trace_rays_multibounce(
            scene, ref_o, ref_d, torch.zeros(3, device="cuda"),
            max_trace_depth=1, specular_threshold=mcfg.specular_threshold,
            total_pair_cap=mcfg.env_pair_cap)
        m0 = mids[0]
        mask1 = (m0.aux[..., 0] > mcfg.specular_threshold) & (m0.acc > 0.5)
        bounced = int(mask1.sum())
        # bounce 1's rays, as trace_rays_multibounce makes them
        n0 = m0.norm * torch.rsqrt(
            torch.sum(m0.norm * m0.norm, -1, keepdim=True) + 1e-12)
        d1 = ref_d - 2.0 * torch.sum(ref_d * n0, -1, keepdim=True) * n0
        o1 = ref_o + ref_d * m0.dpt[..., None]
        scene1, tmask1 = scene, mask1
        res["bounce_rays"] = bounced
        drops = [int(m.dropped_pairs) for m in mids]
        print(f"[bounce] bounce 1 traces {bounced} of {m0.acc.numel()} rays "
              f"(specular > {mcfg.specular_threshold:g} and acc > 0.5), "
              f"env slots per bounce {[int(m.num_pairs) for m in mids]}, "
              f"dropped {drops}; composite acc > 0.5 on "
              f"{float((e.acc > 0.5).float().mean()):.1%}", flush=True)
        if any(drops):
            raise AssertionError("a bounce dropped slots")
        del ref_o, ref_d, e, scene, mids, m0, n0, mask1
    res["bounce_stage_ms"] = stage_ms([
        ("base", lambda _: render_base(
            base, cam, mcfg._replace(render_mode=True))),
        ("reflect", lambda b: reflect_rays(cam, b)),
        ("env_two_bounces", lambda r: render_env(
            env, r[0], r[1], mcfg._replace(render_mode=True)))])
    print("[bounce] render stage ms (median of 3, CUDA events): "
          + json.dumps(res["bounce_stage_ms"]), flush=True)
    # the second bounce's backward on its own inputs: its rays run along
    # the env dome, T reaches the 1e-4 floor and rays take slots again in
    # later chunks, so the rebuilt T overflows in the kernel and in the
    # plain version (the JAX reverse loop) alike
    with torch.no_grad():
        k3b, _ = bench.trace_inputs(scene1, o1, d1, mcfg.env_pair_cap, tmask1)
        out = kernels.trace_blend_fwd(*k3b, True, 2)
        g = torch.zeros_like(out)
        g[:3] = 1.0  # the colour's cotangent alone
        r2 = trace_rows(2)
        bad_k = [int((~torch.isfinite(x)).sum())
                 for x in kernels.trace_blend_bwd(*k3b[:4], out, g,
                                                  *k3b[4:], 2)]
        bad_p = [int((~torch.isfinite(x)).sum())
                 for x in trace_blend_bwd_torch(*k3b[:4], out, g, *k3b[4:],
                                                2)]
        print(f"[bounce] fault probe, bounce 1's blend: final T down to "
              f"{float(out[r2['trans']].min()):.4g}, "
              f"{int((out[r2['last']] >= 64).sum())} rays taking slots past "
              f"their first chunk; non-finite (table, ray) gradient entries "
              f"of K4 {bad_k}, of its plain version {bad_p}", flush=True)
        del k3b, out, g, scene1, o1, d1, tmask1
    paths["bounce_render"], paths["bounce_train"], _ = traced_slice(
        "bounce", kernels, base, env, cam, mcfg, batch,
        {K1_RENDER: 1, "env_cull": 2, "trace_blend_fwd_wet": 2},
        {"fill_forward": 1, K1_TRAIN: 1, "raster_blend_bwd": 1,
         "env_cull": 2, "trace_blend_fwd_wet": 2, "trace_blend_bwd": 2},
        restart=True)
    del base, env, batch

    # ---- c. the committed golden scenes through the kernels ----
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    scenes = golden.golden_dirs(root)
    if not scenes:
        raise AssertionError(f"no golden scene under {root}")
    for scene_dir in scenes:
        thr = golden.scene_spec(scene_dir).get("psnr_threshold", 35.0)
        before = dict(kernels.LAUNCHES)
        psnr, rgb = golden.psnr_vs_golden(scene_dir, "cuda")
        rose = _rose(before, kernels)
        counts = dict(kernels.LAUNCHES)
        with plain_forward_blends(kernels):
            _, plain_rgb = golden.psnr_vs_golden(scene_dir, "cuda")
        kerr = float((rgb - plain_rgb).abs().max())
        cpu_psnr, cpu_rgb = golden.psnr_vs_golden(scene_dir, "cpu")
        diff = (rgb.cpu() - cpu_rgb).abs().amax(-1)
        off = (diff > SMALL_ATOL).nonzero().tolist()
        print(f"[golden] {os.path.basename(scene_dir)}: PSNR {psnr:.3f} dB "
              f"with the kernels (threshold {thr:g}; the CPU's plain "
              f"versions {cpu_psnr:.3f}); max abs against the plain blends "
              f"on the card's own inputs {kerr:.3g} (bound {KERNEL_ATOL:g}), "
              f"against the CPU render {float(diff.max()):.3g}, pixels past "
              f"{SMALL_ATOL:g}: {off} (at most {BRANCH_ROWS}, each within "
              f"{BRANCH_RTOL:g}); launches {rose}", flush=True)
        if not (psnr >= thr and kerr <= KERNEL_ATOL and rose
                and len(off) <= BRANCH_ROWS
                and float(diff.max()) <= BRANCH_RTOL):
            raise AssertionError(f"golden {scene_dir} off")
        kernels.LAUNCHES.update(counts)  # the plain renders launch nothing
    paths["golden"] = dict(kernels.LAUNCHES)
    return res, paths


def write_vgg_npz(path, seed=0):
    """A random VGG16 (seeded numpy, He-scaled so the taps keep their size)
    with the lin{i}_w calibration, in the npz layout ops/lpips.py and the
    JAX package read -> path. The repository holds no trained weights."""
    from envgs_tpu_torch.ops.lpips import _PLAN

    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for item in _PLAN:
        if item == "M":
            continue
        out[f"conv{i}_w"] = (rng.normal(size=(3, 3, cin, item))
                             * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        out[f"conv{i}_b"] = (rng.normal(size=item) * 0.05).astype(np.float32)
        cin, i = item, i + 1
    for j, c in enumerate((64, 128, 256, 512, 512)):
        out[f"lin{j}_w"] = rng.random(c).astype(np.float32)
    np.savez(path, **out)
    return path


def aux_step_run(kernels, vgg, card):
    """Phase 18a and c: the train bench scene's step with the shipped
    perceptual loss (0.01 past iteration 21000) on a random VGG16 and the
    aux depth loss (weight 1) on the scene's own rendered depth with 5%
    seeded noise (holes where acc < 0.5), once with each of smoothl1 and
    ssimse: 1 + AUX_STEPS steps each, K1-K5 once a step, finite loss and
    params, nothing dropped; then LPIPS alone, its ms and the card against
    the CPU. -> launch counts of the steps."""
    import functools

    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.envgs import forward_envgs
    from envgs_tpu_torch.ops.lpips import load_weights, lpips_pair
    from envgs_tpu_torch.train.aux_supervisors import AuxLossConfig
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import (
        init_train_state,
        make_train_step,
    )

    base, env, cam, cfg, batch = bench.make_train_scene("cuda")
    with torch.no_grad():
        out = forward_envgs(base, env, cam, bench.TRAIN_IT,
                            cfg._replace(render_mode=True))
    gen = torch.Generator(device="cuda").manual_seed(18)
    noisy = out.dpt_map * (1 + 0.05 * torch.randn(
        out.dpt_map.shape, generator=gen, device="cuda"))
    batch = batch._replace(dpt=torch.where(out.acc_map > 0.5, noisy,
                                           torch.zeros_like(noisy)))
    hole = float((batch.dpt == 0).float().mean())
    del out, noisy
    lp = functools.partial(lpips_pair, load_weights(vgg, "cuda"))
    loss_cfg = LossConfig()
    if not bench.TRAIN_IT > loss_cfg.perc_loss_start_iter:
        raise AssertionError("the bench iteration is before the perceptual "
                             "loss's start")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    sps = {}
    for kind in ("smoothl1", "ssimse"):
        step = make_train_step(
            cam, cfg, loss_cfg, LRConfig(), LRConfig(), has_norm=True,
            lpips_fn=lp, aux_cfg=AuxLossConfig(dpt_loss_weight=1.0,
                                               dpt_loss_kind=kind))
        state = init_train_state(base, env)
        for i in range(AUX_STEPS + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = dict(kernels.LAUNCHES)
            state, stats = step(state, batch, cam.K, cam.R, cam.T,
                                bench.TRAIN_IT)
            rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            loss = float(stats["loss"])
            of, dr = int(stats["pair_overflow"]), int(stats["trace_dropped"])
            if any(v != (k in TRAIN_KERNELS) for k, v in rose.items()):
                raise AssertionError(f"aux step {kind} {i}: launches {rose}")
            if not ({"aux_dpt_loss", "perc_loss"} <= set(stats)
                    and np.isfinite(loss) and not of and not dr):
                raise AssertionError(f"aux step {kind} {i}: loss {loss}, "
                                     f"stats {sorted(stats)}, overflow {of},"
                                     f" dropped {dr}")
            if i in (0, AUX_STEPS):
                print(f"[aux] {kind} step {i}: loss {loss:.6f}, aux_dpt_loss "
                      f"{float(stats['aux_dpt_loss']):.6f}, perc_loss "
                      f"{float(stats['perc_loss']):.6f}, psnr "
                      f"{float(stats['psnr']):.4f}, launches "
                      f"{ {k: v for k, v in rose.items() if v} }", flush=True)
        torch.cuda.synchronize()
        sps[kind] = AUX_STEPS / (time.perf_counter() - t0)
        for pool in (state.base, state.env):
            for name, p in zip(pool.params._fields, pool.params):
                if p is not None and not bool(torch.isfinite(p).all()):
                    raise AssertionError(f"aux {kind}: non-finite {name}")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = bench.train_stage_times(step, state, batch, cam, reps=3)
    x = batch.rgb.clone().requires_grad_(True)
    y = torch.clamp(batch.rgb + 0.1 * torch.randn(
        batch.rgb.shape, generator=gen, device="cuda"), 0, 1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: lp(x, y), 5)
    both_ms = cuda_ms(lambda: torch.autograd.grad(lp(x, y), x), 5)
    print(f"[aux] train bench scene ({cam.W}x{cam.H}, it={bench.TRAIN_IT}) "
          f"with the perceptual loss (weight {loss_cfg.perc_loss_weight}, "
          f"random VGG16) and the aux depth loss on its rendered depth "
          f"({hole:.3f} of the pixels holes): {AUX_STEPS} steps after a "
          f"warm-up, each launching K1-K5 once, nothing dropped, params "
          f"finite; steps/s smoothl1 {sps['smoothl1']:.4f}, ssimse "
          f"{sps['ssimse']:.4f}; stage ms (ssimse, median of 3, CUDA events) "
          + json.dumps({k: round(v, 3) for k, v in stages.items()})
          + f"; LPIPS of the {cam.W}x{cam.H} pair forward {fwd_ms:.3f} ms, "
          f"forward + backward {both_ms:.3f} ms; peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    with torch.no_grad():
        got = float(lp(x, y))
        t0 = time.perf_counter()
        want = float(lpips_pair(load_weights(vgg, "cpu"), x.detach().cpu(),
                                y.cpu()))
        cpu_s = time.perf_counter() - t0
    rel = abs(got - want) / abs(want)
    print(f"[aux] LPIPS of the {cam.W}x{cam.H} pair: card {got:.7g}, CPU "
          f"{want:.7g} ({cpu_s:.1f} s), relative {rel:.3g} (bound "
          f"{LPIPS_RTOL:g})", flush=True)
    if not rel <= LPIPS_RTOL:
        raise AssertionError(f"LPIPS card {got} vs CPU {want}")
    return launches


def mesh_run(kernels, make_runner, smoke_dir, card):
    """Phase 18d: Runner.extract_mesh(res=MESH_RES) at its default
    acc_thresh from a runner resumed from phase 14's checkpoint taken
    before its last opacity reset, K1 and K3 once per fused view and nothing
    else, each stage timed, the TSDF and weights against the CPU's from
    the same depths; then `mesh -c smoke.yaml --mesh-res 128` from phase
    15's smoke checkpoint in `smoke_dir`. -> (launch counts of each)."""
    from envgs_tpu_torch import cli
    from envgs_tpu_torch.utils import fusion

    runner = make_runner(True, exp="run_dense")
    ms, seen, per_view = {}, {}, []
    orig = {k: getattr(fusion, k) for k in ("tsdf_fuse",
                                            "marching_tetrahedra",
                                            "save_mesh_ply")}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            if name == "tsdf_fuse":
                seen.update(args=args, kw=kw, out=res)
            return res
        return run

    render_view = runner.render_view

    def counted_render(*args, **kw):
        before = dict(kernels.LAUNCHES)
        out = timed("render", render_view)(*args, **kw)
        per_view.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        return out

    runner.render_view = counted_render
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    try:
        for name, fn in orig.items():
            setattr(fusion, name, timed(name, fn))
        t0 = time.perf_counter()
        path = runner.extract_mesh(res=MESH_RES)
        total_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in orig.items():
            setattr(fusion, name, fn)
    launches = dict(kernels.LAUNCHES)
    want = {k: int(k in RENDER_KERNELS) for k in launches}
    if len(per_view) != len(runner.views) or any(v != want for v in per_view):
        raise AssertionError(f"mesh renders: launches {per_view}")
    if launches != {k: len(per_view) * v for k, v in want.items()}:
        raise AssertionError(f"mesh: launches {launches}")
    verts, faces = fusion.load_mesh_ply(path)
    if not (len(faces) and np.isfinite(verts).all()):
        raise AssertionError(f"mesh: {len(verts)} verts, {len(faces)} faces")
    depths, cams, bounds = seen["args"]
    tsdf, w = seen["out"]
    cpu_cams = [c._replace(K=c.K.cpu(), R=c.R.cpu(), T=c.T.cpu())
                for c in cams]
    t0 = time.perf_counter()
    tsdf_c, w_c = orig["tsdf_fuse"](depths.cpu(), cpu_cams, bounds,
                                    **seen["kw"])
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name, g, c in (("tsdf", tsdf, tsdf_c), ("weights", w, w_c)):
        span = float(c.max() - c.min())
        errs[name] = float((g.cpu() - c).abs().max()) / max(span, 1e-30)
    obs = int((w > 0).sum())
    print(f"[mesh] extract_mesh(res={MESH_RES}, acc_thresh=0.5) of the run "
          f"scene resumed at iteration "
          f"{runner.start_iter}: {len(per_view)} views "
          f"({cams[0].W}x{cams[0].H}) each launching K1 and K3 once, "
          f"{obs} observed voxels of {MESH_RES ** 3}; {len(verts)} verts / "
          f"{len(faces)} faces; ms: renders {sum(ms['render']):.1f} ("
          f"{statistics.median(ms['render']):.1f} a view), fuse "
          f"{ms['tsdf_fuse'][0]:.1f}, extraction "
          f"{ms['marching_tetrahedra'][0]:.1f}, ply "
          f"{ms['save_mesh_ply'][0]:.1f}, in all {total_ms:.1f}; the TSDF "
          f"against the CPU's from the same depths ({cpu_s:.1f} s there): "
          f"max|d| / range {errs['tsdf']:.3g}, weights {errs['weights']:.3g}"
          f" (bound {TSDF_RTOL:g}) [{card}]", flush=True)
    if not max(errs.values()) <= TSDF_RTOL:
        raise AssertionError(f"mesh TSDF card vs CPU: {errs}")
    del runner, seen, tsdf, w, tsdf_c, w_c, depths

    cwd = os.getcwd()
    os.chdir(smoke_dir)
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        out = cli.main(["mesh", "-c", "smoke.yaml", "--mesh-res", "128"])
        cli_s = time.perf_counter() - t0
        cli_launches = dict(kernels.LAUNCHES)
        verts, faces = fusion.load_mesh_ply(out)
    finally:
        os.chdir(cwd)
    n = cli_launches[RENDER_KERNELS[0]]
    if not (n and all(cli_launches[k] == (n if k in RENDER_KERNELS else 0)
                      for k in cli_launches)):
        raise AssertionError(f"cli mesh: launches {cli_launches}")
    if not (len(faces) and np.isfinite(verts).all()):
        raise AssertionError(f"cli mesh: {len(faces)} faces")
    print(f"[mesh] cli: mesh -c smoke.yaml --mesh-res 128 from the smoke "
          f"checkpoint in {cli_s:.1f} s (the synthetic scene built first): "
          f"{len(verts)} verts / {len(faces)} faces in {out}; launches "
          f"{ {k: v for k, v in cli_launches.items() if v} } [{card}]",
          flush=True)
    return launches, cli_launches


def scene_run(kernels, card):
    """Phase 18e: make_scene's default capture (12 views of 128x128)
    through the reference renderers on the card: ms per view, no kernel
    launched (the oracles are plain PyTorch), the capture in view."""
    from envgs_tpu_torch.data.synthetic import make_scene

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = make_scene()
    ms = (time.perf_counter() - t0) * 1e3 / len(scene.cams)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"make_scene launched {kernels.LAUNCHES}")
    cover = [float(m.mean()) for m in scene.masks]
    if not (all(np.isfinite(i).all() for i in scene.images)
            and 0.05 < min(cover) and max(cover) < 1.0):
        raise AssertionError(f"make_scene: masks cover {cover}")
    print(f"[scene] make_scene(): {len(scene.cams)} views of "
          f"{scene.cams[0].W}x{scene.cams[0].H} through the reference "
          f"renderers in {ms:.1f} ms a view, no kernel launched, masks cover "
          f"{min(cover):.3f}-{max(cover):.3f} [{card}]", flush=True)


# ---- phase 19: the other gauss3d families (STGS, PointPlanes) ----

STGS_YAML = "configs/exps/stgs_synthetic.yaml"
PP_YAML = "configs/exps/point_planes_synthetic.yaml"
STGS_TIMES = (0.2, 0.4, 0.6, 0.8)  # phase 19b: the teacher's renders
PP_POINTS = 2 ** 18  # phase 19c: points, frames at the train scene's size
PP_FRAMES = 8
PP_LR = 5e-3  # the JAX package's default learning rate
VIDEO_VIEWS = 8  # phase 19d: the video capture's cameras and frames
VIDEO_FRAMES = 8


def small_stgs(device, sh_degree_t):
    """Phase 19a's scene: 300 Gaussians in a pool of 512 seen at 64x64,
    from one numpy-made mid-run state (SH degree 1 active, anisotropic
    scales, temporal centers in [0, 1], temporal scales 0.2-0.6, motions of
    ~0.3, Adam moments at step 10) -> (state, cam, cfg, target)."""
    from envgs_tpu_torch.models import stgs as S
    from envgs_tpu_torch.models.gaussians import GaussianParams
    from envgs_tpu_torch.train.optimizer import AdamState
    from envgs_tpu_torch.utils.camera import make_camera

    rng = np.random.default_rng(19 + sh_degree_t)
    P, cap, H, W, f = 300, 512, 64, 64, 70.0
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    cfg = S.STGSConfig(sh_degree=3, sh_degree_t=sh_degree_t,
                       pair_cap=2 ** 15)
    pool = S.init_stgs_pool(xyz, rng.random(P).astype(np.float32),
                            rng.random((P, 3)).astype(np.float32), cap, cfg,
                            device=device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    p = pool.params
    act = np.arange(cap)[:, None] < P
    pool = pool._replace(
        params=p._replace(
            scaling=t(np.log(rng.uniform(0.01, 0.06, (cap, 3)))),
            features_rest=t(rng.normal(size=p.features_rest.shape) * 0.2),
            opacity=t(rng.normal(size=(cap, 1)) + 1.0),
            scaling_t=t(np.log(rng.uniform(0.2, 0.6, (cap, 1)))),
            motion=t(np.where(act, rng.normal(size=(cap, 3)) * 0.3, 0.0))),
        stats=pool.stats._replace(
            sh_degree=torch.tensor(1, dtype=torch.int32, device=device)))
    opt = AdamState(
        GaussianParams(*(t(rng.normal(size=x.shape) * 1e-3) for x in p
                         if x is not None)),
        GaussianParams(*(t(rng.random(x.shape) * 1e-5 + 1e-6) for x in p
                         if x is not None)),
        torch.tensor(10, dtype=torch.int32, device=device))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    return S.STGSState(pool, opt), cam, cfg, t(rng.random((H, W, 3)))


def run_small_stgs(device, sh_degree_t):
    """Phase 19a's render at t = 0.45 and one train step (iteration 700) on
    one device -> (render, start, new state (numpy dicts), aux, gradients
    as numpy)."""
    from envgs_tpu_torch.models import stgs as S

    state, cam, cfg, target = small_stgs(device, sh_degree_t)
    with torch.no_grad():
        out = S.render_stgs(state.pool, cam, 0.45, cfg)
    grads = {}
    new, aux = S.make_stgs_train_step(cfg, cam, S.stgs_lr_config())(
        state, cam.K, cam.R, cam.T, 0.45, target, 700, grads_out=grads)
    g = {k: v.detach().cpu().numpy()
         for k, v in grads["params"]._asdict().items() if v is not None}
    return (out, S.stgs_state_to_numpy(state), S.stgs_state_to_numpy(new),
            aux, g)


def maintain_small_stgs(src: dict, device, eps):
    """stgs_maintenance (the weight-quantile split on) then reset_t of the
    numpy state `src` on one device with the split draws `eps` -> the
    state as a numpy dict."""
    from envgs_tpu_torch.models import stgs as S
    from envgs_tpu_torch.models.gaussians import DensifyConfig

    state = S.stgs_maintenance(
        S.stgs_state_from_numpy(src, device),
        DensifyConfig(spatial_scale=1.0, min_weight_threshold=0.3),
        eps=[e.to(device) for e in eps])
    pool, opt = S.reset_t(state.pool, state.opt, 0.0, 0.9)
    return S.stgs_state_to_numpy(S.STGSState(pool, opt))


def compare_small_stgs(got, want, g_dens, w_dens):
    """Phase 19a's checks of the CUDA run against the CPU run at phase
    10's bounds -> the worst error of each kind."""
    g_out, start, g_new, g_aux, g_grads = got
    w_out, _, w_new, w_aux, w_grads = want
    worst = {}
    for k in ("rgb", "depth", "alpha", "trans"):
        worst[f"render {k}"] = float(
            (getattr(g_out, k).cpu() - getattr(w_out, k)).abs().max())
        if not worst[f"render {k}"] <= SMALL_ATOL:
            raise AssertionError(f"small STGS render {k}: {worst}")
    if not torch.equal(g_out.radii.cpu(), w_out.radii):
        raise AssertionError("small STGS render: radii differ")
    worst["render wet"] = rel_err(g_out.wet.cpu(), w_out.wet)
    worst["step loss"] = abs(float(g_aux["loss"]) - float(w_aux["loss"])) / \
        abs(float(w_aux["loss"]))
    if not worst["step loss"] <= LOSS_RTOL:
        raise AssertionError(f"small STGS step loss: {worst}")
    if int(g_aux["pair_overflow"]) or int(w_aux["pair_overflow"]):
        raise AssertionError("small STGS step: pairs over the cap")
    for k, w in w_grads.items():
        if k in ("specular", "roughness"):
            if g_grads[k].any() or w.any():
                raise AssertionError(f"small STGS: a gradient of {k}")
            continue
        if not np.abs(w).max() > 0:
            raise AssertionError(f"small STGS: no gradient of {k}")
        worst[f"grad {k}"] = rel_err(torch.tensor(g_grads[k]),
                                     torch.tensor(w))
    for grp in ("params", "mu", "nu"):
        for k, w in w_new[grp].items():
            worst[f"{grp} {k}"] = rel_err(
                torch.tensor(g_new[grp][k] - start[grp][k]),
                torch.tensor(w - start[grp][k]))
    gs, ws = g_new["stats"], w_new["stats"]
    for k in ("active", "denom", "max_radii2d", "sh_degree"):
        if not np.array_equal(gs[k], ws[k]):
            raise AssertionError(f"small STGS step: stats {k} differ")
    for k in ("grad_accum", "weight_accum"):
        worst[k] = rel_err(torch.tensor(gs[k]), torch.tensor(ws[k]))
    for k, v in worst.items():
        if not k.startswith(("render", "step")) and not v <= STEP_RTOL:
            raise AssertionError(f"small STGS step {k}: {v}")
    if not worst["render wet"] <= STEP_RTOL:
        raise AssertionError(f"small STGS render wet: {worst['render wet']}")
    for k, w in w_dens["stats"].items():
        if not np.array_equal(g_dens["stats"][k], w):
            raise AssertionError(f"small STGS maintenance: stats {k} differ")
    for grp in ("params", "mu", "nu"):
        for k, w in w_dens[grp].items():
            worst[f"maintenance {grp} {k}"] = rel_err(
                torch.tensor(g_dens[grp][k]), torch.tensor(w))
            if not worst[f"maintenance {grp} {k}"] <= DENSIFY_RTOL:
                raise AssertionError(f"small STGS maintenance {grp} {k}")
    born = int((w_dens["stats"]["active"]
                & ~w_new["stats"]["active"]).sum())
    if born < 5 or w_dens["params"]["t"].max() > 0.9:
        raise AssertionError(f"small STGS maintenance: {born} children, "
                             f"t up to {w_dens['params']['t'].max()}")
    worst["maintenance children"] = born
    return worst


def _launch_check(kernels, want, what):
    """A context for one call: the launches it adds must be exactly one of
    each kernel in `want` and none of the others -> {name: count}."""
    @contextlib.contextmanager
    def ctx():
        before = dict(kernels.LAUNCHES)
        rose = {}
        yield rose
        rose.update({k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]})
        if rose != {k: 1 for k in want}:
            raise AssertionError(f"{what}: launches {rose}")
    return ctx()


def marked_stages(one, reps=3) -> dict:
    """Median device ms of a step's stages over `reps` calls of one(mark)
    (a step that calls mark("forward"), mark("backward"),
    mark("optimizer")), from CUDA events recorded between them."""
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[-1].append((name, e))

    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        marks.append([("start", e0)])
        one(mark)
    torch.cuda.synchronize()
    stage = {}
    for run in marks:
        for (_, a), (name, b) in zip(run, run[1:]):
            stage.setdefault(name, []).append(a.elapsed_time(b))
        stage.setdefault("step", []).append(
            run[0][1].elapsed_time(run[-1][1]))
    return {k: round(statistics.median(v), 3) for k, v in stage.items()}


def stgs_full(kernels, card):
    """Phase 19b: the 3DGS bench scene's 500K Gaussians as Spacetime
    Gaussians (times uniform in [0, 1], temporal scale 0.1414, motions
    N(0, 0.05^2)): renders of this teacher at STGS_TIMES as the targets,
    then from the same pool with its motion zeroed: renders, 1 + 10 steps,
    the stage ms of 3 more, one maintenance at a densify step and reset_t,
    3 more steps. -> {path: launch counts}."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models import stgs as S
    from envgs_tpu_torch.models.gaussians import DensifyConfig

    t0 = time.perf_counter()
    gstate, cam, gcfg, _, _ = bench.make_gaussiant_scene("cuda")
    pool = gstate.pool
    cap = pool.cap
    rng = np.random.default_rng(19)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device="cuda")

    teacher = pool._replace(params=pool.params._replace(
        t=f32(rng.random((cap, 1))),
        scaling_t=f32(np.full((cap, 1), np.log(0.1414))),
        motion=f32(rng.normal(0.0, 0.05, (cap, 3)))))
    del gstate, pool
    cfg = S.STGSConfig(sh_degree=3, pair_cap=gcfg.pair_cap)
    with torch.no_grad():
        targets = [S.render_stgs(teacher, cam, tt, cfg).rgb
                   for tt in STGS_TIMES]
    start = teacher._replace(params=teacher.params._replace(
        motion=torch.zeros_like(teacher.params.motion)))
    del teacher
    state = S.init_stgs_state(start)
    n_act = int(start.stats.active.sum())
    print(f"[stgs] bench scene as STGS: {n_act} Gaussians in {cap} slots, "
          f"{cam.W}x{cam.H}, targets at t = {STGS_TIMES}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for i, tt in enumerate((0.3, 0.5, 0.7)):
        with _launch_check(kernels, GAUSSIANT_RENDER_KERNELS,
                           f"STGS render {i}") as rose:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                out = S.render_stgs(state.pool, cam, tt, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        n_pairs = int(out.num_pairs)
        if n_pairs > cfg.pair_cap or not bool(torch.isfinite(out.rgb).all()):
            raise AssertionError(f"STGS render {i}: {n_pairs} pairs")
        print(f"[stgs] render t={tt}: {ms:.1f} ms, pairs {n_pairs}/"
              f"{cfg.pair_cap}, rgb std {float(out.rgb.std()):.4f}, launches "
              f"{rose}", flush=True)
    del out
    with torch.no_grad():
        S.render_stgs(state.pool, cam, 0.5, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(10):
            S.render_stgs(state.pool, cam, 0.3 + 0.04 * i, cfg)
        torch.cuda.synchronize()
    fps = 10 / (time.perf_counter() - t1)
    print(f"[stgs] render fps over 10 renders: {fps:.3f}", flush=True)
    paths = {"stgs_render": dict(kernels.LAUNCHES)}

    step = S.make_stgs_train_step(cfg, cam, S.stgs_lr_config())
    it = [600]

    def steps(state, n, what, timed=False, grads=None):
        t1 = None
        for i in range(n):
            if timed and i == 1:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            j = it[0] % len(STGS_TIMES)
            with _launch_check(kernels, GAUSSIANT_TRAIN_KERNELS,
                               f"STGS {what} step {i}") as rose:
                state, aux = step(state, cam.K, cam.R, cam.T, STGS_TIMES[j],
                                  targets[j], it[0],
                                  grads_out=grads if i == 0 else None)
            it[0] += 1
            loss, of = float(aux["loss"]), int(aux["pair_overflow"])
            if i in (0, 1, n - 1):
                print(f"[stgs] {what} step {i}: loss {loss:.6f}, active "
                      f"{int(aux['n_active'])}, pair_overflow {of}, launches "
                      f"{rose}", flush=True)
            if not np.isfinite(loss) or of:
                raise AssertionError(f"STGS {what} step {i}: loss {loss}, "
                                     f"pair_overflow {of}")
        torch.cuda.synchronize()
        return state, ((n - 1) / (time.perf_counter() - t1) if timed
                       else None)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    grads = {}
    state, sps = steps(state, 11, "train", timed=True, grads=grads)
    g = grads["params"]
    moved = (g.xyz != 0).any(-1)
    live = (g.motion != 0).any(-1)
    print(f"[stgs] train steps/s over 10 steps: {sps:.4f} ({1e3 / sps:.1f} "
          f"ms per step); the first step's gradients: {int(moved.sum())} "
          f"Gaussians with a position gradient, {int(live.sum())} with a "
          f"motion gradient, {int((g.t != 0).any(-1).sum())} with a t "
          f"gradient, {int((g.scaling_t != 0).any(-1).sum())} with a "
          "scaling_t gradient", flush=True)
    if not int(live.sum()) >= 0.99 * int(moved.sum()) > 1000:
        raise AssertionError("STGS: the motion gradients are not live")
    for name, p in state.pool.params._asdict().items():
        if p is not None and not bool(torch.isfinite(p).all()):
            raise AssertionError(f"STGS: non-finite {name}")
    def one(mark):
        nonlocal state
        j = it[0] % len(STGS_TIMES)
        state, _ = step(state, cam.K, cam.R, cam.T, STGS_TIMES[j], targets[j],
                        it[0], mark=mark)
        it[0] += 1

    print(f"[stgs] step stage device ms (median of 3, CUDA events): "
          f"{json.dumps(marked_stages(one))}", flush=True)
    n0 = int(state.pool.stats.active.sum())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = S.stgs_maintenance(state, DensifyConfig(spatial_scale=1.0,
                                                    max_gs=cap),
                               torch.Generator(device="cuda").manual_seed(0))
    pool, opt = S.reset_t(state.pool, state.opt, 0.0, 1.0)
    state = S.STGSState(pool, opt)
    torch.cuda.synchronize()
    m_ms = (time.perf_counter() - t1) * 1e3
    print(f"[stgs] stgs_maintenance + reset_t: {m_ms:.1f} ms, active {n0} -> "
          f"{int(state.pool.stats.active.sum())} of {cap}, t in "
          f"[{float(state.pool.params.t.min()):.3f}, "
          f"{float(state.pool.params.t.max()):.3f}]", flush=True)
    state, _ = steps(state, 3, "after maintenance")
    for name, p in state.pool.params._asdict().items():
        if p is not None and not bool(torch.isfinite(p).all()):
            raise AssertionError(f"STGS: non-finite {name} after maintenance")
    paths["stgs_train"] = dict(kernels.LAUNCHES)
    print(f"[stgs] params finite; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})",
          flush=True)
    return paths


def _ring_cams(n, H, W, f, radius, device, height=0.0):
    """n cameras on a ring of `radius` about the origin, looking at it, as
    (K, R, T) numpy triples and Cameras on `device`."""
    from envgs_tpu_torch.utils.camera import make_camera

    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c = np.array([radius * np.sin(a), height, -radius * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z]).astype(np.float32)
        T = (-R @ c).astype(np.float32)
        out.append((K, R, T, make_camera(H, W, K, R, T, 0.02, 100.0,
                                         device=device)))
    return out


def small_point_planes(device, d=None):
    """Phase 19c's small step on one device: 2048 points at 64x64, the
    weights numpy-made (or `d`, JAX's parameter dict) -> (loss, gradients,
    the weights and moments after the step, the weights before) as numpy."""
    from envgs_tpu_torch.models import point_planes as PP

    cfg = PP.PointPlanesConfig(pair_cap=2 ** 16)
    if d is None:
        rng = np.random.default_rng(23)
        model = cfg.init(rng.uniform(-1, 1, (2048, 3)).astype(np.float32),
                         torch.Generator().manual_seed(23))
        d = PP.point_planes_params_to_jax(model)
    model = PP.point_planes_params_from_jax(d, cfg, device)
    _, _, _, cam = _ring_cams(1, 64, 64, 60.0, 2.5, device)[0]
    target = torch.tensor(np.random.default_rng(24).random(
        (64, 64, 3)).astype(np.float32), device=device)
    _, step = PP.make_point_planes_train_step(cfg, cam, PP_LR)
    grads = {}
    state, aux = step(model, PP.adam_init(model), 0.5, cam.K, cam.R, cam.T,
                      target, grads_out=grads)
    host = lambda xs: [x.detach().cpu().numpy() for x in xs]  # noqa: E731
    return (float(aux["loss"]), host(grads["grads"]),
            host(PP.flat_params(model) + state.mu + state.nu), d)


def compare_small_point_planes(got, want):
    """Phase 19c's small step, the card against the CPU: the loss, each
    gradient leaf (max|d| / max|ref|), and Adam held apart: the CPU's
    adam_update from the start on the card's gradients gives the card's
    weights and moments within ADAM_RTOL of each array's largest change,
    past one float32 rounding of the array's values (a weight of ~1 moved
    by ~lr = 5e-3 holds its new value to 2^-23 of 1: 2.4e-5 of the move)."""
    from envgs_tpu_torch.models import point_planes as PP

    worst = {"loss": abs(got[0] - want[0]) / abs(want[0])}
    worst["grads"] = max(rel_err(torch.tensor(g), torch.tensor(w))
                         for g, w in zip(got[1], want[1]) if np.abs(w).any())
    model = PP.point_planes_params_from_jax(want[3], PP.PointPlanesConfig())
    start = [p.detach().clone() for p in PP.flat_params(model)]
    state = PP.adam_update(PP.flat_params(model),
                           [torch.tensor(g) for g in got[1]],
                           PP.adam_init(model), PP_LR)
    mine = PP.flat_params(model) + state.mu + state.nu
    zeros = [torch.zeros_like(x) for x in state.mu + state.nu]
    worst["adam"] = 0.0
    for g, m, s0 in zip(got[2], mine, start + zeros):
        m = m.detach()
        d = float((torch.tensor(g) - m).abs().max())
        past = max(d - 2.0 ** -23 * float(m.abs().max()), 0.0)
        worst["adam"] = max(worst["adam"],
                            past / max(float((m - s0).abs().max()), 1e-30))
    if not (worst["loss"] <= LOSS_RTOL and worst["grads"] <= STEP_RTOL
            and worst["adam"] <= ADAM_RTOL):
        raise AssertionError(f"small PointPlanes: {worst}")
    return worst


def point_planes_full(kernels, card):
    """Phase 19c: PointPlanes with the JAX defaults (feat_width 64, K-Planes
    8 features at 16 and 32, SH degree 2) on PP_POINTS points in its
    bounds, PP_FRAMES frames at the train scene's 1558x1038 rendered by a
    teacher of other weights; a pair cap no step overflows; 1 + 10 steps;
    a small step CUDA against CPU from one set of weights."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models import point_planes as PP

    H, W = bench.TRAIN_H, bench.TRAIN_W
    rng = np.random.default_rng(29)
    pts = rng.uniform(-1, 1, (PP_POINTS, 3)).astype(np.float32)
    cfg = PP.PointPlanesConfig(pair_cap=2 ** 24)
    _, _, _, cam = _ring_cams(1, H, W, 0.6 * W, 2.5, "cuda", 0.4)[0]
    teacher = cfg.init(pts, torch.Generator(device="cuda").manual_seed(1),
                       "cuda")
    with torch.no_grad():  # the teacher moves: its displacement head is live
        teacher.resd.weights[-1].normal_(0.0, 0.05, generator=torch.Generator(
            device="cuda").manual_seed(2))
        outs = [PP.point_planes_forward(cfg, teacher, i / (PP_FRAMES - 1),
                                        cam) for i in range(PP_FRAMES)]
    most = max(int(o.num_pairs) for o in outs)
    pair_cap = max(2 ** 20, 1 << int(np.ceil(np.log2(2 * most))))
    targets = [o.rgb for o in outs]
    del outs, teacher
    cfg = cfg._replace(pair_cap=pair_cap)
    print(f"[point_planes] {PP_POINTS} points, {PP_FRAMES} frames at {W}x{H},"
          f" the teacher's renders take up to {most} pairs: pair_cap "
          f"{pair_cap}; target std {float(targets[0].std()):.4f}",
          flush=True)
    init, step = PP.make_point_planes_train_step(cfg, cam, PP_LR)
    model, opt = init(pts, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = None
    for i in range(11):
        if i == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        j = i % PP_FRAMES
        with _launch_check(kernels, GAUSSIANT_TRAIN_KERNELS,
                           f"PointPlanes step {i}") as rose:
            opt, aux = step(model, opt, j / (PP_FRAMES - 1), cam.K, cam.R,
                            cam.T, targets[j])
        loss, of = float(aux["loss"]), int(aux["pair_overflow"])
        if i in (0, 1, 10):
            print(f"[point_planes] step {i}: loss {loss:.6f}, psnr "
                  f"{float(aux['psnr']):.3f}, pair_overflow {of}, launches "
                  f"{rose}", flush=True)
        if not np.isfinite(loss) or of:
            raise AssertionError(f"PointPlanes step {i}: {loss}, {of}")
    torch.cuda.synchronize()
    sps = 10 / (time.perf_counter() - t1)
    for p in PP.flat_params(model):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("PointPlanes: non-finite weights")
    print(f"[point_planes] train steps/s over 10 steps: {sps:.4f} "
          f"({1e3 / sps:.1f} ms per step); weights finite; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card})", flush=True)

    def one(mark):
        nonlocal opt
        opt, _ = step(model, opt, 0.5, cam.K, cam.R, cam.T, targets[3],
                      mark=mark)

    print(f"[point_planes] step stage device ms (median of 3, CUDA events): "
          f"{json.dumps(marked_stages(one))}", flush=True)
    paths = {"point_planes_train": dict(kernels.LAUNCHES)}
    del model, opt, targets
    want = small_point_planes("cpu")
    worst = compare_small_point_planes(small_point_planes("cuda", want[3]),
                                       want)
    print(f"[point_planes] small step (2048 points, 64x64) cuda vs cpu: loss "
          f"rel {worst['loss']:.3g} (bound {LOSS_RTOL:g}), gradients "
          f"{worst['grads']:.3g} of each leaf's largest (bound "
          f"{STEP_RTOL:g}); the CPU's Adam on the card's gradients "
          f"{worst['adam']:.3g} of each array's largest change past one "
          f"float32 rounding of its values (bound {ADAM_RTOL:g})",
          flush=True)
    return paths


def family_step_probe(module, name, kernels, log, tuple_out=False,
                      crash_at=None):
    """Wrap module.<name> (make_stgs_train_step or
    make_point_planes_train_step) so that every step's launches, loss and
    pair overflow (and the STGS step's iteration) are appended to `log`;
    the STGS step of iteration `crash_at` raises KeyboardInterrupt after it
    ran (a kill). -> the original, to put back."""
    make = getattr(module, name)

    def made(*a, **kw):
        out = make(*a, **kw)
        step = out[1] if tuple_out else out

        def counted(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            res = step(*args, **kwargs)
            aux = res[-1]
            log.append(dict(
                rose={k: kernels.LAUNCHES[k] - before[k] for k in before
                      if kernels.LAUNCHES[k] != before[k]},
                loss=float(aux["loss"]), overflow=int(aux["pair_overflow"]),
                it=None if tuple_out else int(args[6])))
            if crash_at is not None and log[-1]["it"] == crash_at:
                raise KeyboardInterrupt("killed")
            return res
        return (out[0], counted) if tuple_out else counted

    setattr(module, name, made)
    return make



def check_family_run(what, log, n_steps, launches, n_eval):
    """Every step of a family run launched K5, gauss3d K1 and K2 and the
    projection's two kernels once, with a finite loss and no pair over the
    cap; the run's launches are the steps' plus K5, gauss3d K1 and the
    projection's forward once per held-out render."""
    if len(log) != n_steps:
        raise AssertionError(f"{what}: {len(log)} steps, not {n_steps}")
    for i, s in enumerate(log):
        if s["rose"] != {k: 1 for k in GAUSSIANT_TRAIN_KERNELS}:
            raise AssertionError(f"{what} step {i}: launches {s['rose']}")
        if not np.isfinite(s["loss"]) or s["overflow"]:
            raise AssertionError(f"{what} step {i}: {s}")
    want = {"fill_forward": n_steps + n_eval,
            "raster_blend_fwd_gauss3d": n_steps + n_eval,
            "raster_blend_bwd_gauss3d": n_steps,
            "project3d_fwd": n_steps + n_eval, "project3d_bwd": n_steps}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, not {want}")


def write_video_capture(root, n_views=VIDEO_VIEWS, n_frames=VIDEO_FRAMES):
    """A multi-view video capture at the train scene's 1558x1038: a
    PointPlanes teacher of PP_POINTS points (moving: its displacement head
    drawn) rendered on the card from n_views cameras on a ring at n_frames
    times, as images/<cam>/<frame>.jpg, intri.yml / extri.yml and the
    points as points3D.ply -> seconds."""
    import cv2

    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models import point_planes as PP
    from envgs_tpu_torch.utils.easycam import write_cameras
    from envgs_tpu_torch.utils.ply import save_sfm_ply

    t0 = time.perf_counter()
    H, W = bench.TRAIN_H, bench.TRAIN_W
    rng = np.random.default_rng(31)
    pts = rng.uniform(-1, 1, (PP_POINTS, 3)).astype(np.float32)
    cfg = PP.PointPlanesConfig(n_frames=n_frames, pair_cap=2 ** 24)
    teacher = cfg.init(pts, torch.Generator(device="cuda").manual_seed(3),
                       "cuda")
    cams = {}
    with torch.no_grad():
        teacher.resd.weights[-1].normal_(0.0, 0.05, generator=torch.Generator(
            device="cuda").manual_seed(4))
        for v, (K, R, T, cam) in enumerate(_ring_cams(n_views, H, W, 0.6 * W,
                                                      2.5, "cuda", 0.4)):
            name = f"{v:02d}"
            cams[name] = dict(K=K.astype(np.float64), R=R.astype(np.float64),
                              T=T.reshape(3, 1).astype(np.float64),
                              D=np.zeros((5, 1)), H=H, W=W)
            d = os.path.join(root, "images", name)
            os.makedirs(d)
            for f in range(n_frames):
                rgb = PP.point_planes_forward(cfg, teacher,
                                              f / (n_frames - 1), cam).rgb
                im = (rgb.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
                cv2.imwrite(os.path.join(d, f"{f:06d}.jpg"), im[..., ::-1])
    write_cameras(cams, root)
    save_sfm_ply(os.path.join(root, "points3D.ply"), pts,
                 rng.random((PP_POINTS, 3)).astype(np.float32))
    return time.perf_counter() - t0


def family_cli_runs(kernels, tmp, capture, card):
    """Phase 19d: the families through the entry point in `tmp`:
    `cli.main(["train", "-c", <config>])` of stgs_synthetic.yaml and
    point_planes_synthetic.yaml as shipped (150 iterations each); a run of
    stgs_synthetic.yaml cut to 60 iterations killed at iteration 55 and
    resumed from its latest.npz of iteration 50; train_stgs on phase 16's capture at ratio 0.5
    (30 iterations); train_point_planes on a video capture written here (20
    iterations). -> {path: launch counts}."""
    from envgs_tpu_torch import cli
    from envgs_tpu_torch.models import point_planes as PP
    from envgs_tpu_torch.models import stgs as S
    from envgs_tpu_torch.train.families import train_point_planes, train_stgs

    paths = {}
    runs = (("stgs_cli", STGS_YAML, S, "make_stgs_train_step", False),
            ("point_planes_cli", PP_YAML, PP, "make_point_planes_train_step",
             True))
    for path, yaml_path, module, name, tuple_out in runs:
        out_root = os.path.join(tmp, path)
        log = []
        make = family_step_probe(module, name, kernels, log, tuple_out)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        try:
            res, summary = cli.main(["train", "-c", yaml_path,
                                     f"out_root={out_root}"])
        finally:
            setattr(module, name, make)
        secs = time.perf_counter() - t0
        paths[path] = dict(kernels.LAUNCHES)
        exp = os.path.splitext(os.path.basename(yaml_path))[0]
        check_family_run(path, log, 150, paths[path], len(summary["frames"]))
        model_dir = os.path.join(out_root, "trained_model", exp)
        files = ["latest.npz"] + (["point_cloud.ply"] if module is S else [])
        if not all(os.path.exists(os.path.join(model_dir, f)) for f in files):
            raise AssertionError(f"{path}: {files} not all written")
        psnr = summary["summary"]["psnr_mean"]
        if not np.isfinite(psnr):
            raise AssertionError(f"{path}: PSNR {psnr}")
        print(f"[families] train -c {yaml_path}: 150 iterations, K5 and "
              f"gauss3d K1 / K2 once a step, loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f}, held-out PSNR {psnr:.3f} over "
              f"{len(summary['frames'])} views, {', '.join(files)} written; "
              f"{secs:.1f} s in all", flush=True)

    # a run of 60 iterations killed at iteration 55 (after the checkpoint
    # of 50), resumed
    out_root = os.path.join(tmp, "stgs_resume")
    argv = ["train", "-c", STGS_YAML, f"out_root={out_root}",
            "runner_cfg.ep_iter=60"]
    log = []
    make = family_step_probe(S, "make_stgs_train_step", kernels, log,
                             crash_at=55)
    try:
        cli.main(argv)
        raise AssertionError("the run meant to be killed finished")
    except KeyboardInterrupt:
        pass
    finally:
        S.make_stgs_train_step = make
    killed = len(log)
    z = np.load(os.path.join(out_root, "trained_model", "stgs_synthetic",
                             "latest.npz"))
    saved = int(z["iter"])
    log.clear()
    family_step_probe(S, "make_stgs_train_step", kernels, log)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    try:
        _, summary = cli.main(argv)
    finally:
        S.make_stgs_train_step = make
    paths["stgs_resume"] = dict(kernels.LAUNCHES)
    check_family_run("stgs_resume", log, 60 - saved, paths["stgs_resume"],
                     len(summary["frames"]))
    if saved != 50 or log[0]["it"] != saved:
        raise AssertionError(f"resume: saved {saved}, first iteration "
                             f"{log[0]['it']}")
    print(f"[families] stgs_synthetic killed at iteration {killed - 1} "
          f"(latest.npz of iteration {saved}), resumed: first iteration "
          f"{log[0]['it']}, {len(log)} steps, loss {log[-1]['loss']:.4f}",
          flush=True)

    # train_stgs on phase 16's capture (multiview source, SfM points)
    from envgs_tpu_torch.engine import Config

    log = []
    make = family_step_probe(S, "make_stgs_train_step", kernels, log)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        state, summary = train_stgs(Config.wrap({
            "exp_name": "stgs_capture", "out_root": os.path.join(tmp, "cap"),
            "dataset_cfg": {"source": "multiview", "data_root": capture,
                            "ratio": 0.5, "eval_every": 8},
            "model_cfg": {"sampler_cfg": {
                "type": "STGSModel", "pool_cap": 2 ** 20,
                "pair_cap": 2 ** 24}},
            "runner_cfg": {"ep_iter": 30, "log_interval": 10}}))
    finally:
        S.make_stgs_train_step = make
    secs = time.perf_counter() - t0
    paths["stgs_capture"] = dict(kernels.LAUNCHES)
    check_family_run("stgs_capture", log, 30, paths["stgs_capture"],
                     len(summary["frames"]))
    print(f"[families] train_stgs on the capture (ratio 0.5, "
          f"{int(state.pool.stats.active.sum())} SfM points in "
          f"{state.pool.cap} slots): 30 iterations, loss {log[0]['loss']:.4f}"
          f" -> {log[-1]['loss']:.4f}, held-out PSNR "
          f"{summary['summary']['psnr_mean']:.3f} over "
          f"{len(summary['frames'])} views; {secs:.1f} s in all", flush=True)

    # train_point_planes on a video capture
    video = os.path.join(tmp, "video")
    wsecs = write_video_capture(video)
    log = []
    make = family_step_probe(PP, "make_point_planes_train_step", kernels,
                             log, True)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        model, summary = train_point_planes(Config.wrap({
            "exp_name": "pp_video", "out_root": os.path.join(tmp, "vid"),
            "dataset_cfg": {"source": "multiview", "data_root": video,
                            "eval_every": 4},
            "model_cfg": {"sampler_cfg": {"type": "PointPlanesSampler",
                                          "pair_cap": 2 ** 22}},
            "runner_cfg": {"ep_iter": 20, "log_interval": 10}}))
    finally:
        PP.make_point_planes_train_step = make
    secs = time.perf_counter() - t0
    paths["point_planes_video"] = dict(kernels.LAUNCHES)
    check_family_run("point_planes_video", log, 20,
                     paths["point_planes_video"], len(summary["frames"]))
    print(f"[families] train_point_planes on a {VIDEO_VIEWS}-view "
          f"{VIDEO_FRAMES}-frame video capture at 1558x1038 (written in "
          f"{wsecs:.1f} s; {model.points.shape[0]} points): 20 iterations, "
          f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}, held-out "
          f"PSNR {summary['summary']['psnr_mean']:.3f} over "
          f"{len(summary['frames'])} (view, frame) items; {secs:.1f} s in "
          f"all ({card})", flush=True)
    return paths


def family_runs(kernels, tmp, capture, card):
    """Phase 19: (a) small STGS runs CUDA against CPU, (b) STGS at full
    width, (c) PointPlanes at a realistic size, (d) both families through
    the entry point. -> {path: launch counts}."""
    from envgs_tpu_torch.models.gaussians import DensifyConfig

    g = torch.Generator().manual_seed(19)
    eps = [torch.randn((512, 3), generator=g)
           for _ in range(DensifyConfig().split_n
                          + DensifyConfig().weight_split_n)]
    for deg_t in (0, 1):
        want = run_small_stgs("cpu", deg_t)
        got = run_small_stgs("cuda", deg_t)
        worst = compare_small_stgs(got, want,
                                   maintain_small_stgs(want[2], "cuda", eps),
                                   maintain_small_stgs(want[2], "cpu", eps))
        print(f"[small-stgs] sh_degree_t {deg_t} cuda vs cpu " + json.dumps(
            {k: (v if isinstance(v, int) else float(f"{v:.3g}"))
             for k, v in worst.items()}), flush=True)
    print(f"[small-stgs] bounds (phase 10's): render max abs {SMALL_ATOL:g}, "
          f"radii and stats equal, loss rel {LOSS_RTOL:g}, wet, gradients, "
          f"params, moments and grad_accum max|d|/max|ref| {STEP_RTOL:g}, "
          f"maintenance masks equal and arrays {DENSIFY_RTOL:g}", flush=True)
    paths = stgs_full(kernels, card)
    paths.update(point_planes_full(kernels, card))
    paths.update(family_cli_runs(kernels, tmp, capture, card))
    return paths


# ---- phase 20: the kernel-free families (NeRF, NeuS, ENeRF), serving ----
NERF_YAML = "configs/exps/nerf_synthetic.yaml"
NEUS_YAML = "configs/exps/neus_synthetic.yaml"
RAY_RATIO = 0.25  # phase 16's 3116x2076 capture cut to 779x519
RAY_ITERS = 30  # NeRF / NeuS steps
ENERF_ITERS = 20  # ENeRF steps on the video capture
# the small family steps, CUDA against CPU: a leaf whose exact gradient is
# a cancelling difference (ENeRF's blend logits, a softmax over the
# sources) keeps the rounding of its terms: its scale is at least this
# share of the step's largest gradient
FAMILY_GRAD_FLOOR = 1e-2
# a ReLU whose pre-activation sits within rounding of 0 takes its unit in
# or out of the backward on one device only (the card's sinf / cosf and the
# CPU's part in the last bit, and the positional encoding feeds the first
# layer): the leaves upstream of it, in the same network, part by that
# unit's share. At most FAMILY_BRANCH_LEAVES leaves, each within
# BRANCH_RTOL (H100 80GB HBM3 against its host's CPU: the small NeRF's
# fine network, its first three layers, up to 3.4e-3; in float64 the two
# devices agree to 1e-14)
FAMILY_BRANCH_LEAVES = 6
SERVE_YAWS = (-4.0, -3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 4.0)  # degrees


def compare_family_steps(got: dict, want: dict) -> dict:
    """Phase 20a's small step, CUDA against CPU: the loss within LOSS_RTOL,
    every gradient leaf within STEP_RTOL of its largest (at least
    FAMILY_GRAD_FLOOR of the step's largest) but at most
    FAMILY_BRANCH_LEAVES within BRANCH_RTOL, and Adam apart: the CPU's
    optax Adam fed the card's gradients gives the card's parameters and
    moments within ADAM_RTOL of each array's largest change past one
    float32 rounding of its values. -> the worst of each."""
    from envgs_tpu_torch.train.optax_adam import AdamState, adam_update

    worst = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"])}
    top = max(np.abs(w).max() for w in want["grads"])
    errs = sorted(
        np.abs(g - w).max() / max(np.abs(w).max(), FAMILY_GRAD_FLOOR * top)
        for g, w in zip(got["grads"], want["grads"]))
    branch = [e for e in errs if e > STEP_RTOL]
    worst["grads"] = max([e for e in errs if e <= STEP_RTOL], default=0.0)
    worst["branch_leaves"] = len(branch)
    worst["branch"] = max(branch, default=0.0)
    params = [torch.tensor(p) for p in got["params0"]]
    state = adam_update(params, [torch.tensor(g) for g in got["grads"]],
                        AdamState(torch.zeros((), dtype=torch.int32),
                                  [torch.zeros_like(p) for p in params],
                                  [torch.zeros_like(p) for p in params]),
                        got["lr"])
    adam = 0.0
    for mine, theirs, start in zip(
            [*params, *state.mu, *state.nu],
            [*got["params"], *got["mu"], *got["nu"]],
            [*got["params0"], *[0 * m for m in got["mu"]],
             *[0 * v for v in got["nu"]]]):
        change = max(np.abs(theirs - start).max(), 1e-30)
        excess = max(np.abs(mine.numpy() - theirs).max()
                     - np.abs(theirs).max() * 2.0 ** -23, 0.0)
        adam = max(adam, excess / change)
    worst["adam"] = adam
    if not (worst["loss"] <= LOSS_RTOL and worst["adam"] <= ADAM_RTOL
            and len(branch) <= FAMILY_BRANCH_LEAVES
            and worst["branch"] <= BRANCH_RTOL):
        raise AssertionError(f"small family step, cuda vs cpu: {worst}")
    return worst


def ray_step_probe(module, name, kernels, log):
    """Wrap module.<name> (make_nerf_train_step, make_neus_train_step or
    make_enerf_train_step) so that every step runs synchronized, with its
    host seconds, CUDA-event stage ms, loss and launches appended to `log`
    (and the config it was made with first). -> the original."""
    make = getattr(module, name)

    def made(*a, **kw):
        log.append({"cfg": a[0]})
        init, step = make(*a, **kw)

        def counted(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            marks = []

            def mark(stage):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((stage, e))

            mark("start")
            t0 = time.perf_counter()
            res = step(*args, mark=mark, **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            log.append(dict(
                rose={k: kernels.LAUNCHES[k] - before[k] for k in before
                      if kernels.LAUNCHES[k] != before[k]},
                loss=float(res[-1]["loss"]), s=secs,
                stages={n: a.elapsed_time(b)
                        for (_, a), (n, b) in zip(marks, marks[1:])}))
            return res
        return init, counted

    setattr(module, name, made)
    return make


def ray_family_runs(kernels, capture, video, tmp, card):
    """Phase 20a: (1) a small NeRF, NeuS and ENeRF step CUDA against CPU
    (bench.family_small_step) at phase 10's bounds; (2) NeRF and NeuS at
    the JAX defaults' widths through `cli.main(["train", "-c", ...])` on
    phase 16's capture at RAY_RATIO, ENeRF (ENeRFConfig(): 64 + 8 planes,
    2 sources) through train_enerf on phase 19d's 1558x1038 video capture
    (ImageBasedDataset): steps/s, stage ms, peak memory, finite loss and
    parameters, the held-out views' PSNR, no kernel of the repo launched.
    -> {path: launch counts}."""
    from envgs_tpu_torch import bench, cli
    from envgs_tpu_torch.engine import Config
    from envgs_tpu_torch.models import enerf as E
    from envgs_tpu_torch.models import nerf as N
    from envgs_tpu_torch.models import neus as NS
    from envgs_tpu_torch.train.families import train_enerf

    for fam in ("nerf", "neus", "enerf"):
        worst = compare_family_steps(bench.family_small_step(fam, "cuda"),
                                     bench.family_small_step(fam, "cpu"))
        print(f"[ray-families] small {fam} step cuda vs cpu " + json.dumps(
            {k: float(f"{v:.3g}") for k, v in worst.items()})
            + f" (bounds: loss rel {LOSS_RTOL:g}, gradients {STEP_RTOL:g} "
            f"of each leaf's largest (at least {FAMILY_GRAD_FLOOR:g} of the "
            f"step's) but {FAMILY_BRANCH_LEAVES} leaves within "
            f"{BRANCH_RTOL:g} (a ReLU at its kink), Adam {ADAM_RTOL:g})",
            flush=True)

    common = ["dataset_cfg.source=multiview",
              f"dataset_cfg.data_root={capture}",
              f"dataset_cfg.ratio={RAY_RATIO}", "dataset_cfg.eval_every=12",
              "dataset_cfg.near=2.0", "dataset_cfg.far=16.0",
              f"runner_cfg.ep_iter={RAY_ITERS}", "runner_cfg.log_interval=10",
              "runner_cfg.record=false"]
    runs = (
        ("nerf", N, "make_nerf_train_step", N.NerfConfig(), lambda out: (
            cli.main(["train", "-c", NERF_YAML, f"out_root={out}", *common,
                      "model_cfg.network_cfg.width=256",
                      "model_cfg.network_cfg.depth=8",
                      "model_cfg.network_cfg.feat_dim=256",
                      "model_cfg.network_cfg.n_samples=[64,64]",
                      "runner_cfg.n_rays=1024"]))),
        ("neus", NS, "make_neus_train_step", NS.NeusConfig(), lambda out: (
            cli.main(["train", "-c", NEUS_YAML, f"out_root={out}", *common,
                      "model_cfg.network_cfg.width=128",
                      "model_cfg.network_cfg.depth=4",
                      "model_cfg.network_cfg.n_samples=48",
                      "runner_cfg.n_rays=512"]))),
        ("enerf", E, "make_enerf_train_step", E.ENeRFConfig(), lambda out: (
            train_enerf(Config.wrap({
                "exp_name": "enerf_video", "out_root": out,
                "dataset_cfg": {"source": "multiview", "data_root": video,
                                "near": 0.5, "far": 8.0, "eval_every": 4},
                "model_cfg": {"sampler_cfg": {"type": "CostVolumeSampler",
                                              "n_srcs": 2}},
                "runner_cfg": {"ep_iter": ENERF_ITERS, "log_interval": 10,
                               "record": False}})))),
    )
    paths = {}
    for fam, module, name, want_cfg, run in runs:
        log = []
        make = ray_step_probe(module, name, kernels, log)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            net, summary = run(os.path.join(tmp, fam))
        finally:
            setattr(module, name, make)
        secs = time.perf_counter() - t0
        paths[f"{fam}_family"] = launches = dict(kernels.LAUNCHES)
        cfg, steps = log[0]["cfg"], log[1:]
        cfg = cfg._replace(**{k: tuple(v) for k, v in cfg._asdict().items()
                              if isinstance(v, list)})  # YAML lists
        if cfg != want_cfg:
            raise AssertionError(f"{fam}: config {cfg}, not {want_cfg}")
        n = ENERF_ITERS if fam == "enerf" else RAY_ITERS
        if len(steps) != n or any(s["rose"] for s in steps) or any(
                launches.values()):
            raise AssertionError(f"{fam}: {len(steps)} steps, launches "
                                 f"{[s['rose'] for s in steps]} {launches}")
        if not all(np.isfinite(s["loss"]) for s in steps) or not all(
                bool(torch.isfinite(p).all()) for p in net.parameters()):
            raise AssertionError(f"{fam}: a loss or a parameter not finite")
        psnr = summary["summary"]["psnr_mean"]
        if not np.isfinite(psnr):
            raise AssertionError(f"{fam}: PSNR {psnr}")
        timed = steps[1:]
        stages = {k: statistics.median(s["stages"][k] for s in timed)
                  for k in ("forward", "backward", "optimizer")}
        print(f"[ray-families] {fam} ({card}): {cfg}; {n} steps, loss "
              f"{steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f}, "
              f"{len(timed) / sum(s['s'] for s in timed):.4f} steps/s "
              f"(synchronized, after one), device ms forward "
              f"{stages['forward']:.3f} backward {stages['backward']:.3f} "
              f"optimizer {stages['optimizer']:.3f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"held-out PSNR {psnr:.3f} over {len(summary['frames'])} "
              f"views; no kernel of the repo launched; {secs:.1f} s in all",
              flush=True)
    return paths


def serve_run(kernels, make_runner, card):
    """Phase 20b: a RenderServer (watch mode) on a fresh runner resumed
    from phase 14's checkpoint, on a loopback websocket (127.0.0.1, a free
    port): the training view, a yaw sweep, each render type once, then a
    later checkpoint written beside the run's and one more frame. Each
    frame: K1 and K3 launched once and nothing else, its JPEG equal to
    encode_jpeg(typed_map(render_view(cam), type)) in this process, no
    truncation, finite rgb of std > 0.01. -> {path: launch counts}."""
    import asyncio
    import threading

    import websockets

    from envgs_tpu_torch import bench
    from envgs_tpu_torch.serve import websocket_server as WS
    from envgs_tpu_torch.train import checkpoints as ckpt

    runner = make_runner(True)
    srv = WS.RenderServer(runner, watch=True)
    thread = threading.Thread(target=lambda: asyncio.run(srv.serve(
        host="127.0.0.1", port=0)), daemon=True)
    thread.start()
    if not srv.ready.wait(120):
        raise AssertionError("the render server did not start")
    cam0 = runner.views[0]["camera"]
    frames, total = [], {k: 0 for k in kernels.LAUNCHES}
    new_iter = {}

    def write_later_checkpoint():
        st = runner.state
        p = st.base.params
        later = st._replace(base=st.base._replace(params=p._replace(
            features_dc=p.features_dc * 0.5)))
        it = int(srv.attached_iter) + 1000
        t0 = time.perf_counter()
        ckpt.save_checkpoint(os.path.join(runner.model_dir, "latest.npz"),
                             later, it)
        new_iter.update(it=it, s=time.perf_counter() - t0)

    async def frame(ws, label, cam, kind):
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        await ws.send(WS.encode_camera(cam.K.cpu().numpy(),
                                       cam.R.cpu().numpy(),
                                       cam.T.cpu().numpy()))
        jpeg = await ws.recv()
        stats = json.loads(await ws.recv())["stats"]
        secs = time.perf_counter() - t0
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        for k, v in rose.items():
            total[k] += v
        if {k: v for k, v in rose.items() if v} != {
                k: 1 for k in RENDER_KERNELS}:
            raise AssertionError(f"served frame {label}: launches {rose}")
        out = runner.render_view(cam)  # the reference, not counted
        bench.check_render(out, runner.model_cfg)
        if jpeg != WS.encode_jpeg(WS.typed_map(out, kind)):
            raise AssertionError(f"served frame {label} ({kind}): the JPEG "
                                 "is not the render's")
        frames.append(dict(label=label, kind=kind, s=secs, stats=stats,
                           jpeg=jpeg))

    async def session():
        async with websockets.connect(f"ws://127.0.0.1:{srv.port}",
                                      max_size=2 ** 25) as ws:
            hello = json.loads(await ws.recv())
            if (hello["H"], hello["W"]) != (cam0.H, cam0.W) or not hello[
                    "watch"]:
                raise AssertionError(f"hello frame {hello}")
            await frame(ws, "view", cam0, "RENDER")
            for deg in SERVE_YAWS:
                await frame(ws, f"yaw {deg:+g}", bench.yawed(cam0, deg),
                            "RENDER")
            for kind in WS.RENDER_TYPES:
                await ws.send(json.dumps({"render_type": kind}))
                if json.loads(await ws.recv()) != {"render_type": kind}:
                    raise AssertionError(f"render type {kind} not taken")
                await frame(ws, "type", cam0, kind)
            await ws.send(json.dumps({"render_type": "RENDER"}))
            await ws.recv()
            # the loop keeps answering pings while the checkpoint is written
            await asyncio.get_running_loop().run_in_executor(
                None, write_later_checkpoint)
            await frame(ws, "after", cam0, "RENDER")

    try:
        asyncio.run(session())
    finally:
        srv.stop()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("the render server did not stop")
    first, last = frames[0], frames[-1]
    if first["stats"].get("iter") != runner.start_iter or last["stats"].get(
            "iter") != new_iter["it"] or last["jpeg"] == first["jpeg"]:
        raise AssertionError(
            f"watch: iterations {first['stats'].get('iter')} -> "
            f"{last['stats'].get('iter')}, want {runner.start_iter} -> "
            f"{new_iter['it']}, the frame changed: "
            f"{last['jpeg'] != first['jpeg']}")
    sweep = [f for f in frames if f["label"].startswith("yaw")]
    med = {k: statistics.median(f["stats"][k] for f in frames)
           for k in ("render_ms", "encode_ms", "jpeg_kb")}
    print(f"[serve] {len(frames)} frames at {cam0.W}x{cam0.H} over a "
          f"loopback websocket ({card}): K1 and K3 once a frame and nothing "
          f"else, each JPEG the render's, nothing truncated; "
          f"{len(sweep) / sum(f['s'] for f in sweep):.3f} frames/s over the "
          f"yaw sweep (send to stats received); the server's median "
          f"render_ms {med['render_ms']}, encode_ms {med['encode_ms']}, "
          f"{med['jpeg_kb']} KiB a JPEG; watch: iteration "
          f"{first['stats']['iter']} -> {last['stats']['iter']} after a "
          f"checkpoint written in {new_iter['s']:.1f} s, the next frame the "
          f"new state's", flush=True)
    return {"serve": total}


# ---- phase 21: multi-process training (parallel/): bands, slabs ----
BAND_H = 1024  # the train scene's rows: 1038 is no multiple of 16 * bands
BAND_COUNTS = (2, 4)
BAND_ROW_OFF = 512  # K1 train / K2 at a row offset, against the plain
BAND_MAPS = ("acc_map", "dpt_map", "norm_map", "spec_map", "rough_map",
             "dist_map", "dif_rgb_map")  # the base pass's maps of a band
BAND_STEPS = 5  # timed steps of the 2-rank band step
# the slab render against the same slabs composed in one process: the same
# blends and the same composition, the gathered parts exact
SLAB_ATOL = 1e-6
# ... and against the single render, of each map's largest |value|: a slab
# blends with its own transmittance from 1, so it keeps pairs the single
# blend refuses at T (1 - a) < 1e-4 once the nearer slabs took T that low,
# each weighing a T up to 1e-4 / (1 - a) <= 1e-2 (a <= 0.99)
SLAB_CUTOFF_RTOL = 1e-2
RUNNER_EVAL_RTOL = 1e-6  # the split Runner.test's merged means
RANK_TIMEOUT_S = 600


def _launch_delta(kernels, before):
    return {k: kernels.LAUNCHES[k] - before[k] for k in before}


def _zero_counts(kernels):
    for d in (kernels.LAUNCHES, kernels.ROW_OFF_LAUNCHES):
        for k in d:
            d[k] = 0


def _counts(kernels):
    """The launches and the row-offset launches since the last zeroing."""
    return {"launches": dict(kernels.LAUNCHES),
            "row_off": dict(kernels.ROW_OFF_LAUNCHES)}


def _hooks(base, env, m2z_w=2):
    z = lambda *s: torch.zeros(s, device=base.params.xyz.device)  # noqa: E731
    return z(base.cap, m2z_w), z(env.cap, 3), z(base.cap), z(env.cap)


def band_renders(kernels):
    """Phase 21a: the train scene at 1558x1024 rendered in training mode in
    2 and 4 bands (forward_envgs(band=...)), each band's base-pass maps
    equal to the full render's rows; K1 train and K2 at row offset 512
    against their plain versions. -> (paths, K1 entry, K2 entry)."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.envgs import _pool_colors, forward_envgs
    from envgs_tpu_torch.ops.binning import bin_splats
    from envgs_tpu_torch.ops.common import ROWCULL_LOWPASS_R, prepare_splats
    from envgs_tpu_torch.ops.raster import _pack_table
    from envgs_tpu_torch.ops.raster_blend import (
        CHUNK,
        TILE,
        blend_tiles_bwd_torch,
        blend_tiles_torch,
    )
    from envgs_tpu_torch.ops.raster_blend import rows as raster_rows

    base, env, cam, cfg, _ = bench.make_train_scene("cuda", Ht=BAND_H)
    hooks = _hooks(base, env)
    with torch.no_grad():
        full = forward_envgs(base, env, cam, bench.TRAIN_IT, cfg, *hooks)
    paths = {}
    for n in BAND_COUNTS:
        h = BAND_H // n
        _zero_counts(kernels)
        worst = 0.0
        for b in range(n):
            before = dict(kernels.LAUNCHES)
            with torch.no_grad():
                out = forward_envgs(base, env, cam._replace(H=h),
                                    bench.TRAIN_IT, cfg, *hooks,
                                    band=(b * h, BAND_H))
            rose = _launch_delta(kernels, before)
            want = (K1_TRAIN, "env_cull", "trace_blend_fwd", "fill_forward")
            if any(v != (k in want) for k, v in rose.items()):
                raise AssertionError(f"band {b} of {n}: launches {rose}")
            for k in BAND_MAPS:
                d = (getattr(out, k) - getattr(full, k)[b * h:(b + 1) * h])
                worst = max(worst, float(d.abs().max()))
        paths[f"bands_{n}"] = _counts(kernels)
        print(f"[bands] {n} bands of {h} rows of the train scene at "
              f"{cam.W}x{BAND_H} (training mode): the base pass's "
              f"{', '.join(BAND_MAPS)} against the full render's rows max "
              f"abs {worst:g} (bound 0); K1 {kernels.LAUNCHES[K1_TRAIN]}"
              f" launches, {kernels.ROW_OFF_LAUNCHES[K1_TRAIN]} of "
              "them at a row offset", flush=True)
        if worst != 0.0:
            raise AssertionError(f"{n} bands differ from the full render")
    del full, out

    # K1 train and K2 at row offset 512: a band's aligned layout from the
    # full camera's splats, against the plain versions and the full image
    colors = torch.cat([_pool_colors(base, cam.center), base.get_specular,
                        base.get_roughness], dim=-1)
    prep = prepare_splats(base.params.xyz, base.params.rotation,
                          base.get_scaling, base.get_opacity[:, 0], colors,
                          cam, active=base.stats.active)
    C = colors.shape[-1]

    def layout(window):
        bins = bin_splats(prep, BAND_H, cam.W, TILE, cfg.pair_cap,
                          align=CHUNK, lowpass_r=ROWCULL_LOWPASS_R,
                          aligned=True, row_window=window)
        return (_pack_table(prep, bins.order), bins.gauss_idx,
                bins.tile_bounds, C, bins.tiles_x, bins.tiles_y)

    k1 = layout((BAND_ROW_OFF // TILE, (BAND_H - BAND_ROW_OFF) // TILE))
    packed, gidx, bounds, _, tx, ty = k1
    out1 = kernels.raster_blend_fwd(*k1, BAND_ROW_OFF, TRAIN_NEEDS,
                                    aligned=True)
    whole = kernels.raster_blend_fwd(*layout(None), 0, TRAIN_NEEDS,
                                     aligned=True)
    rows_err = float((out1 - whole[:, BAND_ROW_OFF:]).abs().max())
    print(f"[bands] K1 train at row offset {BAND_ROW_OFF}: {tx * ty} tiles, "
          f"{int(bounds[-1])} aligned slots; its planes against the rows of "
          f"the full image's K1 max abs {rows_err:g} (bound 0)", flush=True)
    if rows_err != 0.0:
        raise AssertionError("K1 at a row offset differs from the full rows")
    del whole
    err1 = compare(f"raster_blend_fwd (train, row_off {BAND_ROW_OFF})", out1,
                   blend_tiles_torch(*k1, BAND_ROW_OFF, TRAIN_NEEDS,
                                     aligned=True),
                   train_planes(C), KERNEL_ATOL)
    ms1 = cuda_ms(lambda: kernels.raster_blend_fwd(
        *k1, BAND_ROW_OFF, TRAIN_NEEDS, aligned=True), 20)
    plain1 = cuda_ms(lambda: blend_tiles_torch(
        *k1, BAND_ROW_OFF, TRAIN_NEEDS, aligned=True), 3)
    npix = tx * ty * 256
    ev = walked(out1[raster_rows(C)["last"]])
    bound1 = blend_bound(packed, int(bounds[-1]), 0, (C + 11) * npix, ev,
                         OPS_SURFEL_TERMS)
    g1 = torch.randn(out1.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(21))
    k2 = (packed, gidx, bounds, out1, g1, C, tx, ty, BAND_ROW_OFF)
    cols = list(range(15 + C)) + [31]
    got, want = kernels.raster_blend_bwd(*k2), blend_tiles_bwd_torch(*k2)
    err2, rel2 = compare_columns(
        f"raster_blend_bwd (row_off {BAND_ROW_OFF})", got, want, cols,
        GRAD_RTOL)
    rel2 = max(rel2, compare_columns_by_size(
        f"raster_blend_bwd (row_off {BAND_ROW_OFF})", got, want, cols,
        GRAD_RTOL))
    ms2 = cuda_ms(lambda: kernels.raster_blend_bwd(*k2), 20)
    plain2 = cuda_ms(lambda: blend_tiles_bwd_torch(*k2), 1)
    bound2 = blend_bound(packed, int(bounds[-1]), 2 * (C + 11) * npix, 0, ev,
                         OPS_SURFEL_TERMS + 2 * len(cols),
                         extra_bytes=packed.numel() * 4)
    print(f"[bands] raster_blend_fwd (train, row_off {BAND_ROW_OFF}) "
          f"{ms1:.4f} ms, plain {plain1:.2f} ms, bound {bound1[0]:.4f} ms by "
          f"{bound1[1]}; raster_blend_bwd {ms2:.4f} ms, plain {plain2:.2f} "
          f"ms, bound {bound2[0]:.4f} ms by {bound2[1]}", flush=True)
    return (paths, dict(err=err1, ms=ms1, plain_ms=plain1, bound=bound1),
            dict(err=err2, rel=rel2, ms=ms2, plain_ms=plain2, bound=bound2))


def _rank_entry(rank, world, init_file, out_dir, task):
    """A spawned rank of phase 21: on the card, in a gloo group (two ranks
    of one card: NCCL refuses them), its result through a file."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        res = task(rank, world)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(task, world, tmp):
    """task(rank, world) on `world` spawned ranks -> their results. A rank
    that raises ends the others and raises here."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, f"ranks{world}")
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_rank_entry, args=(world, os.path.join(out_dir, "init"),
                                out_dir, task), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _digest(tree) -> str:
    """sha256 of every tensor's bytes in a nested NamedTuple / dict."""
    import hashlib

    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, tuple):
            for v in x:
                walk(v)

    walk(tree)
    return h.hexdigest()


def _host_grads(grads) -> dict:
    """A step's grads_out on the host: {"base f" / "env f" / hook: tensor}."""
    out = {f"{k} {f}": v.cpu() for k in ("base", "env")
           for f, v in grads[k]._asdict().items() if v is not None}
    out.update({k: grads[k].cpu() for k in ("means2d", "env_means3d",
                                            "wet_base", "wet_env")})
    return out


def single_step_reference():
    """The single-card step on phase 21's train scene: (loss, host grads),
    the reference of the band steps."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.train.trainer import init_train_state

    base, env, cam, cfg, batch = bench.make_train_scene("cuda", Ht=BAND_H)
    grads = {}
    _, stats = bench.make_bench_step(cam, cfg)(
        init_train_state(base, env), batch, cam.K, cam.R, cam.T,
        bench.TRAIN_IT, grads_out=grads)
    return float(stats["loss"]), _host_grads(grads)


def band_step_task(rank, world):
    """Phase 21b on one rank: the band-parallel step on the train scene at
    1558x1024, each rank a band; the new state's digest, rank 0's summed
    gradients and its Adam against the CPU's on them; then (2 ranks)
    BAND_STEPS timed steps."""
    import torch.distributed as dist

    from envgs_tpu_torch import bench, kernels
    from envgs_tpu_torch.parallel import collectives
    from envgs_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_train_step,
    )
    from envgs_tpu_torch.train.optimizer import (
        LRConfig,
        lr_tree_for,
        sparse_adam_update,
    )
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import init_train_state

    base, env, cam, cfg, batch = bench.make_train_scene("cuda", Ht=BAND_H)
    state = init_train_state(base, env)
    mesh = make_mesh(world, "band")
    step = make_sharded_train_step(mesh, cam, cfg,
                                   LossConfig(perc_loss_weight=0.0),
                                   LRConfig(), LRConfig(), has_norm=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    collectives.REDUCED.update(calls=0, bytes=0)
    grads = {}
    new, stats = step(state, batch, cam.K, cam.R, cam.T, bench.TRAIN_IT,
                      grads_out=grads)
    torch.cuda.synchronize()
    res = dict(counts=_counts(kernels), reduced=dict(collectives.REDUCED),
               digest=_digest((new.base, new.env, new.opt_base, new.opt_env,
                               stats)),
               stats={k: float(v) for k, v in stats.items()})
    if any(res["counts"]["launches"][k] != (k in TRAIN_KERNELS)
           for k in kernels.LAUNCHES):
        raise AssertionError(f"band step rank {rank}: {res['counts']}")
    if rank == 0:
        res["grads"] = _host_grads(grads)
        # Adam held apart, as in phase 13: the CPU's Adam on the band
        # step's summed gradients gives the card's new params and moments
        host = lambda t: t.cpu()  # noqa: E731
        adam = 0.0
        for which, lr in (("base", LRConfig()), ("env", LRConfig())):
            pool, opt = getattr(state, which), getattr(state, f"opt_{which}")
            g = grads[which]
            mv = lambda tree: type(tree)(*(  # noqa: E731
                None if x is None else host(x) for x in tree))
            p_cpu, o_cpu = sparse_adam_update(
                mv(pool.params), mv(g), type(opt)(mv(opt.mu), mv(opt.nu),
                                                  host(opt.step)),
                lr_tree_for(bench.TRAIN_IT, lr))
            got_p = getattr(new, which).params
            got_o = getattr(new, f"opt_{which}")
            for a, b, p0, ulps in ((p_cpu, got_p, pool.params, 2),
                                   (o_cpu.mu, got_o.mu, opt.mu, 0),
                                   (o_cpu.nu, got_o.nu, opt.nu, 0)):
                for x, y, z in zip(a, b, p0):
                    if x is None:
                        continue
                    y, z = host(y), host(z)
                    change = float((y - z).abs().max())
                    # phase 13's allowance: two float32 ulps of the stored
                    # parameter (a step moves it by tens of them)
                    slack = ulps * float(np.spacing(np.float32(
                        z.abs().max())))
                    err = max(float((x - y).abs().max()) - slack, 0.0)
                    adam = max(adam, err / max(change, 1e-30))
        res["adam"] = adam
    del grads
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 30
    if world == 2:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = new
        for _ in range(BAND_STEPS):
            st, s2 = step(st, batch, cam.K, cam.R, cam.T, bench.TRAIN_IT)
        torch.cuda.synchronize()
        dist.barrier()
        res["steps_per_s"] = BAND_STEPS / (time.perf_counter() - t0)
        if not np.isfinite(float(s2["loss"])):
            raise AssertionError("band steps: non-finite loss")
    res["peak_gib"] = peak_step
    return res


ENV_ALL_CAP = 2 ** 26  # phase 21c: env slots that drop nothing uncapped


def env_slab_caps():
    """Phase 21c: the env pass's 2 radial slabs, composed in one process,
    against the single trace on the same reflected rays of the train scene,
    at the default candidate cap of a ray tile (2048) and at caps that hold
    every candidate. -> {caps: max abs acc / rgb deviation, the share of
    rays whose acc moves by more than 0.1, dropped slots single / slabs}."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models.envgs import (
        _pool_colors_at,
        reflect_rays,
        render_base,
    )
    from envgs_tpu_torch.ops import tracer
    from envgs_tpu_torch.ops.tracer_ref import prepare_trace_scene
    from envgs_tpu_torch.parallel.splat_sharding import (
        compose_trace_slabs,
        slab_assignment,
    )

    base, env, cam, cfg, _ = bench.make_train_scene("cuda", Ht=BAND_H)
    rcfg = cfg._replace(render_mode=True)
    zero = torch.zeros(3, device="cuda")
    res = {}
    with torch.no_grad():
        ref_o, ref_d = reflect_rays(cam, render_base(base, cam, rcfg))
        colors = _pool_colors_at(env, ref_o)
        apex = torch.mean(ref_o.reshape(-1, 3), dim=0)
        eslab = slab_assignment(torch.linalg.vector_norm(
            env.params.xyz - apex, dim=-1), env.stats.active, 2)

        def trace(active, per_tile_cap, cap, raw):
            return tracer.trace_rays(
                prepare_trace_scene(env.params.xyz, env.params.rotation,
                                    env.get_scaling, env.get_opacity[:, 0],
                                    colors, active=active),
                ref_o, ref_d, zero, per_tile_cap=per_tile_cap,
                total_pair_cap=cap, compose_raw=raw)

        for name, ptc, cap in (("default", None, cfg.env_pair_cap),
                               ("every candidate", env.cap, ENV_ALL_CAP)):
            parts = [trace(env.stats.active & (eslab == k), ptc, cap, True)
                     ._replace(num_pairs=None) for k in range(2)]
            comp = compose_trace_slabs(type(parts[0])(*(
                None if v[0] is None else torch.stack(v)
                for v in zip(*parts))), zero)
            one = trace(env.stats.active, ptc, cap, False)
            dev = (comp.acc - one.acc).abs()
            res[name] = dict(
                acc=float(dev.max()),
                rgb=float((comp.rgb - one.rgb).abs().max()),
                rays=float((dev > 0.1).float().mean()),
                dropped=[int(one.dropped_pairs)]
                + [int(p.dropped_pairs) for p in parts])
            del parts, comp, one
    return res


def slab_loop_render(pool, cam, cfg, n_slabs, cap):
    """The slab base pass composed in one process: each slab rasterized in
    turn with bg 0 and the parts stacked, as the ranks' gather stacks
    them."""
    from envgs_tpu_torch.ops.common import prepare_splats
    from envgs_tpu_torch.ops.raster import rasterize, render_decode
    from envgs_tpu_torch.parallel.splat_sharding import (
        _colors,
        _slab_of,
        compose_slabs,
    )

    slab = _slab_of(pool, cam, cfg, n_slabs)
    parts = [rasterize(prepare_splats(
        pool.params.xyz, pool.params.rotation, pool.get_scaling,
        pool.get_opacity[:, 0], _colors(pool, cam, cfg), cam,
        scale_modifier=cfg.scale_modifier,
        active=pool.stats.active & (slab == k)),
        cam, torch.zeros(3, device="cuda"), pair_cap=cap)
        for k in range(n_slabs)]
    stacked = type(parts[0])(*(
        None if v[0] is None else torch.stack(v) for v in zip(*parts)))
    C = 3 + (cfg.specular_channels + 1 if cfg.render_reflection else 0)
    return render_decode(
        compose_slabs(stacked, torch.full((3,), cfg.bg_brightness,
                                          device="cuda"), C), cam,
        specular_channels=cfg.specular_channels if cfg.render_reflection
        else 0, depth_ratio=cfg.depth_ratio)


def slab_tasks(rank, world):
    """Phase 21c on 2 ranks: the splat-slab base pass on the train scene
    against the single render, the env pass's deviation, and a small slab
    step on the card against the same on the CPU."""
    import functools

    from envgs_tpu_torch import bench, kernels
    from envgs_tpu_torch.models.envgs import forward_envgs, render_base
    from envgs_tpu_torch.parallel.sharding import make_mesh
    from envgs_tpu_torch.parallel.splat_sharding import (
        _slab_base_pass,
        _slab_env_pass,
        make_splat_sharded_render_base,
        make_splat_sharded_train_step,
    )

    mesh = make_mesh(world, "splat")
    axis = mesh.axes["splat"]
    base, env, cam, cfg, _ = bench.make_train_scene("cuda", Ht=BAND_H)
    rcfg = cfg._replace(render_mode=True)
    # a slab's caps are the whole image's: the depth-rank slabs are uneven
    # in pairs (near surfels cover more tiles), pair_cap / 2 would drop
    render = make_splat_sharded_render_base(mesh, cam, rcfg,
                                            slab_pair_cap=cfg.pair_cap)
    res = {}
    with torch.no_grad():
        _zero_counts(kernels)
        out = render(base)
        torch.cuda.synchronize()
        res["render_counts"] = _counts(kernels)
        single = render_base(base, cam, rcfg)
        loop = slab_loop_render(base, cam, rcfg, world, cfg.pair_cap)
        maps = ("rgb", "alpha", "depth_expected", "normal_world",
                "surf_depth")
        res["render_err"] = {k: float((getattr(out, k) - getattr(loop, k))
                                      .abs().max()) for k in maps}
        res["single_err"] = {k: float((getattr(out, k) - getattr(single, k))
                                      .abs().max()) for k in maps}
        res["single_max"] = {k: float(getattr(single, k).abs().max())
                             for k in maps}
        _zero_counts(kernels)
        slab = forward_envgs(base, env, cam, bench.TRAIN_IT, rcfg,
                             base_pass=_slab_base_pass(axis, cfg.pair_cap),
                             env_pass=_slab_env_pass(axis,
                                                     cfg.env_pair_cap))
        torch.cuda.synchronize()
        res["forward_counts"] = _counts(kernels)
        one = forward_envgs(base, env, cam, bench.TRAIN_IT, rcfg)
        res["env_dev"] = {k: float((getattr(slab, k) - getattr(one, k))
                                   .abs().max())
                          for k in ("env_rgb_map", "env_acc_map", "rgb_map")}
    del base, env, out, single, slab, one, loop
    # phase 7's small step through the slabs, card against CPU (the same
    # gloo group), at phase 7's bounds
    make = functools.partial(make_splat_sharded_train_step, mesh)
    _zero_counts(kernels)
    got = small_train("cuda", make_step=make)
    torch.cuda.synchronize()
    res["small_counts"] = _counts(kernels)
    worst = compare_small_train(got, small_train("cpu", make_step=make))
    res["small_worst"] = {k: v for k, v in worst.items()
                          if k.startswith(("stat", "grad", "flips"))}
    res["small_caps"] = {k: int(got[2][k]) for k in ("pair_overflow",
                                                     "trace_dropped")}
    return res


def runner_test_task(rank, world, out_root):
    """Phase 21d on one rank: Runner.test of phase 14's checkpoint, the eval
    views split over the ranks."""
    from envgs_tpu_torch import bench, kernels

    views, eval_views, base, env, cfg = bench.make_run_scene("cuda")
    sched = run_schedule()
    cfg = cfg._replace(reflection_start_iter=sched.reflection_start_iter)
    runner = run_runner(views, eval_views, base, env, cfg, sched, out_root,
                        True)
    _zero_counts(kernels)
    summary = runner.test(save_images=False, tag="ranks2")
    torch.cuda.synchronize()
    runner.recorder.close()
    return dict(summary=summary["summary"], counts=_counts(kernels),
                frames=[f["name"] for f in summary["frames"]])


def ranks2_task(rank, world, out_root):
    """The 2-rank phases: the band step, the slabs, the split test."""
    band = band_step_task(rank, world)
    torch.cuda.empty_cache()  # the card is shared by the ranks
    slab = slab_tasks(rank, world)
    torch.cuda.empty_cache()
    return dict(band=band, slab=slab,
                test=runner_test_task(rank, world, out_root))


def ranks4_task(rank, world):
    """The 4-rank phases: the band step in 4 bands, one 2 x 2 ('band',
    'splat') step on the train scene."""
    from envgs_tpu_torch import bench, kernels
    from envgs_tpu_torch.parallel.sharding import make_mesh
    from envgs_tpu_torch.parallel.splat_sharding import (
        make_splat_sharded_train_step,
    )
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import init_train_state

    import datetime

    res = dict(band=band_step_task(rank, world))
    torch.cuda.empty_cache()
    base, env, cam, cfg, batch = bench.make_train_scene("cuda", Ht=BAND_H)
    mesh = make_mesh((2, 2), ("band", "splat"),
                     timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    step = make_splat_sharded_train_step(
        mesh, cam, cfg, LossConfig(perc_loss_weight=0.0), LRConfig(),
        LRConfig(), has_norm=True, band_axis="band",
        slab_pair_cap=cfg.pair_cap, slab_env_cap=cfg.env_pair_cap)
    _zero_counts(kernels)
    new, stats = step(init_train_state(base, env), batch, cam.K, cam.R,
                      cam.T, bench.TRAIN_IT)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(p).all())
                 for pool in (new.base, new.env) for p in pool.params
                 if p is not None)
    res["slab2x2"] = dict(counts=_counts(kernels), finite=finite,
                          stats={k: float(v) for k, v in stats.items()},
                          digest=_digest((new.base, new.env)))
    return res


def _sum_counts(results, key):
    """The ranks' launch counts of one path, summed."""
    tot = {"launches": {}, "row_off": {}}
    for r in results:
        for kind in tot:
            for k, v in key(r)[kind].items():
                tot[kind][k] = tot[kind].get(k, 0) + v
    return tot


def parallel_runs(kernels, run_root, card):
    """Phase 21: bands in one process (21a), then 2 and 4 ranks spawned on
    the card (21b-d). -> (paths {name: counts}, K1 entry, K2 entry)."""
    import functools
    import tempfile

    from envgs_tpu_torch import bench

    t21 = time.perf_counter()
    paths, k1b, k2b = band_renders(kernels)
    torch.cuda.empty_cache()
    env_caps = env_slab_caps()
    torch.cuda.empty_cache()
    print(f"[slabs] the env pass's 2 radial slabs (composed in one process) "
          f"against the single trace on the train scene's reflected rays: "
          + "; ".join(f"{name}: acc max abs {d['acc']:.3g}, rgb {d['rgb']:.3g}"
                      f", {d['rays']:.4%} of the rays' acc moved by over 0.1, "
                      f"dropped slots (single, slabs) {d['dropped']}"
                      for name, d in env_caps.items()), flush=True)
    single_loss, single_grads = single_step_reference()
    torch.cuda.empty_cache()
    # the 1-process evaluation the split one must equal
    views, eval_views, base, env, cfg = bench.make_run_scene("cuda")
    sched = run_schedule()
    one = run_runner(views, eval_views, base, env,
                     cfg._replace(reflection_start_iter=sched
                                  .reflection_start_iter), sched, run_root,
                     True).test(save_images=False, tag="ranks1")["summary"]
    del views, eval_views, base, env
    torch.cuda.empty_cache()
    record = os.path.join(run_root, "record", "run")
    events0 = [n for n in os.listdir(record) if "tfevents" in n]
    with tempfile.TemporaryDirectory() as tmp:
        two = run_ranks(functools.partial(ranks2_task, out_root=run_root), 2,
                        tmp)
        four = run_ranks(ranks4_task, 4, tmp)

    # ---- b. the band step ----
    for res in (two, four):
        n = len(res)
        band = [r["band"] for r in res]
        if len({b["digest"] for b in band}) != 1:
            raise AssertionError(f"{n}-band step: the ranks' states differ")
        if len({json.dumps(b["stats"], sort_keys=True) for b in band}) != 1:
            raise AssertionError(f"{n}-band step: the ranks' stats differ")
        b0 = band[0]
        errs = {k: rel_err(v, single_grads[k]) for k, v in b0["grads"].items()}
        worst = max(errs, key=errs.get)
        loss_err = abs(b0["stats"]["loss"] - single_loss) / abs(single_loss)
        peaks = ", ".join(f"{b['peak_gib']:.2f}" for b in band)
        print(f"[band-step] {n} ranks on one card (gloo): loss "
              f"{b0['stats']['loss']:.6f} against the single-card step's "
              f"{single_loss:.6f} (rel {loss_err:.3g}, bound {LOSS_RTOL:g}); "
              f"gradients and hook gradients max|d|/max|ref| up to "
              f"{errs[worst]:.3g} ({worst}; bound {STEP_RTOL:g}); Adam on "
              f"the CPU against the card's {b0['adam']:.3g} of each array's "
              f"largest change (bound {ADAM_RTOL:g}); new state and stats "
              f"bit-equal on all ranks; "
              f"{b0['reduced']['bytes'] / 2 ** 20:.1f} MiB all-reduced per "
              f"step in {b0['reduced']['calls']} calls; peak {peaks} GiB per "
              "rank", flush=True)
        if not (loss_err <= LOSS_RTOL and errs[worst] <= STEP_RTOL
                and b0["adam"] <= ADAM_RTOL):
            raise AssertionError(f"{n}-band step: {errs}")
        paths[f"band_step_{n}"] = _sum_counts(res, lambda r: r["band"]
                                              ["counts"])
    print(f"[band-step] 2 ranks: {two[0]['band']['steps_per_s']:.4f} steps/s "
          f"over {BAND_STEPS} steps ({card}; two ranks share one card and "
          "stage every collective through the host: no scaling number)",
          flush=True)

    # ---- c. slabs ----
    s0 = two[0]["slab"]
    cut = {k: s0["single_err"][k] / s0["single_max"][k]
           for k in s0["single_err"]}
    print(f"[slabs] 2-slab base pass (render mode, each slab at the "
          f"image's caps) against the same slabs composed in one process: "
          f"max abs {json.dumps(s0['render_err'])} (bound {SLAB_ATOL:g}); "
          f"against the single render, of each map's largest value: "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in cut.items()})} "
          f"(bound {SLAB_CUTOFF_RTOL:g}: a slab's own transmittance keeps "
          f"pairs the single blend's 1e-4 test refuses); the slab forward "
          f"(both passes on 2 ranks) deviates from the single by "
          f"{json.dumps(s0['env_dev'])}", flush=True)
    if not (max(s0["render_err"].values()) <= SLAB_ATOL
            and max(cut.values()) <= SLAB_CUTOFF_RTOL):
        raise AssertionError(f"slab render: {s0['render_err']} {cut}")
    print("[slabs] phase 7's small step through 2 slabs, card against CPU "
          + json.dumps({k: (v if isinstance(v, int) else float(f"{v:.3g}"))
                        for k, v in s0["small_worst"].items()})
          + f" (phase 7's bounds); caps {s0['small_caps']}", flush=True)
    if any(s0["small_caps"].values()):
        raise AssertionError(f"small slab step: {s0['small_caps']}")
    for name, key in (("slab_render_2", "render_counts"),
                      ("slab_forward_2", "forward_counts"),
                      ("slab_small_step_2", "small_counts")):
        paths[name] = _sum_counts(two, lambda r: r["slab"][key])
    for r in four:
        want = TRAIN_KERNELS
        got = r["slab2x2"]["counts"]["launches"]
        if (any(v != (k in want) for k, v in got.items())
                or not r["slab2x2"]["finite"]
                or r["slab2x2"]["stats"]["pair_overflow"]
                or r["slab2x2"]["stats"]["trace_dropped"]):
            raise AssertionError(f"2x2 step: {r['slab2x2']}")
    if len({r["slab2x2"]["digest"] for r in four}) != 1:
        raise AssertionError("2x2 step: the ranks' states differ")
    print(f"[slabs] 2 x 2 ('band', 'splat') step on 4 ranks: loss "
          f"{four[0]['slab2x2']['stats']['loss']:.6f}, params finite, each "
          "rank K1, K2, K3, K4, K5 once, nothing over a slab's cap, state "
          "bit-equal on all ranks", flush=True)
    paths["slab_step_2x2"] = _sum_counts(four, lambda r: r["slab2x2"]
                                         ["counts"])

    # ---- d. the split evaluation ----
    t0, t1 = two[0]["test"], two[1]["test"]
    got = t0["summary"]
    errs = {k: abs(got[k] - one[k]) / abs(one[k])
            for k in ("psnr_mean", "ssim_mean")}
    events = [n for n in os.listdir(record) if "tfevents" in n]
    merged = os.path.join(run_root, "result", "run", "ranks2")
    print(f"[split-test] Runner.test of phase 14's checkpoint on 2 ranks: "
          f"rank 0 views {t0['frames']}, rank 1 {t1['frames']}; merged "
          f"psnr {got['psnr_mean']:.6f}, ssim {got['ssim_mean']:.6f} against "
          f"one process's {one['psnr_mean']:.6f}, {one['ssim_mean']:.6f} "
          f"(rel {json.dumps(errs)}, bound {RUNNER_EVAL_RTOL:g}); "
          f"{len(events) - len(events0)} new event file(s); files "
          f"{sorted(os.listdir(merged))}", flush=True)
    with open(os.path.join(merged, "metrics.json")) as f:
        on_disk = json.load(f)["summary"]
    if not (max(errs.values()) <= RUNNER_EVAL_RTOL
            and got["n_views_total"] == len(t0["frames"]) + len(t1["frames"])
            and len(events) == len(events0) + 1
            and on_disk["n_views_total"] == got["n_views_total"]
            and os.path.exists(os.path.join(merged, "rank1",
                                            "metrics.json"))):
        raise AssertionError(f"split test: {got} against {one}")
    paths["split_test_2"] = _sum_counts(two, lambda r: r["test"]["counts"])
    print(f"[phase 21] {time.perf_counter() - t21:.1f} s", flush=True)
    return paths, k1b, k2b


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
    k1_resources = {key: kernels.raster_blend_fwd_resources(*args)
                    for key, args in k1_compiled(kernels).items()}
    k3_resources = {"render": kernels.trace_blend_fwd_resources(False),
                    "train": kernels.trace_blend_fwd_resources(True, 0),
                    "geo_a2": kernels.trace_blend_fwd_resources(
                        False, 2, geo=True),
                    "wet_a0": kernels.trace_blend_fwd_resources(
                        True, 0, wet=True),
                    "wet_a2": kernels.trace_blend_fwd_resources(
                        True, 2, wet=True)}
    k4_resources = kernels.trace_blend_bwd_resources(0)
    k5_resources = kernels.fill_forward_resources()
    k6_resources = kernels.segscan_resources()
    p3d_resources = {"fwd": kernels.project3d_fwd_resources(),
                     "bwd": kernels.project3d_bwd_resources()}
    cull_resources = kernels.env_cull_resources()
    for name, res, threads in (
            *((key, res, 256) for key, res in k1_resources.items()),
            *((f"trace_blend_fwd ({cfg})", res, 256)
              for cfg, res in k3_resources.items()),
            ("trace_blend_bwd", k4_resources, 32),
            ("fill_forward", k5_resources, 256),
            ("segscan", k6_resources, 256),
            ("project3d_fwd", p3d_resources["fwd"], 256),
            ("project3d_bwd", p3d_resources["bwd"], 256),
            *((f"env_cull ({k})", r, 256)
              for k, r in cull_resources["kernels"].items())):
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
    k1_runs = k1_configurations(kernels, k1_args, False, "render layout")[0]
    needs_launches = needs_matrix(kernels, base, cam, cfg)
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
    # render mode with the median depth (depth_ratio = 1): K1 once, in its
    # median-only configuration, and never the training one
    med = {}
    for dev in ("cuda", "cpu"):
        sb, se, sc, scfg = small_scene(dev)
        before = dict(kernels.LAUNCHES)
        med[dev] = forward_envgs(sb, se, sc, 10,
                                 scfg._replace(depth_ratio=1.0))
        rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if dev == "cuda" and any(v != (k in (K1_MED, "env_cull", "trace_blend_fwd"))
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
    # a render with the median depth (depth_ratio = 1): K1's median-only
    # configuration once, K3 once, never the training one
    _zero_counts(kernels)
    out = forward_envgs(base, env, cam, 10, cfg._replace(depth_ratio=1.0))
    torch.cuda.synchronize()
    median_launches = dict(kernels.LAUNCHES)
    n_pairs, env_slots, std = bench.check_render(out, cfg)
    print(f"[slice] depth_ratio = 1 (median depth): base pairs {n_pairs}, "
          f"env slots {env_slots}, rgb std {std:.4f}, launches "
          + json.dumps({k: v for k, v in median_launches.items() if v}),
          flush=True)
    if any(v != (k in (K1_MED, "env_cull", "trace_blend_fwd"))
           for k, v in median_launches.items()):
        raise AssertionError(f"median render launches off: "
                             f"{median_launches}")
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
    k1_runs.update(k1_configurations(kernels, k1, True,
                                     "train layout")[0])
    out1 = kernels.raster_blend_fwd(*k1, 0, TRAIN_NEEDS, aligned=True)
    npix = tiles_x * tiles_y * 256
    ev1 = walked(out1[raster_rows(C)["last"]])
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
    # K2 reads D1, D2 and `last`, not the median: after the forward
    # without it (what the differentiable blend runs for need_med off)
    nomed = kernels.raster_blend_fwd(*k1, 0, (True, False, False),
                                     aligned=True)
    k2_args = (packed, gauss_idx, bounds, nomed, g1, C, tiles_x, tiles_y)
    got = kernels.raster_blend_bwd(*k2_args)
    want = blend_tiles_bwd_torch(*k2_args)
    err, rel = compare_columns("raster_blend_bwd (after a forward without "
                               "the median)", got, want, k2_cols, GRAD_RTOL)
    rel = max(rel, compare_columns_by_size(
        "raster_blend_bwd (after a forward without the median)", got, want,
        k2_cols, GRAD_RTOL))
    k2_err, k2_rel = max(k2_err, err), max(k2_rel, rel)
    del k1, k2_args, out1, nomed, g1, got, want

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
            if p is not None and not bool(torch.isfinite(p).all()):
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
    out1, wet1 = kernels.raster_blend_fwd(*k1g, 0, (True, True, True),
                                          "gauss3d", True)
    want1, want_wet = blend_tiles_torch(*k1g, 0, (True, True, True),
                                        "gauss3d", True)
    k1g_err = max(
        compare("raster_blend_fwd (gauss3d)", out1, want1, train_planes(C),
                KERNEL_ATOL),
        compare("raster_blend_fwd (gauss3d) per-pair", wet1, want_wet,
                {"wet": slice(None)}, KERNEL_ATOL))
    print(f"[kernels] gauss3d per-pair wet: largest "
          f"{float(want_wet.max()):.4g}, {int((want_wet > 0).sum())} pairs "
          "with weight", flush=True)
    k1g_ms = cuda_ms(
        lambda: kernels.raster_blend_fwd(*k1g, 0, (True, True, True),
                                         "gauss3d", True), 20)
    k1g_plain_ms = cuda_ms(
        lambda: blend_tiles_torch(*k1g, 0, (True, True, True), "gauss3d",
                                  True), 3)
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

    # ---- 9b. the 3DGS projection's kernels against the plain version ----
    p3d = project3d_run(kernels)

    # ---- 9c. the env cull's kernels against the plain version ----
    cull = env_cull_run(kernels)

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

    stages, counters = render_spans(
        lambda: G.render_gaussiant(gstate.pool, gcam, gcfg))
    print("[3dgs] render span ms (median of 5 profiled renders, the spans' "
          "CUDA events): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()})
          + ", counters " + json.dumps(counters), flush=True)
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
        if p is not None and not bool(torch.isfinite(p).all()):
            raise AssertionError(f"3DGS: non-finite {name} after training")
    inf_nu = sum(int((~torch.isfinite(v)).sum()) for v in gstate.opt.nu
                 if v is not None)
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
    from envgs_tpu_torch.probes.blend_variants import segscan_inputs

    rows, seg = segscan_inputs("cuda")
    got = kernels.segscan(rows, seg)
    again = kernels.segscan(rows, seg)
    torch.cuda.synchronize()
    if not torch.equal(got, again):  # the look-back's folds fix the bits
        raise AssertionError("segscan: two calls differ")
    del again
    want = segmented_inclusive_sum_torch(rows, seg)
    k6_err = float((got - want).abs().max())
    k6_ok = bool(torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL))
    starts = torch.nonzero(seg)[:, 0]
    print(f"[kernels] segscan over {tuple(rows.shape)} f32, "
          f"{starts.numel()} segment starts, longest segment "
          f"{int((starts[1:] - starts[:-1]).max())} rows, none at row 0: "
          f"max_abs_err {k6_err:.3g} at largest |sum| "
          f"{float(want.abs().max()):.4g} (bound rtol {SEG_RTOL:g} / atol "
          f"{SEG_ATOL:g}: {'within' if k6_ok else 'OUTSIDE'}); two calls "
          "bit-equal", flush=True)
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

    card = smi.strip().splitlines()[0]
    # phase 14's checkpoint and phase 15's smoke checkpoint stay on disk
    # for phase 18's meshes
    with contextlib.ExitStack() as keep:
        run_tmp = keep.enter_context(tempfile.TemporaryDirectory())
        smoke_tmp = keep.enter_context(tempfile.TemporaryDirectory())
        # ---- 14. the run at full width ----
        run_launches, eval_launches, _, make_run_runner, run_views = full_run(
            "cuda", run_tmp, kernels)
        # ---- 15. a camera path through the trained scene ----
        path_launches, _ = path_run(make_run_runner,
                                    run_views[0]["camera"], kernels)
        del run_views
        cli_launches = cli_run(kernels, smoke_tmp)

        # ---- 16. a capture on disk at full width, through the configs ----
        # (the capture stays on disk for phase 19)
        cap_tmp = keep.enter_context(tempfile.TemporaryDirectory())
        capture_launches = capture_runs(kernels, cap_tmp, card)

        # ---- 17. base tracing, two bounces, the goldens ----
        traced, traced_paths = traced_runs(kernels)

        # ---- 18. aux supervisors + LPIPS, the mesh, the capture ----
        vgg = write_vgg_npz(os.path.join(smoke_tmp, "vgg16.npz"))
        aux_launches = aux_step_run(kernels, vgg, card)
        worst = compare_small_train(small_train("cuda", vgg),
                                    small_train("cpu", vgg))
        print("[aux] small step with the aux supervisors and LPIPS, cuda vs "
              "cpu " + json.dumps({k: (v if isinstance(v, int)
                                       else float(f"{v:.3g}"))
                                   for k, v in worst.items()
                                   if k.startswith(("stat", "grad", "flips"))})
              + f" (phase 7's bounds)", flush=True)
        mesh_launches, mesh_cli_launches = mesh_run(kernels, make_run_runner,
                                                    smoke_tmp, card)
        make_serve_runner = make_run_runner  # phase 20b serves the run
        del make_run_runner
        scene_run(kernels, card)

        # ---- 19. the other gauss3d families: STGS, PointPlanes ----
        # (the video capture stays on disk for phase 20)
        fam_tmp = keep.enter_context(tempfile.TemporaryDirectory())
        family_launches = family_runs(
            kernels, fam_tmp, os.path.join(cap_tmp, "capture"), card)

        # ---- 20. the kernel-free families; serving ----
        t20 = time.perf_counter()
        family_launches.update(ray_family_runs(
            kernels, os.path.join(cap_tmp, "capture"),
            os.path.join(fam_tmp, "video"),
            keep.enter_context(tempfile.TemporaryDirectory()), card))
        family_launches.update(serve_run(kernels, make_serve_runner, card))
        print(f"[phase 20] {time.perf_counter() - t20:.1f} s", flush=True)
        del make_serve_runner

        # ---- 21. bands, the band and slab steps, the split evaluation ----
        par_paths, k1_band, k2_band = parallel_runs(kernels, run_tmp, card)

    paths = {"render": render_launches, "needs_matrix": needs_launches,
             "render_median": median_launches, "train": train_launches,
             "gaussiant": gaussiant_launches, "run": run_launches,
             "run_eval": eval_launches, "probe": probe_launches,
             "render_path": path_launches, "cli": cli_launches,
             **capture_launches, **traced_paths, "aux_train": aux_launches,
             "mesh": mesh_launches, "mesh_cli": mesh_cli_launches,
             **family_launches,
             **{p: c["launches"] for p, c in par_paths.items()}}
    row_off_paths = {p: c["row_off"] for p, c in par_paths.items()}

    def entry(name, src, replaces, err, ms, plain_ms, bound, library_ms=None,
              keys=None, **extra):
        """A kernel's line: `launches` sums the paths driven above, each
        with the counts set to 0 before it and read after it, over the
        LAUNCHES `keys` of the kernel (default: its name)."""
        by_path = {p: sum(n[k] for k in keys or (name,))
                   for p, n in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"envgs_tpu_torch/kernels/csrc/{src}",
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, "launches_by_path": by_path,
                **extra}

    def row_off_entry(name, m):
        """The kernel at a row offset (phase 21a: a band's layout at row
        512) and its launches at a nonzero offset on each path."""
        return {f"row_off_{k}": v for k, v in (
            ("ms", m["ms"]), ("plain_ms", m["plain_ms"]),
            ("bound_ms", m["bound"][0]), ("max_abs_err", m["err"]),
            ("launches_by_path", {p: n[name]
                                  for p, n in row_off_paths.items()}))}

    def gather_entry(name, replaces):
        g = gathers[(name, "bf16")]
        f = gathers[(name, "f32")]
        return entry(name, "gather_rows.cu", replaces, 0.0, g["ms"],
                     g["plain_ms"], g["bound"], g["library_ms"],
                     f32_ms=f["ms"], f32_plain_ms=f["plain_ms"],
                     f32_bound_ms=f["bound"][0],
                     f32_library_ms=f["library_ms"])

    print(json.dumps({"kernels": [
        *(entry(key, "raster_blend_fwd.cu",
                "envgs_tpu/ops/raster_pallas.py:241", run["err"], run["ms"],
                run["plain_ms"], run["bound"], mode="surfel",
                needs=run["needs"], aligned=run["aligned"],
                resources=k1_resources[key],
                **(row_off_entry(key, k1_band) if key == K1_TRAIN else {}))
          for key, run in k1_runs.items()),
        entry("raster_blend_bwd", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2_err, k2_ms,
              k2_plain_ms, k2_bound, max_rel_err=k2_rel,
              **row_off_entry("raster_blend_bwd", k2_band),
              resources=k2_resources["surfel"]),
        entry("trace_blend_fwd", "trace_blend_fwd.cu",
              "envgs_tpu/ops/tracer.py:645",
              max(k3_err, k3t_err, traced["geo_err"], traced["a2_fwd_err"],
                  traced["wet_a0"]["err"], traced["wet_a2"]["err"]), k3t_ms,
              k3t_plain_ms, k3t_bound,
              keys=("trace_blend_fwd", "trace_blend_fwd_geo",
                    "trace_blend_fwd_wet"),
              render_ms=k3_ms,
              render_plain_ms=k3_plain_ms, render_bound_ms=k3_bound[0],
              geo_ms=traced["geo_ms"], geo_plain_ms=traced["geo_plain_ms"],
              geo_bound_ms=traced["geo_bound"][0],
              geo_max_abs_err=traced["geo_err"],
              geo_launches_by_path={p: n["trace_blend_fwd_geo"]
                                    for p, n in paths.items()},
              **{f"wet_a{A}_{k}": v for A in (0, 2) for k, v in (
                  ("ms", traced[f"wet_a{A}"]["ms"]),
                  ("plain_ms", traced[f"wet_a{A}"]["plain_ms"]),
                  ("bound_ms", traced[f"wet_a{A}"]["bound"][0]),
                  ("max_abs_err", traced[f"wet_a{A}"]["err"]))},
              wet_launches_by_path={p: n["trace_blend_fwd_wet"]
                                    for p, n in paths.items()},
              train_a2_ms=traced["a2_fwd_ms"],
              train_a2_plain_ms=traced["a2_fwd_plain_ms"],
              train_a2_bound_ms=traced["a2_fwd_bound"][0],
              train_a2_max_abs_err=traced["a2_fwd_err"],
              resources=k3_resources),
        entry("trace_blend_bwd", "trace_blend_bwd.cu",
              "envgs_tpu/ops/tracer.py:799", max(k4_err, k4r_err), k4_ms,
              k4_plain_ms, k4_bound, max_rel_err=max(k4_rel, k4r_rel),
              a2_ms=traced["a2_ms"], a2_plain_ms=traced["a2_plain_ms"],
              a2_bound_ms=traced["a2_bound"][0], a2_max_abs_err=traced[
                  "a2_err"], a2_max_rel_err=traced["a2_rel"],
              resources=k4_resources),
        entry("fill_forward", "fill_forward.cu",
              "envgs_tpu/ops/fill_forward.py:55", k5_err, k5_ms,
              k5_plain_ms, k5_bound, k5_lib_ms, queued_ms=k5_dev_ms,
              resources=k5_resources),
        entry("raster_blend_fwd_gauss3d", "raster_blend_fwd.cu",
              "envgs_tpu/ops/raster_pallas.py:241", k1g_err, k1g_ms,
              k1g_plain_ms, k1g_bound, mode="gauss3d",
              needs=[True, True, True], aligned=True,
              resources=k1_resources["raster_blend_fwd_gauss3d"]),
        entry("raster_blend_bwd_gauss3d", "raster_blend_bwd.cu",
              "envgs_tpu/ops/raster_pallas.py:456", k2g_err, k2g_ms,
              k2g_plain_ms, k2g_bound, max_rel_err=k2g_rel, mode="gauss3d",
              resources=k2_resources["gauss3d"]),
        entry("project3d_fwd", "project3d.cu",
              "none (envgs_tpu/ops/raster3d_ref.py::prepare_splats3d, jnp)",
              p3d["err"], p3d["classic_fwd_ms"], p3d["plain_ms"],
              p3d["fwd_bound"], max_tol_share=p3d["over"],
              layer_ms=p3d["layer_ms"],
              settings_ms={k: p3d[f"{k}_fwd_ms"] for k in PROJECT3D_SETTINGS},
              resources=p3d_resources["fwd"]),
        entry("project3d_bwd", "project3d.cu",
              "none (autograd of the plain projection)", p3d["grad_err"],
              p3d["classic_bwd_ms"], p3d["plain_fwd_bwd_ms"],
              p3d["bwd_bound"], max_rel_norm_err=p3d["grad_rel"],
              layer_fwd_bwd_ms=p3d["layer_fwd_bwd_ms"],
              settings_ms={k: p3d[f"{k}_bwd_ms"] for k in PROJECT3D_SETTINGS},
              resources=p3d_resources["bwd"]),
        entry("env_cull", "env_cull.cu",
              "none (envgs_tpu/ops/tracer.py::cull_and_sort, jnp)", 0.0,
              cull["cell"]["ms"], cull["cell"]["plain_ms"],
              cull["cell"]["bound"], met=cull["cell"]["met"],
              tiles_x_kc=cull["cell"]["tiles_x_kc"],
              peak_bytes=cull["cell"]["peak"],
              plain_peak_bytes=cull["cell"]["plain_peak"],
              render_ms=cull["render"]["ms"],
              render_plain_ms=cull["render"]["plain_ms"],
              render_bound_ms=cull["render"]["bound"][0],
              render_met=cull["render"]["met"],
              resources=cull_resources),
        entry("segscan", "segscan.cu", "envgs_tpu/ops/segsum.py:30", k6_err,
              k6_ms, k6_plain_ms, k6_bound, resources=k6_resources),
        gather_entry("gather_rows", "scripts/tpu_micro_dmagather.py:49"),
        gather_entry("gather_rows_win8",
                     "scripts/tpu_micro_dmagather.py:112"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

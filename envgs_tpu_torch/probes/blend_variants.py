"""Probe: variants of the traced blend's kernels (K3 forward, K4 backward)
side by side on the bench scenes' own inputs, on one CUDA card.

    python -m envgs_tpu_torch.probes.blend_variants [--counts] \
        label=path/to/trace_blend_bwd_x.cu[,-DFLAG...] ...

A variant is a copy of `kernels/csrc/trace_blend_fwd.cu` or
`trace_blend_bwd.cu` (the file's name must start with one of the two; the
library's `trace_blend.cuh` is on its include path) that keeps the
`extern "C"` signature, with optional nvcc flags after commas. It
is how a kernel's time is attributed to its parts (a copy with the
reduction taken out, with the geometry taken out, ...) and how the steps of
a new design are measured beside each other. Each variant is built on its
own with the library's flags and `-Xptxas -v` (registers, spills and shared
memory are printed), loaded with ctypes and run on the train bench scene's
K3 / K4 inputs (forward variants also in render mode on the render bench
scene's): its outputs against the library's own kernel (max abs error of
the planes; worst column of the table gradient and of the ray gradient;
a variant with a part taken out is expected to differ), then the median ms
of 10 launches, all variants in order and again in reverse order. The
library's kernels are timed as `repo` beside them. The first line is the
card's name and power limit.

With `--counts` it first prints what the inputs ask of the kernels, from
the plain PyTorch versions' terms: for K3 the chunks each tile has against
the chunks a block walks before every ray has saturated, the (slot, warp)
combinations in which any ray of the warp can still take a candidate and
those in which such a ray's line comes within the splat's reach (the
kernels' bounding test, modelled by `reach2` and `in_reach` here), for
16x2 and 8x4 warps; for K4 the chunks walked per tile, the (slot, warp)
combinations up to the tile's and up to the warp's own last contributor,
those with a ray inside the reach, those with a contributing ray and the
contributing rays in those.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from envgs_tpu_torch import bench, kernels
from envgs_tpu_torch.ops.common import ALPHA_MIN, T_CUTOFF
from envgs_tpu_torch.ops.raster_blend import CHUNK, NPIX, _to_tiles
from envgs_tpu_torch.ops.trace_blend import _chunk_index, _ray_terms
from envgs_tpu_torch.ops.trace_blend import rows as trace_rows

WARP_SHAPES = ((16, 2), (8, 4))  # (width, height) of a warp's patch
# the margins of the kernels' bounding test (`reach2`, `in_reach` in both
# sources; tests/test_torch_trace_design.py holds them to the sources)
RHO_MARGIN, RHO_SLACK, POS_SLACK = 1.1, 0.01, 4e-6


def reach2(packed: torch.Tensor) -> torch.Tensor:
    """Model of the kernels' `reach2`: per table row, the squared distance
    from the splat's centre beyond which no ray's line can pass the alpha
    floor (-1: none can, inf: all may)."""
    tu, tv = packed[:, 3:6], packed[:, 6:9]
    opac = packed[:, 12]
    a, b, c = (tu * tu).sum(1), (tu * tv).sum(1), (tv * tv).sum(1)
    half, diff = 0.5 * (a + c), 0.5 * (a - c)
    lmin = half - torch.sqrt(diff * diff + b * b) - 1e-5 * half
    floor = torch.tensor(ALPHA_MIN, dtype=torch.float32)
    rho_max = RHO_MARGIN * 2.0 * torch.log(opac / floor) + RHO_SLACK
    r2 = torch.where(lmin > 0, rho_max / lmin, torch.inf)
    return torch.where(opac >= floor, r2, -1.0)


def in_reach(center, r2, ray) -> torch.Tensor:
    """Model of the kernels' `in_reach` for one splat per tile: center
    (T, 3), r2 (T,), ray the six (T, NPIX) planes -> (T, NPIX) bool,
    whether the ray's line comes within the splat's reach."""
    ox, oy, oz, dx, dy, dz = ray
    ocx, ocy, ocz = (center[:, i, None] - o
                     for i, o in enumerate((ox, oy, oz)))
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    dot = ocx * dx + ocy * dy + ocz * dz
    dd = dx * dx + dy * dy + dz * dz
    return oc2 * (dd * (1.0 - POS_SLACK)) - dot * dot <= r2[:, None] * dd


def _warp_any(x: torch.Tensor, shape) -> torch.Tensor:
    """(T, 256) bool per ray -> (T, 8) bool per warp of `shape`."""
    w, h = shape
    return x.reshape(x.shape[0], 16 // h, h, 16 // w, w).any(4).any(2).reshape(
        x.shape[0], -1)


def _quantiles(x: torch.Tensor) -> str:
    q = torch.quantile(x.float(), x.new_tensor([0.5, 0.99, 1.0],
                                               dtype=torch.float32)).tolist()
    return f"median {q[0]:g}, p99 {q[1]:g}, max {q[2]:g}"


def forward_counts(k3) -> dict:
    """What K3's inputs ask: a walk of the plain forward that tracks, per
    ray, `fail` (this chunk) and `dead` (T (1 - 1/255) < 1e-4)."""
    packed, gidx, rays, bounds, tiles_x, tiles_y = k3
    T = tiles_x * tiles_y
    start = bounds[:-1].to(torch.int64)
    nchunk = (bounds[1:].to(torch.int64) - start) // CHUNK
    ray = rays[:, :6].unbind(1)
    dev = packed.device
    trans = torch.ones((T, NPIX), device=dev)
    dead = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    walking = torch.ones(T, dtype=torch.bool, device=dev)
    walked = torch.zeros(T, dtype=torch.int64, device=dev)
    live = {s: 0 for s in WARP_SHAPES}
    reached = {s: 0 for s in WARP_SHAPES}
    contributions = in_reach_pairs = 0
    r2 = reach2(packed)
    for c in range(int(nchunk.max())):
        in_tile = (c < nchunk) & walking
        walked += in_tile
        gi = _chunk_index(gidx, start, nchunk, c, packed.shape[0] - 1)
        rows_c = packed[gi]
        fail = torch.zeros_like(dead)
        for j in range(CHUNK):
            can = ~(fail | dead) & in_tile[:, None]
            may = can & in_reach(rows_c[:, j, 0:3], r2[gi[:, j]], ray)
            in_reach_pairs += int(may.sum())
            for s in WARP_SHAPES:
                live[s] += int(_warp_any(can, s).sum())
                reached[s] += int(_warp_any(may, s).sum())
            t = _ray_terms(rows_c[:, j, :, None].unbind(1), ray)
            test = trans * (1.0 - t["a"])
            passed = test >= T_CUTOFF
            contrib = t["amask"] & ~fail & passed
            fail = fail | (t["amask"] & ~passed)
            trans = torch.where(contrib, test, trans)
            dead = ~(trans * (1.0 - ALPHA_MIN) >= T_CUTOFF)
            contributions += int(contrib.sum())
        walking = walking & ~dead.all(1)
    total = int(nchunk.sum())
    out = dict(tiles=T, chunks=total, chunks_walked=int(walked.sum()),
               slot_warps_all=total * CHUNK * 8,
               slot_warps_walked=int(walked.sum()) * CHUNK * 8,
               contributions=contributions, in_reach_pairs=in_reach_pairs,
               **{f"slot_warps_live_{w}x{h}": n
                  for (w, h), n in live.items()},
               **{f"slot_warps_in_reach_{w}x{h}": n
                  for (w, h), n in reached.items()})
    print(f"[counts] K3: {T} tiles, {total} chunks ({_quantiles(nchunk)} per "
          f"tile); a block walks {out['chunks_walked']} of them before all "
          f"its rays have saturated ({_quantiles(walked)}); (slot, warp) "
          f"combinations: {out['slot_warps_all']} in all, "
          f"{out['slot_warps_walked']} walked by a block, "
          + ", ".join(f"{n} with a ray that can still take the slot in "
                      f"{w}x{h} warps ({reached[(w, h)]} of them with such "
                      "a ray inside the splat's reach)"
                      for (w, h), n in live.items())
          + f"; {in_reach_pairs} (slot, ray) pairs inside the reach, "
          f"{contributions} contributions", flush=True)
    return out


def backward_counts(k3, fwd) -> dict:
    """What K4's inputs ask, from the training planes `fwd` of K3."""
    packed, gidx, rays, bounds, tiles_x, tiles_y = k3
    T = tiles_x * tiles_y
    start = bounds[:-1].to(torch.int64)
    nchunk = (bounds[1:].to(torch.int64) - start) // CHUNK
    last = _to_tiles(fwd[trace_rows(0)["last"]][None], tiles_x, tiles_y)[0]
    lastmax = last.amax(1).to(torch.int64)
    neff = torch.minimum(nchunk, (lastmax + CHUNK) // CHUNK).clamp(min=0)
    ray = rays[:, :6].unbind(1)
    out = dict(tiles=T, chunks=int(nchunk.sum()), chunks_walked=int(neff.sum()),
               slot_warps_tile_last=int(neff.sum()) * CHUNK * 8)
    wlast = {}
    for s in WARP_SHAPES:
        w, h = s
        wl = last.reshape(T, 16 // h, h, 16 // w, w).amax(4).amax(2).reshape(
            T, -1).to(torch.int64)
        wlast[s] = wl
        out[f"slot_warps_warp_last_{w}x{h}"] = int((wl + 1).clamp(min=0).sum())
    hit = {s: 0 for s in WARP_SHAPES}
    reached = {s: 0 for s in WARP_SHAPES}
    lanes = 0
    r2 = reach2(packed)
    for c in range(int(neff.max())):
        gi = _chunk_index(gidx, start, neff, c, packed.shape[0] - 1)
        rows_c = packed[gi]
        for j in range(CHUNK):
            ranked = float(c * CHUNK + j) <= last
            t = _ray_terms(rows_c[:, j, :, None].unbind(1), ray)
            contrib = t["amask"] & ranked
            may = ranked & in_reach(rows_c[:, j, 0:3], r2[gi[:, j]], ray)
            lanes += int(contrib.sum())
            for s in WARP_SHAPES:
                hit[s] += int(_warp_any(contrib, s).sum())
                reached[s] += int(_warp_any(may, s).sum())
    out["contributing_lanes"] = lanes
    for (w, h), n in hit.items():
        out[f"slot_warps_contributing_{w}x{h}"] = n
        out[f"slot_warps_in_reach_{w}x{h}"] = reached[(w, h)]
    print(f"[counts] K4: {T} tiles, {out['chunks']} chunks; walked up to the "
          f"tile's last contributor {out['chunks_walked']} "
          f"({_quantiles(neff)} per tile, {int((neff == 0).sum())} tiles "
          f"none); (slot, warp) combinations up to the tile's last "
          f"contributor {out['slot_warps_tile_last']}; "
          + "; ".join(
              f"{w}x{h} warps: {out[f'slot_warps_warp_last_{w}x{h}']} up to "
              f"the warp's own, {reached[(w, h)]} with a ray inside the "
              f"splat's reach, {n} with a contributing ray "
              f"({lanes / max(n, 1):.2f} rays in each)"
              for (w, h), n in hit.items())
          + f"; {lanes} contributing (slot, ray) pairs", flush=True)
    return out


def build_variant(src: Path, flags, build_dir: Path):
    """nvcc `src` into a shared library of its own -> (ctypes library,
    the compiler's resource lines)."""
    lib = build_dir / f"{src.stem}_{abs(hash(tuple(flags))) % 10 ** 8}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(kernels._CSRC), *flags, "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    info, entry = [], ""
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "registers" in line or "spill" in line:
            info.append(f"{entry[:60]}: {line.split(':', 1)[-1].strip()}")
    return ctypes.CDLL(str(lib)), info


def _bind(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = kernels._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch failed with error {err}")


def forward_runner(fn, k3, train: bool):
    packed, gidx, rays, bounds, tiles_x, tiles_y = k3
    out = torch.empty((13 if train else 5, tiles_y * 16, tiles_x * 16),
                      device=packed.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _run(fn, packed.data_ptr(), packed.shape[0], gidx.data_ptr(),
             gidx.numel(), rays.data_ptr(), bounds.data_ptr(), tiles_x,
             tiles_y, int(train), 0, out.data_ptr(), stream)
        return out
    return run


def backward_runner(fn, k3, fwd, g_out):
    """As kernels.trace_blend_bwd: the gradient's zeroing is in the time."""
    packed, gidx, rays, bounds, tiles_x, tiles_y = k3
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        g_packed = torch.zeros_like(packed)
        g_rays = torch.empty_like(rays)
        _run(fn, packed.data_ptr(), packed.shape[0], gidx.data_ptr(),
             gidx.numel(), rays.data_ptr(), bounds.data_ptr(), tiles_x,
             tiles_y, 0, fwd.data_ptr(), g_out.data_ptr(),
             g_packed.data_ptr(), g_rays.data_ptr(), stream)
        return g_packed, g_rays
    return run


def cuda_ms(fn, n: int = 10) -> float:
    """Median device ms of fn over n runs after one warm-up (CUDA events)."""
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
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _worst_column(got, want) -> float:
    scale = want.abs().amax(0).clamp(min=1e-30)
    return float(((got - want).abs().amax(0) / scale).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("blend_variants")
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--build-dir", default=None)
    ap.add_argument("variants", nargs="*", help="label=source.cu[,flag...]")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the blend probe needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    kernels._load()
    rbase, renv, rcam, rcfg = bench.make_render_scene("cuda")
    k3_render = bench.blend_inputs(rbase, renv, rcam, rcfg)[1]
    del rbase, renv
    tbase, tenv, tcam, tcfg, _ = bench.make_train_scene("cuda")
    k3 = bench.train_blend_inputs(tbase, tenv, tcam, tcfg)["k3"]
    del tbase, tenv
    fwd = kernels.trace_blend_fwd(*k3, True, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_out = torch.randn(fwd.shape, generator=gen, device="cuda")
    print(f"[inputs] train scene: {k3[4] * k3[5]} tiles, {int(k3[3][-1])} "
          f"candidate slots; render scene: {k3_render[4] * k3_render[5]} "
          f"tiles, {int(k3_render[3][-1])} slots", flush=True)
    results = {}
    if a.counts:
        results["counts_fwd_train"] = forward_counts(k3)
        results["counts_fwd_render"] = forward_counts(k3_render)
        results["counts_bwd"] = backward_counts(k3, fwd)

    build_dir = Path(a.build_dir or kernels._BUILD / "variants")
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = kernels._load()
    runs = [("repo fwd render", forward_runner(lib.trace_blend_fwd, k3_render,
                                               False)),
            ("repo fwd train", forward_runner(lib.trace_blend_fwd, k3, True)),
            ("repo bwd", backward_runner(lib.trace_blend_bwd, k3, fwd, g_out))]
    want = {"render": runs[0][1]().clone(), "train": runs[1][1]().clone()}
    want_g, want_r = runs[2][1]()
    cols = list(range(16)) + [31]
    per_ray = lambda x: x[:, :6].transpose(0, 1).reshape(6, -1).T  # noqa: E731
    for spec in a.variants:
        label, rest = spec.split("=", 1)
        path, *flags = rest.split(",")
        src = Path(path)
        vlib, info = build_variant(src, flags, build_dir)
        for line in info:
            print(f"[build] {label}: {line}", flush=True)
        if src.name.startswith("trace_blend_fwd"):
            fn = _bind(vlib, "trace_blend_fwd")
            for mode, args in (("render", k3_render), ("train", k3)):
                run = forward_runner(fn, args, mode == "train")
                err = float((run() - want[mode]).abs().max())
                print(f"[check] {label} ({mode}): max abs against the "
                      f"library's kernel {err:.3g}", flush=True)
                runs.append((f"{label} fwd {mode}", run))
        elif src.name.startswith("trace_blend_bwd"):
            run = backward_runner(_bind(vlib, "trace_blend_bwd"), k3, fwd,
                                  g_out)
            got_g, got_r = run()
            print(f"[check] {label}: worst column against the library's "
                  f"kernel {_worst_column(got_g[:, cols], want_g[:, cols]):.3g}"
                  f", rays {_worst_column(per_ray(got_r), per_ray(want_r)):.3g}",
                  flush=True)
            runs.append((f"{label} bwd", run))
        else:
            raise ValueError(f"{src.name}: expected trace_blend_fwd*.cu or "
                             "trace_blend_bwd*.cu")
    torch.cuda.synchronize()
    first = {name: cuda_ms(run) for name, run in runs}
    second = {name: cuda_ms(run) for name, run in reversed(runs)}
    for name, _ in runs:
        results[name] = (first[name], second[name])
        print(f"[ms] {name}: {first[name]:.4f} (in order), "
              f"{second[name]:.4f} (in reverse order)", flush=True)
    return results


if __name__ == "__main__":
    main()

"""Probe: variants of the blend kernels (K1 raster forward, K3 trace
forward, K4 trace backward) and of the fill-forward scan (K5) side by
side on the bench scenes' own inputs, on one CUDA card.

    python -m envgs_tpu_torch.probes.blend_variants [--counts[=k1,k3]] \
        label=path/to/raster_blend_fwd_x.cu[,-DFLAG...] ...

A variant is a copy of `kernels/csrc/raster_blend_fwd.cu`,
`trace_blend_fwd.cu`, `trace_blend_bwd.cu` or `fill_forward.cu` (the
file's name must start with one of the four; the library's headers are on
its include path) that keeps the `extern "C"` signature, with optional
nvcc flags after commas. It is how a kernel's time is attributed to its
parts (a copy with the reduction taken out, with the geometry taken out,
...) and how the steps of a new design, or a kernel's earlier design, are
measured beside each other. Each variant is built on its own with the
library's flags and `-Xptxas -v` (registers, spills and shared memory are
printed), loaded with ctypes and run on the inputs its kernel gets on the
bench scenes: K1 in its four configurations (render: the render bench
scene's unaligned layout; median: the training kernel on that layout, what
a render with the median depth launches; train: the train bench scene's
aligned layout; gauss3d: the 3DGS bench scene with the per-pair wet), K3 in
render and training mode, K4 on the train scene's K3 planes, K5 on the
train scene's markers. Its outputs are checked against the library's own
kernel (max abs error of the planes and the wet; worst column of the table
gradient and of the ray gradient; positions that differ; a variant with a
part taken out is expected to differ), then each is timed as the median ms
of 10 launches queued behind a sleep of the card (so the host's enqueueing
is not in the time), all variants in order and again in reverse order. The
library's kernels of the same families are timed as `repo` beside them.
The first line is the card's name and power limit.

With `--counts` it first prints what the inputs ask of the kernels, from
the plain PyTorch versions' terms (`--counts=k1` or `--counts=k3` for one
family). For K1, per configuration: the 64-pair windows each tile has
against the windows a block walks before all its pixels have saturated and
against the windows up to the tile's last contributor; the (pair, pixel)
evaluations past each pixel's last contributor; and, for 16x2 and 8x4
warps, the (pair, warp) combinations walked, those in which a pixel can
still take the pair (not failed in this window, not saturated), those in
which the pair's alpha-floor footprint reaches the warp's patch (exactly,
and by the kernel's conservative test, modelled by `footprint_may` here),
those the new design evaluates (both at once), and those with a
contributing pixel with the contributing pixels in them. For K3 the chunks
each tile has against the chunks a block walks before every ray has
saturated, the (slot, warp) combinations in which any ray of the warp can
still take a candidate and those in which such a ray's line comes within
the splat's reach (the kernels' bounding test, modelled by `reach2` and
`in_reach` here), for 16x2 and 8x4 warps; for K4 the chunks walked per
tile, the (slot, warp) combinations up to the tile's and up to the warp's
own last contributor, those with a ray inside the reach, those with a
contributing ray and the contributing rays in those.
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
from envgs_tpu_torch.ops.common import ALPHA_MIN, FILTER_INV_SQUARE, T_CUTOFF
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    NPIX,
    TILE,
    _pixel_coords,
    _terms,
    _to_tiles,
    _window_index,
)
from envgs_tpu_torch.ops.trace_blend import _chunk_index, _ray_terms
from envgs_tpu_torch.ops.trace_blend import rows as trace_rows

WARP_SHAPES = ((16, 2), (8, 4))  # (width, height) of a warp's patch
# the margins of the kernels' bounding test (`reach2`, `in_reach` in both
# sources; tests/test_torch_trace_design.py holds them to the sources)
RHO_MARGIN, RHO_SLACK, POS_SLACK = 1.1, 0.01, 4e-6
# the margins of K1's footprint test (`may_reach` in raster_blend_fwd.cu;
# tests/test_torch_raster_fwd_design.py holds them to the source): the
# level's relative and absolute slack, and the relative rounding allowance
# of the surfel's homogeneous intersection
FOOT_RHO_MARGIN, FOOT_RHO_SLACK, FOOT_EPS = 1.01, 0.01, 2.0 ** -18


def footprint_may(d: torch.Tensor, x0, y0, w: int, h: int,
                  mode: str) -> torch.Tensor:
    """Model of K1's per-(pair, warp) footprint test (`may_reach`): table
    rows d (..., 32) against the patch of pixels [x0, x0 + w - 1] x
    [y0, y0 + h - 1] (x0, y0 broadcast against d's leading shape) -> bool,
    False only where no pixel of the patch can pass the alpha floor.

    Level: alpha = opacity exp(-rho / 2) passes 1/255 only where rho <=
    2 ln(255 opacity); the test uses that level with FOOT_RHO_MARGIN and
    FOOT_RHO_SLACK, which also cover the rounding of the offsets from the
    centre. Surfel: rho = min(rho3d, rho2d), so a patch is refused
    only where both are over the level. rho2d (the low-pass circle) by the
    patch's distance from the centre. rho3d = (qx^2 + qy^2) / qz^2 with
    q = k x l, which is linear in the pixel: q = q(centre) + dx B + dy C,
    so over the patch each component lies in an interval, widened by
    FOOT_EPS times the magnitudes of the kernel's own products (its float
    rounding); refused where the smallest qx^2 + qy^2 exceeds the level
    times the largest qz^2. Gauss3d: rho = a dx^2 + 2 b dx dy + c dy^2;
    where the conic is positive definite, the ellipse at the level lies in
    |dy| <= sqrt(L a / det) and, at each dy, within sqrt(L / a) of
    -b dy / a: refused where the patch's rows miss the first or its columns
    the slab over those rows. Every comparison refuses only when true, so a
    NaN anywhere lets the pair through."""
    f32 = torch.float32
    opac = d[..., 11]
    x0 = torch.as_tensor(x0, dtype=f32, device=d.device)
    y0 = torch.as_tensor(y0, dtype=f32, device=d.device)
    xc = x0 + 0.5 * (w - 1)
    yc = y0 + 0.5 * (h - 1)
    hx = 0.5 * (w - 1)
    hy = 0.5 * (h - 1)
    level = (FOOT_RHO_MARGIN * (2.0 * torch.log(opac / ALPHA_MIN))
             + FOOT_RHO_SLACK)
    dxc = d[..., 9] - xc
    dyc = d[..., 10] - yc
    zero = torch.zeros((), dtype=f32, device=d.device)
    if mode == "gauss3d":
        a, b, c = d[..., 0], d[..., 1], d[..., 2]
        det = a * c - b * b
        ey = torch.sqrt(level * a / det)
        ylo = torch.fmax(dyc - hy, -ey)
        yhi = torch.fmin(dyc + hy, ey)
        s = b / a
        r = torch.sqrt(level / a)
        xl = torch.fmin(-s * ylo, -s * yhi) - r
        xr = torch.fmax(-s * ylo, -s * yhi) + r
        far = (ylo > yhi) | (dxc - hx > xr) | (dxc + hx < xl)
        refuse = (a > 0) & (det > 0) & far
    else:
        ex = torch.fmax(torch.abs(dxc) - hx, zero)
        ey = torch.fmax(torch.abs(dyc) - hy, zero)
        far_lp = FILTER_INV_SQUARE * (ex * ex + ey * ey) > level
        r0 = [d[..., i] for i in range(3)]
        r1 = [d[..., 3 + i] for i in range(3)]
        r2 = [d[..., 6 + i] for i in range(3)]
        k = [r0[i] - xc * r2[i] for i in range(3)]
        l = [r1[i] - yc * r2[i] for i in range(3)]  # noqa: E741
        km = [torch.abs(r0[i]) + (torch.abs(xc) + hx) * torch.abs(r2[i])
              for i in range(3)]
        lm = [torch.abs(r1[i]) + (torch.abs(yc) + hy) * torch.abs(r2[i])
              for i in range(3)]

        def cross(u, v, i):
            j, n = (i + 1) % 3, (i + 2) % 3
            return u[j] * v[n] - u[n] * v[j]

        q, wq = [], []
        for i in range(3):
            j, n = (i + 1) % 3, (i + 2) % 3
            slack = FOOT_EPS * (km[j] * lm[n] + km[n] * lm[j])
            wq.append(torch.abs(cross(l, r2, i)) * hx
                      + torch.abs(cross(r2, k, i)) * hy + slack)
            q.append(cross(k, l, i))
        lo_x = torch.fmax(torch.abs(q[0]) - wq[0], zero)
        lo_y = torch.fmax(torch.abs(q[1]) - wq[1], zero)
        hi_z = torch.fmax(torch.abs(q[2]) + wq[2],
                          torch.tensor(1e-12, dtype=f32, device=d.device))
        far_conic = lo_x * lo_x + lo_y * lo_y > level * (hi_z * hi_z)
        refuse = far_lp & far_conic
    return ~((opac < ALPHA_MIN) | refuse)


def warp_origins(shape, T: int, tiles_x: int, row_off: int, device):
    """(x0, y0) (T, 8) float32 of each warp's patch of `shape`, warps in
    the kernels' order (patch w at (w % (16 / width), w / (16 / width)))."""
    w, h = shape
    t = torch.arange(T, device=device)[:, None]
    k = torch.arange(NPIX // 32, device=device)[None, :]
    x0 = (t % tiles_x) * TILE + (k % (TILE // w)) * w
    y0 = (t // tiles_x) * TILE + row_off + (k // (TILE // w)) * h
    return x0.to(torch.float32), y0.to(torch.float32)


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


def raster_counts(k1, mode: str = "surfel", label: str = "K1") -> dict:
    """What K1's inputs ask: a walk of the plain forward over each tile's
    64-pair windows that tracks, per pixel, `fail` (this window) and `dead`
    (T (1 - 1/255) < 1e-4), and per tile whether the block still walks (a
    pixel is not dead)."""
    packed, gidx, bounds, C, tiles_x, tiles_y = k1
    T = tiles_x * tiles_y
    P = packed.shape[0] - 1
    dev = packed.device
    terms = _terms(mode)
    start = bounds[:-1].to(torch.int64)
    end = bounds[1:].to(torch.int64)
    wstart = start - start % 8
    nwin = ((end - wstart + CHUNK - 1) // CHUNK).clamp(min=0)
    px, py = _pixel_coords(T, tiles_x, 0, dev)
    trans = torch.ones((T, NPIX), device=dev)
    dead = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    last = torch.full((T, NPIX), -1, dtype=torch.int64, device=dev)
    walking = torch.ones(T, dtype=torch.bool, device=dev)
    walked = torch.zeros(T, dtype=torch.int64, device=dev)
    origins = {s: warp_origins(s, T, tiles_x, 0, dev) for s in WARP_SHAPES}
    keys = ("live", "foot", "model", "evaluated", "contributing")
    n = {(k, s): 0 for k in keys for s in WARP_SHAPES}
    lanes = 0
    for c in range(int(nwin.max()) if T else 0):
        in_tile = (c < nwin) & walking
        walked += in_tile
        rows_c = packed[_window_index(gidx, start, end, wstart + c * CHUNK,
                                      P)]
        fail = torch.zeros_like(dead)
        for j in range(CHUNK):
            s = terms(rows_c[:, j, :, None].unbind(1), px, py)
            can = ~(fail | dead) & in_tile[:, None]
            test = trans * (1.0 - s["a"])
            passed = test >= T_CUTOFF
            contrib = s["amask"] & ~fail & passed & in_tile[:, None]
            fail = fail | (s["amask"] & ~passed)
            lanes += int(contrib.sum())
            for shape in WARP_SHAPES:
                x0, y0 = origins[shape]
                live = _warp_any(can, shape)
                may = footprint_may(rows_c[:, j, None, :], x0, y0, *shape,
                                    mode) & in_tile[:, None]
                n["live", shape] += int(live.sum())
                n["foot", shape] += int(_warp_any(
                    s["amask"] & in_tile[:, None], shape).sum())
                n["model", shape] += int(may.sum())
                n["evaluated", shape] += int((live & may).sum())
                n["contributing", shape] += int(_warp_any(contrib,
                                                          shape).sum())
            trans = torch.where(contrib, test, trans)
            last = torch.where(contrib, c * CHUNK + j, last)
            dead = ~(trans * (1.0 - ALPHA_MIN) >= T_CUTOFF)
        walking = walking & ~dead.all(1)
    to_last = ((last.amax(1) + CHUNK) // CHUNK).clamp(min=0)
    combos = int(walked.sum()) * CHUNK * 8
    out = dict(tiles=T, windows=int(nwin.sum()),
               windows_walked=int(walked.sum()),
               windows_to_last=int(to_last.sum()),
               evals_past_last=int((walked[:, None] * CHUNK - (last + 1))
                                   .sum()),
               slot_warps_walked=combos, contributing_lanes=lanes,
               **{f"slot_warps_{k}_{w}x{h}": v
                  for (k, (w, h)), v in n.items()})
    share = lambda v: f"{v} ({v / max(combos, 1):.1%})"  # noqa: E731
    print(f"[counts] {label}: {T} tiles; 64-pair windows per tile "
          f"{_quantiles(nwin)}, walked before the block's exit "
          f"{_quantiles(walked)}, up to the tile's last contributor "
          f"{_quantiles(to_last)}; {out['windows']} / "
          f"{out['windows_walked']} / {out['windows_to_last']} in all; "
          f"{out['evals_past_last']} (pair, pixel) evaluations past each "
          f"pixel's last contributor of {out['windows_walked'] * CHUNK * NPIX}"
          f"; (pair, warp) combinations walked {combos}: "
          + "; ".join(
              f"{w}x{h} warps: a pixel can take the pair "
              f"{share(n['live', (w, h)])}, footprint reaches the patch "
              f"{share(n['foot', (w, h)])} (the kernel's test "
              f"{share(n['model', (w, h)])}), both (evaluated) "
              f"{share(n['evaluated', (w, h)])}, contributing "
              f"{share(n['contributing', (w, h)])} with "
              f"{lanes / max(n['contributing', (w, h)], 1):.2f} pixels each"
              for w, h in WARP_SHAPES)
          + f"; {lanes} contributions", flush=True)
    return out


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


def build_variants(specs, build_dir: Path) -> list:
    """nvcc each (label, src, flags) into a shared library of its own, all
    compilers at once -> [(ctypes library, the compiler's resource lines)]
    in the order of `specs`."""
    procs = []
    for label, src, flags in specs:
        key = abs(hash((str(src.resolve()), tuple(flags)))) % 10 ** 8
        lib = build_dir / f"{src.stem}_{key}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(kernels._CSRC), *flags, "-o", str(lib), str(src)]
        procs.append((cmd, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    built = []
    for cmd, lib, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{out}{err}")
        info, entry = [], ""
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            if "registers" in line or "spill" in line:
                info.append(f"{entry[:60]}: {line.split(':', 1)[-1].strip()}")
        built.append((ctypes.CDLL(str(lib)), info))
    return built


def _bind(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = kernels._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch failed with error {err}")


def raster_runner(fn, k1, train: bool, mode: str = "surfel",
                  wet: bool = False):
    """As kernels.raster_blend_fwd: the wet's zeroing is in the time."""
    packed, gidx, bounds, C, tiles_x, tiles_y = k1
    out = torch.empty((C + (11 if train else 6), tiles_y * 16, tiles_x * 16),
                      device=packed.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        w = torch.zeros(gidx.numel(), device=packed.device) if wet else None
        _run(fn, packed.data_ptr(), packed.shape[0], gidx.data_ptr(),
             gidx.numel(), bounds.data_ptr(), C, tiles_x, tiles_y, 0,
             int(train), kernels.MODES[mode], out.data_ptr(),
             w.data_ptr() if wet else None, stream)
        return torch.cat([out.reshape(-1), w]) if wet else out
    return run


def fill_runner(fn, k5):
    """As kernels.fill_forward, with a scratch large enough for either
    design of K5 allocated once."""
    marks, valid = k5
    out = torch.empty_like(marks)
    n = valid.numel()
    scratch = torch.empty(2 * (n // 256 + 2), dtype=torch.int32,
                          device=marks.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _run(fn, marks.data_ptr(), valid.data_ptr(), n, marks.shape[0],
             scratch.data_ptr(), out.data_ptr(), stream)
        return out
    return run


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
    """Median device ms of fn over n runs after one warm-up (CUDA events),
    queued behind a sleep of the card so that the host has enqueued them
    all before the first starts: the events time the card alone, not the
    host's enqueueing between runs (which decides a kernel of some ten
    microseconds)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # some 25 ms of the card's clock
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


FAMILIES = {"raster_blend_fwd": "k1", "trace_blend_fwd": "k3",
            "trace_blend_bwd": "k3", "fill_forward": "k5"}
K1_CONFIGS = {"render": (False, "surfel", False),  # train, mode, wet
              "median": (True, "surfel", False),
              "train": (True, "surfel", False),
              "gauss3d": (True, "gauss3d", True)}


def _family(src: Path) -> str:
    for prefix, fam in FAMILIES.items():
        if src.name.startswith(prefix):
            return fam
    raise ValueError(f"{src.name}: expected a copy of one of "
                     f"{', '.join(f + '.cu' for f in FAMILIES)}")


def _inputs(families) -> dict:
    """The bench scenes' kernel inputs the families need."""
    ins = {}
    if families & {"k1", "k3"}:
        rbase, renv, rcam, rcfg = bench.make_render_scene("cuda")
        ins["k1 render"], ins["k3 render"] = bench.blend_inputs(
            rbase, renv, rcam, rcfg)
        del rbase, renv
    tbase, tenv, tcam, tcfg, _ = bench.make_train_scene("cuda")
    t = bench.train_blend_inputs(tbase, tenv, tcam, tcfg)
    del tbase, tenv
    ins["k1 train"], ins["k3 train"], ins["k5"] = t["k1"], t["k3"], t["k5"]
    if "k1" in families:
        gstate, gcam, gcfg, _, _ = bench.make_gaussiant_scene("cuda")
        ins["k1 gauss3d"] = bench.gaussiant_blend_inputs(gstate.pool, gcam,
                                                         gcfg)[0]
        del gstate
    ins["k1 median"] = ins.get("k1 render")
    return ins


def _runners(family: str, lib, ins: dict, label: str, extra=None) -> list:
    """(name, run) of each configuration a kernel of `family` is timed in."""
    if family == "k1":
        fn = _bind(lib, "raster_blend_fwd")
        return [(f"{label} K1 {cfg}", raster_runner(fn, ins[f"k1 {cfg}"],
                                                    *K1_CONFIGS[cfg]))
                for cfg in K1_CONFIGS]
    if family == "k5":
        return [(f"{label} K5", fill_runner(_bind(lib, "fill_forward"),
                                            ins["k5"]))]
    if extra == "bwd":
        return [(f"{label} bwd", backward_runner(
            _bind(lib, "trace_blend_bwd"), ins["k3 train"], ins["k3 fwd"],
            ins["k3 g_out"]))]
    fn = _bind(lib, "trace_blend_fwd")
    return [(f"{label} fwd {m}", forward_runner(fn, ins[f"k3 {m}"],
                                                m == "train"))
            for m in ("render", "train")]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("blend_variants")
    ap.add_argument("--counts", nargs="?", const="k1,k3", default="",
                    help="k1, k3 or both (the default)")
    ap.add_argument("--build-dir", default=None)
    ap.add_argument("variants", nargs="*", help="label=source.cu[,flag...]")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the blend probe needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    specs = []
    for spec in a.variants:
        label, rest = spec.split("=", 1)
        path, *flags = rest.split(",")
        specs.append((label, Path(path), flags))
    counts = {c for c in a.counts.split(",") if c}
    if counts - {"k1", "k3"}:
        raise ValueError(f"--counts={a.counts}: k1, k3 or both")
    families = counts | {_family(src) for _, src, _ in specs}
    families = families or {"k1", "k3", "k5"}
    lib = kernels._load()
    ins = _inputs(families)
    if "k3" in families:
        k3, k3r = ins["k3 train"], ins["k3 render"]
        ins["k3 fwd"] = kernels.trace_blend_fwd(*k3, True, 0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ins["k3 g_out"] = torch.randn(ins["k3 fwd"].shape, generator=gen,
                                      device="cuda")
        print(f"[inputs] K3 train scene: {k3[4] * k3[5]} tiles, "
              f"{int(k3[3][-1])} candidate slots; render scene: "
              f"{k3r[4] * k3r[5]} tiles, {int(k3r[3][-1])} slots", flush=True)
    if "k1" in families:
        print("[inputs] K1 " + "; ".join(
            f"{cfg}: {ins[f'k1 {cfg}'][4] * ins[f'k1 {cfg}'][5]} tiles, "
            f"{int(ins[f'k1 {cfg}'][2][-1])} pair slots"
            for cfg in ("render", "train", "gauss3d")), flush=True)
    results = {}
    if "k1" in counts:
        for cfg in ("render", "train", "gauss3d"):
            results[f"counts_k1_{cfg}"] = raster_counts(
                ins[f"k1 {cfg}"], K1_CONFIGS[cfg][1], f"K1 {cfg}")
    if "k3" in counts:
        results["counts_fwd_train"] = forward_counts(ins["k3 train"])
        results["counts_fwd_render"] = forward_counts(ins["k3 render"])
        results["counts_bwd"] = backward_counts(ins["k3 train"],
                                                ins["k3 fwd"])

    build_dir = Path(a.build_dir or kernels._BUILD / "variants")
    build_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for fam in sorted(families):
        runs += _runners(fam, lib, ins, "repo")
        if fam == "k3":
            runs += _runners(fam, lib, ins, "repo", "bwd")
    want = {name: run() for name, run in runs}
    want = {k: tuple(x.clone() for x in v) if isinstance(v, tuple)
            else v.clone() for k, v in want.items()}
    cols = list(range(16)) + [31]
    per_ray = lambda x: x[:, :6].transpose(0, 1).reshape(6, -1).T  # noqa: E731
    for (label, src, flags), (vlib, info) in zip(
            specs, build_variants(specs, build_dir)):
        for line in info:
            print(f"[build] {label}: {line}", flush=True)
        fam = _family(src)
        extra = "bwd" if src.name.startswith("trace_blend_bwd") else None
        for name, run in _runners(fam, vlib, ins, label, extra):
            ref = want["repo" + name[len(label):]]
            got = run()
            if extra == "bwd":
                rays = _worst_column(per_ray(got[1]), per_ray(ref[1]))
                err = (f"worst column "
                       f"{_worst_column(got[0][:, cols], ref[0][:, cols]):.3g}"
                       f", rays {rays:.3g}")
            elif fam == "k5":
                err = f"{int((got != ref).sum())} positions differ"
            else:
                err = f"max abs {float((got - ref).abs().max()):.3g}"
            print(f"[check] {name}: against the library's kernel {err}",
                  flush=True)
            runs.append((name, run))
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

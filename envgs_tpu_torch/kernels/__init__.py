"""Hand-written CUDA kernels of the port, built at first use.

The sources under `csrc/` have a plain C interface. The first launch on a
CUDA tensor compiles them with nvcc for sm_90a into one shared library
under `envgs_tpu_torch/_build/` (keyed by a hash of the sources and flags,
so an edit rebuilds) and loads it with ctypes. Importing this module
touches neither nvcc nor the card.

`LAUNCHES` counts launches per kernel, per geometry mode for the raster
blends (the surfel launches under the kernel's name, the gauss3d ones under
`<name>_gauss3d`), per configuration for the raster blend's forward (K1's
`needs` and layout: `raster_blend_fwd_key`) and for the traced blend's
forward (the render and training launches under its name, the geometry and
forward-wet ones under `<name>_geo` and `<name>_wet`), and the 3DGS
projection's forward and backward apart (`project3d_fwd`, `project3d_bwd`),
the env cull's sequence of kernels as one (`env_cull`); each wrapper adds
one where it launches its kernel and nowhere else.
`ROW_OFF_LAUNCHES` counts, under the same keys, the raster blends' launches
at a row offset other than 0 (a band of a larger image).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

# K1's compiled configurations in the surfel mode, (need_dist, need_med,
# need_wet, aligned) as the JAX kernel's static switches: the wet only on
# the aligned layout. The gauss3d mode is compiled all on and aligned.
K1_CONFIGS = tuple((d, m, w, a) for a in (False, True) for d in (False, True)
                   for m in (False, True)
                   for w in ((False, True) if a else (False,)))


def raster_blend_fwd_key(needs=(False, False, False), aligned: bool = False,
                         mode: str = "surfel") -> str:
    """K1's LAUNCHES key of a configuration: `raster_blend_fwd` for the
    render (unaligned, `needs` all off), `raster_blend_fwd_gauss3d` for the
    gauss3d mode, else `raster_blend_fwd` with `_aligned`, `_dist`, `_med`
    and `_wet` for the switches that are on (the training step's:
    `raster_blend_fwd_aligned_dist_med`). Raises for a configuration that
    is not compiled."""
    d, m, w = map(bool, needs)
    if mode == "gauss3d" and (d, m, w, aligned) == (True,) * 4:
        return "raster_blend_fwd_gauss3d"
    if mode != "surfel" or (d, m, w, bool(aligned)) not in K1_CONFIGS:
        raise ValueError(
            f"K1 mode={mode!r} needs={tuple(needs)} aligned={aligned}: not "
            "compiled (the wet needs the aligned layout; gauss3d runs all "
            "on, aligned)")
    return "raster_blend_fwd" + "".join(
        f"_{k}" for k, on in (("aligned", aligned), ("dist", d), ("med", m),
                              ("wet", w)) if on)


LAUNCHES = {**{raster_blend_fwd_key(c[:3], c[3]): 0 for c in K1_CONFIGS},
            "raster_blend_fwd_gauss3d": 0,
            "raster_blend_bwd": 0, "raster_blend_bwd_gauss3d": 0,
            "trace_blend_fwd": 0, "trace_blend_fwd_geo": 0,
            "trace_blend_fwd_wet": 0, "trace_blend_bwd": 0, "fill_forward": 0,
            "segscan": 0, "gather_rows": 0, "gather_rows_win8": 0,
            "project3d_fwd": 0, "project3d_bwd": 0, "env_cull": 0}
ROW_OFF_LAUNCHES = {k: 0 for k in LAUNCHES if k.startswith("raster_blend")}
MODES = {"surfel": 0, "gauss3d": 1}  # geometry of the raster blends
# the traced blend's forward configurations counted apart (LAUNCHES keys
# `trace_blend_fwd_<config>`)
TRACE_CONFIGS = ("geo", "wet")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SOURCES = ("raster_blend_fwd.cu", "raster_blend_bwd.cu",
            "trace_blend_fwd.cu", "trace_blend_bwd.cu", "fill_forward.cu",
            "segscan.cu", "gather_rows.cu", "project3d.cu", "env_cull.cu")
# included by sources, hashed with them
_HEADERS = ("trace_blend.cuh", "project3d.cuh", "env_cull.cuh")
# -fmad=false: the kernels round every product and sum on its own, as the
# plain PyTorch versions' elementwise ops do, so the two agree to the last
# bits on the card instead of only to a tolerance (the projection's 3-term
# products are explicit fused multiply-adds: cuBLAS sums the plain
# version's so). No fast math: expf, IEEE division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
    # row_off, dist, med, aligned, mode, out, wet, stream
    "raster_blend_fwd": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _I, _I, _I,
                         _I, _VP, _VP, _VP],
    # dist, med, wet, aligned, mode, out (4 ints)
    "raster_blend_fwd_resources": [_I, _I, _I, _I, _I, _VP],
    # packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
    # row_off, mode, fwd, gout, gpacked, stream
    "raster_blend_bwd": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _I, _VP, _VP,
                         _VP, _VP],
    # mode, out (3 ints)
    "raster_blend_bwd_resources": [_I, _VP],
    # packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y,
    # mode, A, out, wet, stream
    "trace_blend_fwd": [_VP, _I, _VP, _I, _VP, _VP, _I, _I, _I, _I, _VP,
                        _VP, _VP],
    # mode, A, wet, out (4 ints)
    "trace_blend_fwd_resources": [_I, _I, _I, _VP],
    # packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y, A,
    # fwd, gout, gpacked, grays, stream
    "trace_blend_bwd": [_VP, _I, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP,
                        _VP, _VP, _VP],
    # A, out (4 ints)
    "trace_blend_bwd_resources": [_I, _VP],
    # vals, valid, n, C, scratch, out, stream
    "fill_forward": [_VP, _VP, _I, _I, _VP, _VP, _VP],
    # out (4 ints)
    "fill_forward_resources": [_VP],
    # rows, flags, n, status, counter, out, stream
    "segscan": [_VP, _VP, _I, _VP, _VP, _VP, _VP],
    # out (4 ints)
    "segscan_resources": [_VP],
    # table, idx, n, S, row_bytes, out, stream
    "gather_rows": [_VP, _VP, _I, _I, _I, _VP, _VP],
    "gather_rows_win8": [_VP, _VP, _I, _I, _I, _VP, _VP],
    # means, quats, scales, opac, active, filter, cam, params, P, W, H,
    # compensate, conic, center, depth, radius, valid, ext, rowcull,
    # opac_out, stream
    "project3d_fwd": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                      _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
    # means, quats, scales, opac, filter, cam, params, P, W, H, compensate,
    # g_conic, g_center, g_depth, g_opac, d_means, d_quats, d_scales,
    # d_opac, stream
    "project3d_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP,
                      _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
    # out (4 ints)
    "project3d_fwd_resources": [_VP],
    "project3d_bwd_resources": [_VP],
    # cmean, crad, cact, cand, order, apex, axis, tan_half, spread, tmask,
    # pframe, pbox, pok, T, NC, Kc, P, cap, clist, calt, ints, offs, keys,
    # alt, gauss, bounds, small, met, stream
    "env_cull": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                 _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                 _VP, _VP, _VP, _VP],
    # out (5 kernels x 4 ints)
    "env_cull_resources": [_VP],
}
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _nvcc_all(cmds):
    """Run the nvcc commands at once; raise on the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path. Each source compiles in its own nvcc
    process, all started together; one more links them."""
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*srcs, *(_CSRC / name for name in _HEADERS)):
        h.update(s.read_bytes())
    lib = _BUILD / f"libenvgs_kernels_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [lib.with_name(f"{s.stem}.{tag}.o") for s in srcs]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        try:
            _nvcc_all([[_nvcc(), *compile_flags, "-c", "-o", str(o), str(s)]
                       for s, o in zip(srcs, objs)])
            tmp = lib.with_suffix(f".{tag}")
            _nvcc_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           like: torch.Tensor | None = None, shape=None):
    """Raise unless t is a contiguous CUDA tensor of `dtype` (on the card of
    `like`, and of `shape`, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, the table on {like.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _check_table(packed: torch.Tensor):
    _check("packed", packed, torch.float32)
    if packed.dim() != 2 or packed.shape[1] != 32:
        raise ValueError(f"packed: expected (P+1, 32), "
                         f"got {tuple(packed.shape)}")


def _launch(name: str, device: torch.device, *args, count: str | None = None):
    """Call the library's `name` and count the launch under `count`
    (default: `name`)."""
    with torch.cuda.device(device):  # the runtime launches on its current card
        err = getattr(_load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[count or name] += 1


def _mode(name: str, mode: str):
    """(mode's int code, LAUNCHES key) of a raster blend launch."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {sorted(MODES)}")
    return MODES[mode], name if mode == "surfel" else f"{name}_{mode}"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raster_blend_fwd(packed, gauss_idx, tile_bounds, C: int, tiles_x: int,
                     tiles_y: int, row_off: int = 0,
                     needs=(False, False, False), mode: str = "surfel",
                     aligned: bool = False):
    """Kernel K1 (csrc/raster_blend_fwd.cu) in the configuration `needs` =
    (need_dist, need_med, need_wet) on the `aligned` or the unaligned pair
    layout -> (C + 11, tiles_y*16, tiles_x*16) f32 with need_dist or
    need_med, else (C + 6, ...); with need_wet, also the per-pair wet
    (gauss_idx.numel(),) f32. See ops/raster_blend.py for the contract."""
    T = tiles_x * tiles_y
    key = raster_blend_fwd_key(needs, aligned, mode)
    dist, med, wet = map(bool, needs)
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    if not 1 <= C <= 7:
        raise ValueError(f"C={C}: the blend carries 1..7 color channels")
    out = torch.empty((C + (11 if dist or med else 6), tiles_y * 16,
                       tiles_x * 16), dtype=torch.float32,
                      device=packed.device)
    wet_pairs = (torch.zeros(gauss_idx.numel(), dtype=torch.float32,
                             device=packed.device) if wet else None)
    if T:
        _launch("raster_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                tile_bounds.data_ptr(), C, tiles_x, tiles_y, row_off,
                int(dist), int(med), int(aligned), MODES[mode],
                out.data_ptr(), wet_pairs.data_ptr() if wet else None,
                _stream(packed), count=key)
        ROW_OFF_LAUNCHES[key] += bool(row_off)
    return (out, wet_pairs) if wet else out


def raster_blend_fwd_resources(needs=(False, False, False),
                               aligned: bool = False,
                               mode: str = "surfel") -> dict:
    """What K1 was compiled to in a configuration (as raster_blend_fwd
    takes it): registers per thread, static shared bytes per block,
    resident blocks per SM on the current card, local (spill) bytes per
    thread. Launches nothing and counts nothing."""
    raster_blend_fwd_key(needs, aligned, mode)
    return _resources("raster_blend_fwd_resources", *map(int, needs),
                      int(aligned), MODES[mode])


def raster_blend_bwd(packed, gauss_idx, tile_bounds, fwd, g_out, C: int,
                     tiles_x: int, tiles_y: int, row_off: int = 0,
                     mode: str = "surfel") -> torch.Tensor:
    """Kernel K2 (csrc/raster_blend_bwd.cu): training planes `fwd` of K1 and
    their cotangents `g_out` -> (P+1, 32) f32 table gradient, per-splat wet
    in column 31; see ops/raster_blend.py for the contract."""
    T = tiles_x * tiles_y
    code, key = _mode("raster_blend_bwd", mode)
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    planes = (C + 11, tiles_y * 16, tiles_x * 16)
    _check("fwd", fwd, torch.float32, packed, planes)
    _check("g_out", g_out, torch.float32, packed, planes)
    if not 1 <= C <= 7:
        raise ValueError(f"C={C}: the blend carries 1..7 color channels")
    g_packed = torch.zeros_like(packed)
    if T:
        _launch("raster_blend_bwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                tile_bounds.data_ptr(), C, tiles_x, tiles_y, row_off, code,
                fwd.data_ptr(), g_out.data_ptr(), g_packed.data_ptr(),
                _stream(packed), count=key)
        ROW_OFF_LAUNCHES[key] += bool(row_off)
    return g_packed


def _resources(name: str, *codes: int) -> dict:
    """What the library's `name` reports of a kernel as compiled; a fourth
    int, where the function writes one, is the local (spill) bytes."""
    out = (ctypes.c_int * 4)(0, 0, 0, -1)
    err = getattr(_load(), name)(*codes, out)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    res = dict(registers=out[0], shared_bytes=out[1], blocks_per_sm=out[2])
    if out[3] >= 0:
        res["local_bytes"] = out[3]
    return res


def raster_blend_bwd_resources(mode: str = "surfel") -> dict:
    """What K2 was compiled to for `mode`: registers per thread, static
    shared bytes per block and resident blocks per SM on the current card.
    Builds the kernels if need be; launches nothing and counts nothing."""
    code, _ = _mode("raster_blend_bwd", mode)
    return _resources("raster_blend_bwd_resources", code)


def _trace_config(train: bool, A: int, geo: bool = False,
                  wet: bool = False):
    """(mode code, planes, LAUNCHES key) of a K3 configuration: render,
    geometry (`geo`), training (`train`), or training with the forward
    wet (`train` and `wet`)."""
    if not 0 <= A <= 2:
        raise ValueError(f"A={A}: the traced blend carries 0..2 aux channels")
    if wet and not train:
        raise ValueError("wet: the forward wet is a training configuration's")
    if train:
        return 2, 13 + A, "trace_blend_fwd_wet" if wet else "trace_blend_fwd"
    return (1, 10 + A, "trace_blend_fwd_geo") if geo else (
        0, 5, "trace_blend_fwd")


def trace_blend_fwd(packed, gauss_idx, rays, tile_bounds, tiles_x: int,
                    tiles_y: int, train: bool = False, A: int = 0,
                    geo: bool = False, wet: bool = False):
    """Kernel K3 (csrc/trace_blend_fwd.cu) -> (5, tiles_y*16, tiles_x*16)
    f32: rgb, acc, T; with `geo` (10 + A, ...), with `train` (13 + A, ...),
    in the JAX row order; with `train` and `wet`, also the per-slot forward
    wet (gauss_idx.numel(),) f32. See ops/trace_blend.py for the
    contract."""
    T = tiles_x * tiles_y
    code, planes, key = _trace_config(train, A, geo, wet)
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("rays", rays, torch.float32, packed, (T, 8, 256))
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    out = torch.empty((planes, tiles_y * 16, tiles_x * 16),
                      dtype=torch.float32, device=packed.device)
    # slots the kernel never walks (past a tile's exit) keep these zeros
    wet_slots = (torch.zeros(gauss_idx.numel(), dtype=torch.float32,
                             device=packed.device) if wet else None)
    if T:
        _launch("trace_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                rays.data_ptr(), tile_bounds.data_ptr(), tiles_x, tiles_y,
                code, A, out.data_ptr(),
                wet_slots.data_ptr() if wet else None, _stream(packed),
                count=key)
    return (out, wet_slots) if wet else out


def trace_blend_fwd_resources(train: bool = False, A: int = 0,
                              geo: bool = False, wet: bool = False) -> dict:
    """What K3 was compiled to in a configuration (as trace_blend_fwd takes
    it): registers per thread, static shared bytes per block, resident
    blocks per SM on the current card, local (spill) bytes per thread.
    Launches nothing and counts nothing."""
    code, _, _ = _trace_config(train, A, geo, wet)
    return _resources("trace_blend_fwd_resources", code, A, int(wet))


def trace_blend_bwd_resources(A: int = 0) -> dict:
    """What K4 was compiled to for A aux channels, as
    trace_blend_fwd_resources."""
    _trace_config(True, A)
    return _resources("trace_blend_bwd_resources", A)


def trace_blend_bwd(packed, gauss_idx, rays, tile_bounds, fwd, g_out,
                    tiles_x: int, tiles_y: int, A: int = 0):
    """Kernel K4 (csrc/trace_blend_bwd.cu): training planes `fwd` of K3 and
    their cotangents -> ((P+1, 32) table gradient with the per-splat wet in
    column 31, (T, 8, 256) ray gradient); see ops/trace_blend.py."""
    T = tiles_x * tiles_y
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("rays", rays, torch.float32, packed, (T, 8, 256))
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    planes = (_trace_config(True, A)[1], tiles_y * 16, tiles_x * 16)
    _check("fwd", fwd, torch.float32, packed, planes)
    _check("g_out", g_out, torch.float32, packed, planes)
    g_packed = torch.zeros_like(packed)
    g_rays = torch.empty_like(rays)
    if T:
        _launch("trace_blend_bwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                rays.data_ptr(), tile_bounds.data_ptr(), tiles_x, tiles_y, A,
                fwd.data_ptr(), g_out.data_ptr(), g_packed.data_ptr(),
                g_rays.data_ptr(), _stream(packed))
    return g_packed, g_rays


FF_BLOCK = 2048  # positions per block of K5


def fill_forward(vals, valid) -> torch.Tensor:
    """Kernel K5 (csrc/fill_forward.cu): vals (C, N) int32, valid (N,) int32
    -> (C, N) int32, each position the values of the last marker at or
    before it (0 before the first). A memset of its status words and one
    launch, counted as one."""
    _check("vals", vals, torch.int32)
    if vals.dim() != 2:
        raise ValueError(f"vals: expected (C, N), got {tuple(vals.shape)}")
    C, N = vals.shape
    _check("valid", valid, torch.int32, vals, (N,))
    if N >= 2 ** 31 - 1024:
        raise ValueError(f"N={N}: positions must fit int32")
    out = torch.empty_like(vals)
    scratch = torch.empty(2 * (-(-N // FF_BLOCK) + 1), dtype=torch.int32,
                          device=vals.device)
    if N:
        _launch("fill_forward", vals.device, vals.data_ptr(),
                valid.data_ptr(), N, C, scratch.data_ptr(), out.data_ptr(),
                _stream(vals))
    return out


def fill_forward_resources() -> dict:
    """What K5 was compiled to, as raster_blend_fwd_resources."""
    return _resources("fill_forward_resources")


SEG_ROWS = 1024  # the TPU kernel's block; N must be a multiple
SEG_LANES = 128
SEG_TILE = 128  # rows per tile (block) of K6


def segscan(rows, seg_start) -> torch.Tensor:
    """Kernel K6 (csrc/segscan.cu): rows (N, 128) f32, seg_start (N,) int32
    (nonzero at a segment's first row), N a multiple of 1024 -> (N, 128)
    f32 inclusive segmented sums. Memsets of its status words and counter
    and one launch, counted as one."""
    _check("rows", rows, torch.float32)
    if (rows.dim() != 2 or rows.shape[1] != SEG_LANES
            or rows.shape[0] % SEG_ROWS):
        raise ValueError(f"rows: expected (N, {SEG_LANES}) with N a multiple "
                         f"of {SEG_ROWS}, got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows: the kernel's 16-byte loads need 16-byte "
                         "alignment")
    N = rows.shape[0]
    _check("seg_start", seg_start, torch.int32, rows, (N,))
    if N >= 2 ** 31 - SEG_ROWS:
        raise ValueError(f"N={N}: rows must fit int32")
    out = torch.empty_like(rows)
    # each tile's status: a 64-bit word per column (value and flag)
    status = torch.empty((N // SEG_TILE, SEG_LANES), dtype=torch.int64,
                         device=rows.device)
    counter = torch.empty(1, dtype=torch.int32, device=rows.device)
    if N:
        _launch("segscan", rows.device, rows.data_ptr(), seg_start.data_ptr(),
                N, status.data_ptr(), counter.data_ptr(), out.data_ptr(),
                _stream(rows))
    return out


def segscan_resources() -> dict:
    """What K6 was compiled to, as raster_blend_fwd_resources."""
    return _resources("segscan_resources")


def _gather(name: str, table, idx) -> torch.Tensor:
    if table.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"table: expected float32, bfloat16 or float16, "
                         f"got {table.dtype}")
    _check("table", table, table.dtype)
    if table.dim() != 2 or table.shape[1] != 128 or table.shape[0] == 0:
        raise ValueError(f"table: expected (S, 128) with S > 0, got "
                         f"{tuple(table.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx: expected (n,), got {tuple(idx.shape)}")
    _check("idx", idx, torch.int32, table)
    S, n = table.shape[0], idx.shape[0]
    if name == "gather_rows_win8" and S % 8:
        raise ValueError(f"table: {S} rows, the TPU kernel's 8-row "
                         "windows need a multiple of 8")
    if S >= 2 ** 31 or n >= 2 ** 31 // 32:
        raise ValueError(f"S={S}, n={n}: too many rows")
    out = torch.empty((n, 128), dtype=table.dtype, device=table.device)
    if n:
        _launch(name, table.device, table.data_ptr(), idx.data_ptr(), n, S,
                128 * table.element_size(), out.data_ptr(), _stream(table))
    return out


def gather_rows(table, idx) -> torch.Tensor:
    """Kernel P1 (csrc/gather_rows.cu): table (S, 128) f32/bf16/f16, idx
    (n,) int32 -> (n, 128), bit-equal to table[idx]; an index outside
    [0, S) is clamped into it."""
    return _gather("gather_rows", table, idx)


def gather_rows_win8(table, idx) -> torch.Tensor:
    """Kernel P2 (csrc/gather_rows.cu): the same gather, each row moved by
    bulk asynchronous copies through a ring in shared memory. S % 8 == 0
    is asked for only so that it takes the calls the TPU kernel, which
    copies 8-row windows, takes."""
    return _gather("gather_rows_win8", table, idx)


PROJECT3D_CAM = 33  # the camera's floats: R, T, K, pix_from_world


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _project3d_inputs(means, quats, scales3, opacities, filter3d, cam,
                      scale_modifier, lowpass2d):
    """Check the projection's inputs; -> (P, the two floats the kernels take
    by value, in host memory)."""
    _check("means", means, torch.float32)
    if means.dim() != 2 or means.shape[1] != 3:
        raise ValueError(f"means: expected (P, 3), got {tuple(means.shape)}")
    P = means.shape[0]
    if P >= 2 ** 31 // 8:  # int32 offsets into the (P, 6) rows
        raise ValueError(f"P={P}: too many splats")
    _check("quats", quats, torch.float32, means, (P, 4))
    if quats.data_ptr() % 16:
        raise ValueError("quats: the kernels' 16-byte loads need 16-byte "
                         "alignment")
    _check("scales3", scales3, torch.float32, means, (P, 3))
    _check("opacities", opacities, torch.float32, means, (P,))
    if filter3d is not None:
        _check("filter3d", filter3d, torch.float32, means, (P,))
    _check("cam", cam, torch.float32, means, (PROJECT3D_CAM,))
    return P, (ctypes.c_float * 2)(scale_modifier, lowpass2d)


def project3d_fwd(means, quats, scales3, opacities, active, filter3d, cam,
                  W: int, H: int, scale_modifier: float, lowpass2d: float,
                  compensate2d: bool):
    """The 3DGS EWA projection's forward (csrc/project3d.cu): means (P, 3),
    quats (P, 4) wxyz, scales3 (P, 3) activated, opacities (P,), active
    (P,) bool or None, filter3d (P,) or None, cam (33,) f32 -> (conic
    (P, 3), center_pix (P, 2), depth, radius (P,), valid (P,) bool, ext
    (P, 2), rowcull (P, 6), the opacity the filters change or None when
    neither the 3D filter nor the compensation is on). See
    ops/project3d.py for the contract."""
    P, params = _project3d_inputs(means, quats, scales3, opacities,
                                  filter3d, cam, scale_modifier, lowpass2d)
    if active is not None:
        _check("active", active, torch.bool, means, (P,))

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=means.device)

    out = (empty(P, 3), empty(P, 2), empty(P), empty(P),
           empty(P, dtype=torch.bool), empty(P, 2), empty(P, 6),
           empty(P) if filter3d is not None or compensate2d else None)
    if P:
        _launch("project3d_fwd", means.device, means.data_ptr(),
                quats.data_ptr(), scales3.data_ptr(), opacities.data_ptr(),
                _ptr(active), _ptr(filter3d), cam.data_ptr(),
                ctypes.addressof(params), P, W, H, int(compensate2d),
                *map(_ptr, out), _stream(means))
    return out


def project3d_bwd(means, quats, scales3, opacities, filter3d, cam, W: int,
                  H: int, scale_modifier: float, lowpass2d: float,
                  compensate2d: bool, g_conic, g_center, g_depth, g_opacity):
    """The projection's backward (csrc/project3d.cu): the forward's inputs
    and the cotangents of conic (P, 3), center_pix (P, 2), depth (P,) and
    the changed opacity (P,), each None for zero -> the gradients of means,
    quats, scales3 and (where g_opacity is given) opacities."""
    P, params = _project3d_inputs(means, quats, scales3, opacities,
                                  filter3d, cam, scale_modifier, lowpass2d)
    for name, g, shape in (("g_conic", g_conic, (P, 3)),
                           ("g_center", g_center, (P, 2)),
                           ("g_depth", g_depth, (P,)),
                           ("g_opacity", g_opacity, (P,))):
        if g is not None:
            _check(name, g, torch.float32, means, shape)
    if g_center is not None and g_center.data_ptr() % 8:
        raise ValueError("g_center: the kernel's 8-byte loads need 8-byte "
                         "alignment")
    if g_opacity is not None and filter3d is None and not compensate2d:
        raise ValueError("g_opacity: the opacity is changed only by the 3D "
                         "filter or the compensation")
    d_means = torch.empty_like(means)
    d_quats = torch.empty_like(quats)
    d_scales = torch.empty_like(scales3)
    d_opac = torch.empty_like(opacities) if g_opacity is not None else None
    if P:
        _launch("project3d_bwd", means.device, means.data_ptr(),
                quats.data_ptr(), scales3.data_ptr(), opacities.data_ptr(),
                _ptr(filter3d), cam.data_ptr(), ctypes.addressof(params), P,
                W, H, int(compensate2d), _ptr(g_conic), _ptr(g_center),
                _ptr(g_depth), _ptr(g_opacity), d_means.data_ptr(),
                d_quats.data_ptr(), d_scales.data_ptr(), _ptr(d_opac),
                _stream(means))
    return d_means, d_quats, d_scales, d_opac


def project3d_fwd_resources() -> dict:
    """What the projection's forward was compiled to, as
    raster_blend_fwd_resources."""
    return _resources("project3d_fwd_resources")


def project3d_bwd_resources() -> dict:
    """What the projection's backward was compiled to, as
    raster_blend_fwd_resources."""
    return _resources("project3d_bwd_resources")


ENV_CULL_KERNELS = ("coarse", "refine_count", "refine_write", "sort_chunks",
                    "sort_candidates")


def env_cull(cmean, crad, cact, cand, order, apex, axis, tan_half, spread,
             tile_mask, probe_frame, probe_box, probe_ok, Kc: int, P: int,
             cap: int):
    """The env cull (csrc/env_cull.cu) over NC Morton chunks and T ray
    tiles: chunk spheres cmean (NC, 3), crad (NC,), cact (NC,) bool; the
    candidate table cand (NC, 8, 64) (mx my mz rad nx ny nz rc) and order
    (NC * 64,) int32 pool indices (P for none); the tiles' apex, axis (T,
    3), tan_half, spread (T,), tile_mask (T,) bool, probe_frame (T, 2, 3),
    probe_box (T, 4, 10) and probe_ok (T,) bool, or None for no probe; Kc
    chunks a tile, P pool slots, cap output slots (a multiple of 1024) ->
    (gauss_idx (cap,) int32, tile_bounds (T + 1,) int32, dropped () int32,
    cut () int32, met () int64: the (tile, chunk) pairs that met). See
    ops/tracer.py::cull_and_sort for the contract. Sizes every buffer from
    T, Kc, NC and cap: nothing waits for the card."""
    NC = cmean.shape[0]
    T = apex.shape[0]
    _check("cmean", cmean, torch.float32, shape=(NC, 3))
    dev = cmean.device
    _check("crad", crad, torch.float32, cmean, (NC,))
    _check("cact", cact, torch.bool, cmean, (NC,))
    _check("cand", cand, torch.float32, cmean, (NC, 8, 64))
    _check("order", order, torch.int32, cmean, (NC * 64,))
    _check("apex", apex, torch.float32, cmean, (T, 3))
    _check("axis", axis, torch.float32, cmean, (T, 3))
    _check("tan_half", tan_half, torch.float32, cmean, (T,))
    _check("spread", spread, torch.float32, cmean, (T,))
    _check("tile_mask", tile_mask, torch.bool, cmean, (T,))
    _check("probe_frame", probe_frame, torch.float32, cmean, (T, 2, 3))
    _check("probe_box", probe_box, torch.float32, cmean, (T, 4, 10))
    if probe_ok is not None:
        _check("probe_ok", probe_ok, torch.bool, cmean, (T,))
    Kcap = max(min(Kc, NC), 1)
    if not 1 <= Kc or cap % 1024 or not 0 <= cap < 2 ** 31 - Kc * 64:
        raise ValueError(f"Kc={Kc}, cap={cap}: Kc >= 1 and the slots, a "
                         "multiple of 1024, must be int32 offsets")

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    clist, calt = empty(T * Kcap, torch.int64), empty(T * Kcap, torch.int64)
    ints = empty(4 * T, torch.int32)
    offs = empty(2 * (T + 1), torch.int64)
    # a tile's keys sit at its slot offset, which starts within the budget
    nb = cap + Kc * 64
    keys, alt = empty(nb, torch.int64), empty(nb, torch.int64)
    gauss = torch.full((cap,), P, dtype=torch.int32, device=dev)
    bounds = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    small = torch.zeros(2, dtype=torch.int32, device=dev)  # dropped, cut
    met = torch.zeros(1, dtype=torch.int64, device=dev)
    if T:
        _launch("env_cull", dev, *(t.data_ptr() for t in (
            cmean, crad, cact, cand, order, apex, axis, tan_half, spread,
            tile_mask, probe_frame, probe_box)), _ptr(probe_ok), T, NC, Kc,
            P, cap, *(t.data_ptr() for t in (
                clist, calt, ints, offs, keys, alt, gauss, bounds, small,
                met)), _stream(cmean))
    return gauss, bounds, small[0], small[1], met[0]


def env_cull_resources() -> dict:
    """What the env cull's kernels were compiled to: each of
    ENV_CULL_KERNELS's registers, static shared bytes, resident blocks per
    SM and local bytes under `kernels`, and the refine's (the write pass)
    at the top level, as raster_blend_fwd_resources."""
    out = (ctypes.c_int * (4 * len(ENV_CULL_KERNELS)))()
    err = _load().env_cull_resources(out)
    if err != 0:
        raise RuntimeError(f"env_cull_resources: CUDA error {err}")
    per = {name: dict(registers=out[4 * i], shared_bytes=out[4 * i + 1],
                      blocks_per_sm=out[4 * i + 2],
                      local_bytes=out[4 * i + 3])
           for i, name in enumerate(ENV_CULL_KERNELS)}
    return dict(per["refine_write"], kernels=per)

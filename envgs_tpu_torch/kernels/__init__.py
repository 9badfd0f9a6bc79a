"""Hand-written CUDA kernels of the port, built at first use.

The sources under `csrc/` have a plain C interface. The first launch on a
CUDA tensor compiles them with nvcc for sm_90a into one shared library
under `envgs_tpu_torch/_build/` (keyed by a hash of the sources and flags,
so an edit rebuilds) and loads it with ctypes. Importing this module
touches neither nvcc nor the card.

`LAUNCHES` counts launches per kernel, and per geometry mode for the
raster blends (the surfel launches under the kernel's name, the gauss3d
ones under `<name>_gauss3d`); each wrapper adds one where it launches its
kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LAUNCHES = {"raster_blend_fwd": 0, "raster_blend_fwd_gauss3d": 0,
            "raster_blend_bwd": 0, "raster_blend_bwd_gauss3d": 0,
            "trace_blend_fwd": 0, "trace_blend_bwd": 0, "fill_forward": 0,
            "segscan": 0, "gather_rows": 0, "gather_rows_win8": 0}
MODES = {"surfel": 0, "gauss3d": 1}  # geometry of the raster blends

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SOURCES = ("raster_blend_fwd.cu", "raster_blend_bwd.cu",
            "trace_blend_fwd.cu", "trace_blend_bwd.cu", "fill_forward.cu",
            "segscan.cu", "gather_rows.cu")
_HEADERS = ("trace_blend.cuh",)  # included by sources, hashed with them
# -fmad=false: the kernels round every product and sum on its own, as the
# plain PyTorch versions' elementwise ops do, so the two agree to the last
# bits on the card instead of only to a tolerance. No fast math: expf, IEEE
# division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
    # row_off, train, mode, out, wet, stream
    "raster_blend_fwd": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _I, _I, _VP,
                         _VP, _VP],
    # train, mode, wet, out (4 ints)
    "raster_blend_fwd_resources": [_I, _I, _I, _VP],
    # packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
    # row_off, mode, fwd, gout, gpacked, stream
    "raster_blend_bwd": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _I, _VP, _VP,
                         _VP, _VP],
    # mode, out (3 ints)
    "raster_blend_bwd_resources": [_I, _VP],
    # packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y,
    # train, A, out, stream
    "trace_blend_fwd": [_VP, _I, _VP, _I, _VP, _VP, _I, _I, _I, _I, _VP,
                        _VP],
    # train, A, out (4 ints)
    "trace_blend_fwd_resources": [_I, _I, _VP],
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
    # rows, flags, n, tails, has_start, out, stream
    "segscan": [_VP, _VP, _I, _VP, _VP, _VP, _VP],
    # table, idx, n, S, row_bytes, out, stream
    "gather_rows": [_VP, _VP, _I, _I, _I, _VP, _VP],
    "gather_rows_win8": [_VP, _VP, _I, _I, _I, _VP, _VP],
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
                     tiles_y: int, row_off: int = 0, train: bool = False,
                     mode: str = "surfel", wet: bool = False):
    """Kernel K1 (csrc/raster_blend_fwd.cu) -> (C + 6, tiles_y*16,
    tiles_x*16) f32, or (C + 11, ...) with `train`; with `wet`, also the
    per-pair wet (gauss_idx.numel(),) f32. See ops/raster_blend.py for the
    contract."""
    T = tiles_x * tiles_y
    code, key = _mode("raster_blend_fwd", mode)
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    if not 1 <= C <= 7:
        raise ValueError(f"C={C}: the blend carries 1..7 color channels")
    out = torch.empty((C + (11 if train else 6), tiles_y * 16, tiles_x * 16),
                      dtype=torch.float32, device=packed.device)
    wet_pairs = (torch.zeros(gauss_idx.numel(), dtype=torch.float32,
                             device=packed.device) if wet else None)
    if T:
        _launch("raster_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                tile_bounds.data_ptr(), C, tiles_x, tiles_y, row_off,
                int(train), code, out.data_ptr(),
                wet_pairs.data_ptr() if wet else None, _stream(packed),
                count=key)
    return (out, wet_pairs) if wet else out


def raster_blend_fwd_resources(train: bool = False, mode: str = "surfel",
                               wet: bool = False) -> dict:
    """What K1 was compiled to for (train, mode, wet): registers per
    thread, static shared bytes per block, resident blocks per SM on the
    current card, local (spill) bytes per thread. Launches nothing and
    counts nothing."""
    code, _ = _mode("raster_blend_fwd", mode)
    return _resources("raster_blend_fwd_resources", int(train), code,
                      int(wet))


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


def _trace_planes(train: bool, A: int) -> int:
    if not 0 <= A <= 2:
        raise ValueError(f"A={A}: the traced blend carries 0..2 aux channels")
    return 13 + A if train else 5


def trace_blend_fwd(packed, gauss_idx, rays, tile_bounds, tiles_x: int,
                    tiles_y: int, train: bool = False,
                    A: int = 0) -> torch.Tensor:
    """Kernel K3 (csrc/trace_blend_fwd.cu) -> (5, tiles_y*16, tiles_x*16)
    f32: rgb, acc, T, or with `train` (13 + A, ...) in the JAX row order;
    see ops/trace_blend.py for the contract."""
    T = tiles_x * tiles_y
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("rays", rays, torch.float32, packed, (T, 8, 256))
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    out = torch.empty((_trace_planes(train, A), tiles_y * 16, tiles_x * 16),
                      dtype=torch.float32, device=packed.device)
    if T:
        _launch("trace_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                rays.data_ptr(), tile_bounds.data_ptr(), tiles_x, tiles_y,
                int(train), A, out.data_ptr(), _stream(packed))
    return out


def trace_blend_fwd_resources(train: bool = False, A: int = 0) -> dict:
    """What K3 was compiled to, the render kernel or the training kernel
    with A aux channels: registers per thread, static shared bytes per
    block, resident blocks per SM on the current card, local (spill) bytes
    per thread. Launches nothing and counts nothing."""
    _trace_planes(train, A)
    return _resources("trace_blend_fwd_resources", int(train), A)


def trace_blend_bwd_resources(A: int = 0) -> dict:
    """What K4 was compiled to for A aux channels, as
    trace_blend_fwd_resources."""
    _trace_planes(True, A)
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
    planes = (_trace_planes(True, A), tiles_y * 16, tiles_x * 16)
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


SEG_ROWS = 1024  # rows per block of K6; N must be a multiple
SEG_LANES = 128


def segscan(rows, seg_start) -> torch.Tensor:
    """Kernel K6 (csrc/segscan.cu): rows (N, 128) f32, seg_start (N,) int32
    (nonzero at a segment's first row), N a multiple of 1024 -> (N, 128)
    f32 inclusive segmented sums. Three launches, counted as one."""
    _check("rows", rows, torch.float32)
    if (rows.dim() != 2 or rows.shape[1] != SEG_LANES
            or rows.shape[0] % SEG_ROWS):
        raise ValueError(f"rows: expected (N, {SEG_LANES}) with N a multiple "
                         f"of {SEG_ROWS}, got {tuple(rows.shape)}")
    N = rows.shape[0]
    _check("seg_start", seg_start, torch.int32, rows, (N,))
    if N >= 2 ** 31 - SEG_ROWS:
        raise ValueError(f"N={N}: rows must fit int32")
    out = torch.empty_like(rows)
    nb = N // SEG_ROWS
    tails = torch.empty((nb, SEG_LANES), dtype=torch.float32,
                        device=rows.device)
    has_start = torch.empty(nb, dtype=torch.int32, device=rows.device)
    if N:
        _launch("segscan", rows.device, rows.data_ptr(), seg_start.data_ptr(),
                N, tails.data_ptr(), has_start.data_ptr(), out.data_ptr(),
                _stream(rows))
    return out


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

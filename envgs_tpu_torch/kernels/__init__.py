"""Hand-written CUDA kernels of the port, built at first use.

The sources under `csrc/` have a plain C interface. The first launch on a
CUDA tensor compiles them with nvcc for sm_90a into one shared library
under `envgs_tpu_torch/_build/` (keyed by a hash of the sources and flags,
so an edit rebuilds) and loads it with ctypes. Importing this module
touches neither nvcc nor the card.

`LAUNCHES` counts launches per kernel; each wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LAUNCHES = {"raster_blend_fwd": 0, "trace_blend_fwd": 0}

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SOURCES = ("raster_blend_fwd.cu", "trace_blend_fwd.cu")
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
    # row_off, out, stream
    "raster_blend_fwd": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _I, _VP, _VP],
    # packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y,
    # out, stream
    "trace_blend_fwd": [_VP, _I, _VP, _I, _VP, _VP, _I, _I, _VP, _VP],
}
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path."""
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    lib = _BUILD / f"libenvgs_kernels_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
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


def _launch(name: str, device: torch.device, *args):
    with torch.cuda.device(device):  # the runtime launches on its current card
        err = getattr(_load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raster_blend_fwd(packed, gauss_idx, tile_bounds, C: int, tiles_x: int,
                     tiles_y: int, row_off: int = 0) -> torch.Tensor:
    """Kernel K1 (csrc/raster_blend_fwd.cu) -> (C + 6, tiles_y*16,
    tiles_x*16) f32; see ops/raster_blend.py for the contract."""
    T = tiles_x * tiles_y
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    if not 1 <= C <= 7:
        raise ValueError(f"C={C}: the blend carries 1..7 color channels")
    out = torch.empty((C + 6, tiles_y * 16, tiles_x * 16),
                      dtype=torch.float32, device=packed.device)
    if T:
        _launch("raster_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                tile_bounds.data_ptr(), C, tiles_x, tiles_y, row_off,
                out.data_ptr(), _stream(packed))
    return out


def trace_blend_fwd(packed, gauss_idx, rays, tile_bounds, tiles_x: int,
                    tiles_y: int) -> torch.Tensor:
    """Kernel K3 (csrc/trace_blend_fwd.cu) -> (5, tiles_y*16, tiles_x*16)
    f32: rgb, acc, T; see ops/trace_blend.py for the contract."""
    T = tiles_x * tiles_y
    _check_table(packed)
    _check("gauss_idx", gauss_idx, torch.int32, packed)
    _check("rays", rays, torch.float32, packed, (T, 8, 256))
    _check("tile_bounds", tile_bounds, torch.int32, packed, (T + 1,))
    out = torch.empty((5, tiles_y * 16, tiles_x * 16), dtype=torch.float32,
                      device=packed.device)
    if T:
        _launch("trace_blend_fwd", packed.device, packed.data_ptr(),
                packed.shape[0], gauss_idx.data_ptr(), gauss_idx.numel(),
                rays.data_ptr(), tile_bounds.data_ptr(), tiles_x, tiles_y,
                out.data_ptr(), _stream(packed))
    return out

"""Per-tile traced blend of the surfel tracer: the plain PyTorch version
and the wrapper of its CUDA kernel K3 (the forward kernel of
envgs_tpu/ops/tracer.py, render mode: need_geo, need_dist and need_wet
off).

Both take the per-splat scene table `packed` ((P+1, LO) f32 in pool order,
last row the zero sentinel; column layout below), the per-slot splat
indices of `ops/tracer.py::cull_and_sort` (tile ranges 64-aligned, padding
slots hold the sentinel P), the ray tiles (T, 8, 256) and the per-tile
slot ranges, and return image-layout planes (5, tiles_y*16, tiles_x*16):
rgb (3), acc, final T.

Blend rule (the JAX kernel's, kept exactly): each tile walks its slots in
64-slot chunks from its range start. A candidate contributes iff its alpha
passes the 1/255 floor, t > T_MIN and |d.n| >= 1e-9, and T*(1-a) >= 1e-4;
within one chunk, the first candidate that fails the transmittance test
ends the chunk for that ray, and the next chunk starts afresh from T.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_CUTOFF
from envgs_tpu_torch.ops.raster_blend import CHUNK, NPIX, _to_image

T_MIN = 1e-4  # minimum ray parameter (self-hit guard)
NOUT = 5  # rgb, acc, T
# packed column layout (shared with envgs_tpu.ops.tracer)
_C_MEAN = 0  # 3
_C_TU = 3  # 3 (tangent / scale_u)
_C_TV = 6  # 3
_C_N = 9  # 3
_C_OPAC = 12
_C_COLOR = 13  # 3
_C_AUX = 16  # A <= 2


def trace_blend_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                      rays: torch.Tensor, tile_bounds: torch.Tensor,
                      tiles_x: int, tiles_y: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K3, vectorized over tiles and rays
    with a loop over chunks and the candidates of a chunk."""
    dev = packed.device
    T = tiles_x * tiles_y
    start = tile_bounds[:-1].to(torch.int64)
    nchunk = (tile_bounds[1:].to(torch.int64) - start) // CHUNK
    nmax = int(nchunk.max()) if T else 0
    ox, oy, oz, dx, dy, dz = rays[:, :6].unbind(1)  # (T, NPIX) each
    acc = torch.zeros((4, T, NPIX), dtype=torch.float32, device=dev)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    jj = torch.arange(CHUNK, device=dev)
    P = packed.shape[0] - 1
    for c in range(nmax):
        live = (c < nchunk)[:, None]
        idx = torch.where(live, start[:, None] + c * CHUNK + jj, 0)
        g = torch.where(live, gauss_idx[idx].to(torch.int64), P)
        rows = packed[g]  # (T, CHUNK, LO)
        fail = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
        for j in range(CHUNK):
            col = rows[:, j, :, None].unbind(1)  # LO x (T, 1)
            cx, cy, cz = col[_C_MEAN:_C_MEAN + 3]
            nx, ny, nz = col[_C_N:_C_N + 3]
            dn = dx * nx + dy * ny + dz * nz
            dn_s = torch.where(torch.abs(dn) < 1e-9, 1e-9, dn)
            num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz
            t = num / dn_s
            ex = ox + t * dx - cx
            ey = oy + t * dy - cy
            ez = oz + t * dz - cz
            u = ex * col[_C_TU] + ey * col[_C_TU + 1] + ez * col[_C_TU + 2]
            v = ex * col[_C_TV] + ey * col[_C_TV + 1] + ez * col[_C_TV + 2]
            rho = u * u + v * v
            a = torch.clamp(col[_C_OPAC] * torch.exp(-0.5 * rho), max=ALPHA_MAX)
            amask = (a >= ALPHA_MIN) & (t > T_MIN) & (torch.abs(dn) >= 1e-9)
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = amask & ~fail & passed
            fail = fail | (amask & ~passed)
            w = torch.where(contrib, a * trans, 0.0)
            for i in range(3):
                acc[i] += w * col[_C_COLOR + i]
            acc[3] += w
            trans = torch.where(contrib, test, trans)
    return _to_image(torch.cat([acc, trans[None]]), tiles_x, tiles_y)


def trace_blend(packed: torch.Tensor, gauss_idx: torch.Tensor,
                rays: torch.Tensor, tile_bounds: torch.Tensor, tiles_x: int,
                tiles_y: int) -> torch.Tensor:
    """The traced blend: kernel K3 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if packed.device.type == "cpu":
        return trace_blend_torch(packed, gauss_idx, rays, tile_bounds,
                                 tiles_x, tiles_y)
    return kernels.trace_blend_fwd(packed, gauss_idx, rays, tile_bounds,
                                   tiles_x, tiles_y)

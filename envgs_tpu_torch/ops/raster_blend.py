"""Per-tile surfel blend of the rasterizer: the plain PyTorch version and
the wrapper of its CUDA kernel K1 (the forward half of
envgs_tpu/ops/raster_pallas.py, render mode).

Both take the depth-permuted per-splat table `packed` ((P+1, LO) f32, last
row the zero sentinel; column layout below), the per-pair splat indices of
`ops/binning.py::bin_splats` (unaligned render layout) and the per-tile
pair ranges, and return image-layout planes (C + 6, tiles_y*16,
tiles_x*16): C colors, depth*w, alpha, view normal (3), final T.

Blend rule (the JAX kernel's, kept exactly): each tile walks its pairs in
64-pair windows that start at `start - start % 8` (the unaligned layout's
chunk grid). A pair contributes iff its alpha passes the 1/255 floor and
the near plane and T*(1-a) >= 1e-4. Within one window, the first pair that
fails the transmittance test ends the window for that pixel; the next
window starts afresh from the pixel's T. The sequential per-pair loop below
selects the same pairs as the JAX closed form.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.common import (
    ALPHA_MAX,
    ALPHA_MIN,
    FILTER_INV_SQUARE,
    NEAR_PLANE,
    T_CUTOFF,
)

TILE = 16
NPIX = TILE * TILE
CHUNK = 64
LO = 32  # packed row width
# packed column layout (shared with envgs_tpu.ops.raster_pallas)
_C_TMAT = 0  # 9 floats, row-major (x-row, y-row, w-row over (u, v, 1))
_C_CX = 9
_C_CY = 10
_C_OPAC = 11
_C_NRM = 12  # 3 floats
_C_COLOR = 15  # C floats, C <= 7


def out_rows(C: int) -> dict:
    """Plane index of each output in the (C + 6, H, W) result."""
    return dict(color=0, depth=C, alpha=C + 1, normal=C + 2, trans=C + 5)


def _pixel_coords(T, tiles_x, row_off, device):
    t = torch.arange(T, device=device)[:, None]
    lane = torch.arange(NPIX, device=device)[None, :]
    px = ((t % tiles_x) * TILE + lane % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + row_off + lane // TILE).to(torch.float32)
    return px, py


def _to_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(F, T, 256) per-tile planes -> (F, tiles_y*16, tiles_x*16)."""
    F = tiles.shape[0]
    return (tiles.reshape(F, tiles_y, tiles_x, TILE, TILE)
            .permute(0, 1, 3, 2, 4).reshape(F, tiles_y * TILE, tiles_x * TILE))


def blend_tiles_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                      tile_bounds: torch.Tensor, C: int, tiles_x: int,
                      tiles_y: int, row_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel K1, vectorized over tiles and pixels
    with a loop over windows and the pairs of a window."""
    dev = packed.device
    T = tiles_x * tiles_y
    P = packed.shape[0] - 1
    start = tile_bounds[:-1].to(torch.int64)
    end = tile_bounds[1:].to(torch.int64)
    wstart = start - start % 8
    nwin = int(((end - wstart + CHUNK - 1) // CHUNK).max()) if T else 0
    px, py = _pixel_coords(T, tiles_x, row_off, dev)
    acc = torch.zeros((C + 5, T, NPIX), dtype=torch.float32, device=dev)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    jj = torch.arange(CHUNK, device=dev)
    for c in range(nwin):
        idx = wstart[:, None] + c * CHUNK + jj  # (T, CHUNK)
        inb = (idx >= start[:, None]) & (idx < end[:, None])
        g = gauss_idx[torch.clamp(idx, max=gauss_idx.shape[0] - 1)]
        rows = packed[torch.where(inb, g.to(torch.int64), P)]  # (T, CHUNK, LO)
        fail = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
        for j in range(CHUNK):
            col = rows[:, j, :, None].unbind(1)  # LO x (T, 1)
            t00, t01, t02, t10, t11, t12, t20, t21, t22 = col[:9]
            kx = t00 - px * t20
            ky = t01 - px * t21
            kz = t02 - px * t22
            lx = t10 - py * t20
            ly = t11 - py * t21
            lz = t12 - py * t22
            qx = ky * lz - kz * ly
            qy = kz * lx - kx * lz
            qz = kx * ly - ky * lx
            qz = torch.where(torch.abs(qz) < 1e-12, 1e-12, qz)
            u = qx / qz
            v = qy / qz
            rho3d = u * u + v * v
            dx = col[_C_CX] - px
            dy = col[_C_CY] - py
            rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
            rho = torch.minimum(rho3d, rho2d)
            z = torch.where(rho3d <= rho2d, u * t20 + v * t21 + t22, t22)
            a = torch.clamp(col[_C_OPAC] * torch.exp(-0.5 * rho), max=ALPHA_MAX)
            amask = (a >= ALPHA_MIN) & (z >= NEAR_PLANE)
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = amask & ~fail & passed
            fail = fail | (amask & ~passed)
            w = torch.where(contrib, a * trans, 0.0)
            for i in range(C):
                acc[i] += w * col[_C_COLOR + i]
            acc[C] += w * z
            acc[C + 1] += w
            for i in range(3):
                acc[C + 2 + i] += w * col[_C_NRM + i]
            trans = torch.where(contrib, test, trans)
    return _to_image(torch.cat([acc, trans[None]]), tiles_x, tiles_y)


def blend_tiles(packed: torch.Tensor, gauss_idx: torch.Tensor,
                tile_bounds: torch.Tensor, C: int, tiles_x: int, tiles_y: int,
                row_off: int = 0) -> torch.Tensor:
    """The tile blend: kernel K1 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if packed.device.type == "cpu":
        return blend_tiles_torch(packed, gauss_idx, tile_bounds, C, tiles_x,
                                 tiles_y, row_off)
    return kernels.raster_blend_fwd(packed, gauss_idx, tile_bounds, C,
                                    tiles_x, tiles_y, row_off)

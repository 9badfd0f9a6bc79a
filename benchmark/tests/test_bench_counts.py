"""The yardstick's counts against hand-worked operations and bytes, and the
walks the reference's plain blends record on a tiny scene."""
from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import raster_blend as RB


def test_blend_counts_by_hand():
    w = dict(blend="raster", mode="surfel", aligned=False, walked=10.0,
             slots=7, table=33 * 32, npix=256, C=5)
    assert counts.raster_fwd(w) == ((33 * 32 + 7 + 11 * 256) * 4, 440.0)
    assert counts.raster_fwd({**w, "aligned": True}) == (
        (33 * 32 + 7 + 16 * 256) * 4, 440.0)
    assert counts.raster_bwd(w) == (
        (2 * 33 * 32 + 7 + 2 * 16 * 256) * 4, 10.0 * (44 + 2 * (16 + 5)))
    assert counts.raster_bwd({**w, "mode": "gauss3d"})[1] == 10.0 * (
        16 + 2 * (8 + 5))
    assert counts.bound_s(3.35e12, 0.0) == 1.0
    assert counts.bound_s(0.0, 67e12 * 2) == 2.0


def test_a_tiny_scene_walks_what_it_covers():
    """One 16x16 tile, two wide gauss3d splats of opacity 0.5 that reach
    every pixel: both contribute at every pixel (2 x 256 pairs), K1 counts
    16 operations a pair."""
    C = 3
    packed = torch.zeros((3, RB.LO))
    for r, z in ((0, 1.0), (1, 2.0)):
        packed[r, 0] = packed[r, 2] = 1e-6  # conic: rho ~ 0 on the tile
        packed[r, 3] = z
        packed[r, RB._C_CX] = packed[r, RB._C_CY] = 8.0
        packed[r, RB._C_OPAC] = 0.5
        packed[r, RB._C_COLOR:RB._C_COLOR + C] = 0.5
    gidx = torch.tensor([0, 1] + [2] * 62, dtype=torch.int32)
    bounds = torch.tensor([0, 2], dtype=torch.int32)
    RB.WALKS.clear()
    RB.blend_tiles_torch(packed, gidx, bounds, C, 1, 1, mode="gauss3d")
    (w,) = RB.WALKS
    assert w["walked"] == 512.0 and w["slots"] == 2 and w["npix"] == 256
    assert counts.raster_fwd(w)[1] == 512 * 16

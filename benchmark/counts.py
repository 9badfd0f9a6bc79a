"""The benchmark's yardstick of work: the card's peaks and the operations
and bytes of each blend kernel and of a whole step, counted from shapes
and from the (pair, pixel) evaluations that contribute in the reference's
plain blends (`reference.raster_blend.WALKS`), never from what the program
reports.

Every count is a lower count than the program executes (blending, tests
and reductions are left out, a transcendental or a division counts as one
operation), so a share of a bound or of the peak stays under 100% unless
the time leaves work out. Copied from `chip_smoke.py`'s arithmetic
(`bound_ms`, `blend_bound`, the operations per evaluated pair).
"""
from __future__ import annotations

# NVIDIA H100 SXM, published, dense, at the 700 W limit: device memory rate
# and float32 rate outside the tensor cores (the program keeps TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# float32 operations per evaluated (pair, pixel), read off the kernels'
# sources: the geometry terms every walked pair pays
OPS_SURFEL_TERMS = 44  # raster pixel terms, surfel: 3x3 transform, low-pass
OPS_GAUSS3D_TERMS = 16  # raster pixel terms, gauss3d: the EWA conic
# gradient columns the backward blends produce per pair (one multiply-add
# each): K2 surfel tmat 9, centre 2, opacity, normal 3, C colors, the wet;
# K2 gauss3d conic 3, depth, centre 2, opacity, C colors, the wet
K2_SURFEL_COLS = 16  # + C
K2_GAUSS3D_COLS = 8  # + C
# per-splat work ahead of the blends, forward: SH colors at degree 3 (one
# multiply-add per coefficient and channel, 16 x 3), the quaternion to its
# rotation matrix (normalize 12, entries 36), and the projection: a
# surfel's 3x3 screen transform (two 3x3 products, 108), a 3D Gaussian's
# covariance R S S^T R^T and its Jacobian transport (two 3x3 products each,
# 216)
OPS_SH3 = 2 * 16 * 3
OPS_ROT = 48
OPS_PREP_SURFEL = OPS_ROT + 108
OPS_PREP_GAUSS3D = OPS_ROT + 216
# masked Adam per parameter element: both moments (7), the bias
# corrections, square root, epsilon, the step (7)
OPS_ADAM = 14
# SSIM per pixel and channel: five maps through an 11-tap Gaussian, counted
# as two separable passes (220), and the formula (20)
OPS_SSIM = 5 * 2 * 11 * 2 + 20
# a backward pass costs twice its forward
BWD = 2.0


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes moved
    once over the memory rate and the float32 operations over the peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS)


def raster_fwd(w: dict) -> tuple[float, float]:
    """(bytes, operations) of K1 on a raster walk record: the splat table,
    the walked slots' int32 indices, the planes written (C + 11 with the
    training switches, C + 6 for a render), a pair's terms per walked
    pair."""
    planes = w["C"] + (11 if w["aligned"] else 6)
    n_bytes = (w["table"] + w["slots"] + planes * w["npix"]) * 4
    terms = OPS_GAUSS3D_TERMS if w["mode"] == "gauss3d" else OPS_SURFEL_TERMS
    return n_bytes, w["walked"] * terms


def raster_bwd(w: dict) -> tuple[float, float]:
    """(bytes, operations) of K2 on the raster walk of its forward: the
    table read and its gradient written, the slots, the forward's planes
    and their cotangents read; the terms and one multiply-add per gradient
    column per walked pair."""
    planes = w["C"] + 11
    n_bytes = (2 * w["table"] + w["slots"] + 2 * planes * w["npix"]) * 4
    if w["mode"] == "gauss3d":
        ops = OPS_GAUSS3D_TERMS + 2 * (K2_GAUSS3D_COLS + w["C"])
    else:
        ops = OPS_SURFEL_TERMS + 2 * (K2_SURFEL_COLS + w["C"])
    return n_bytes, w["walked"] * ops


def adam_ops(n_elements: int) -> float:
    return float(OPS_ADAM * n_elements)


def ssim_ops(H: int, W: int) -> float:
    """SSIM over an (H, W, 3) pair, forward."""
    return float(OPS_SSIM * H * W * 3)

"""The yardstick's counts for the traced blend, kernels K3 (forward, in
training mode) and K4 (backward), per trace walk of the reference's plain
blend (`reference.trace_blend`): bytes and operations read off the
kernels' sources as `counts.py` reads K1's and K2's, and as
`chip_smoke.py` bounds K3 and K4. A lower count than the kernels execute
(blending, tests and reductions left out), so a share stays under 100%
unless the time leaves work out.
"""
from __future__ import annotations

# float32 operations per evaluated (slot, ray): the plane hit t, the local
# (u, v), alpha
OPS_RAY_TERMS = 41
# gradient columns K4 produces per slot (one multiply-add each): the table
# row's mean 3, t_u 3, t_v 3, normal 3, opacity, colour 3 and the wet, A
# aux channels; the ray's origin 3 and direction 3
K4_TABLE_COLS = 17  # + A
K4_RAY_COLS = 6


def planes(w: dict) -> int:
    """Planes of the training forward: rgb, depth, acc, normal (3),
    distortion, A aux, T, D1, D2, last."""
    return 13 + w["A"]


def trace_fwd(w: dict) -> tuple[float, float]:
    """(bytes, operations) of K3 in training mode on a trace walk record:
    the scene table, the walked slots' int32 indices, the ray tiles read,
    the planes written; a slot's terms per contributing (slot, ray)."""
    n_bytes = (w["table"] + w["slots"] + w["rays"]
               + planes(w) * w["nray"]) * 4
    return n_bytes, w["walked"] * OPS_RAY_TERMS


def trace_bwd(w: dict) -> tuple[float, float]:
    """(bytes, operations) of K4 on the trace walk of its forward: the
    table read and its gradient written, the slots, the rays read and
    their gradient written, the forward's planes and their cotangents
    read; the terms and one multiply-add per gradient column per
    contributing (slot, ray)."""
    n_bytes = (2 * w["table"] + w["slots"] + 2 * w["rays"]
               + 2 * planes(w) * w["nray"]) * 4
    cols = K4_TABLE_COLS + w["A"] + K4_RAY_COLS
    return n_bytes, w["walked"] * (OPS_RAY_TERMS + 2 * cols)

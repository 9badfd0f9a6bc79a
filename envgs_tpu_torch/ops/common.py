"""Shared splat math: screen-space transform, AABB, per-row cull conic
(port of envgs_tpu/ops/common.py; same 2DGS screen parameterization and
blending constants)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.timer import span
from envgs_tpu_torch.utils.transforms import quat_to_rotmat

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_CUTOFF = 1e-4
NEAR_PLANE = 0.2
FAR_PLANE = 100.0
FILTER_INV_SQUARE = 2.0
CUTOFF = 3.0
ROWCULL_LEVEL = 11.15  # 2*ln(255) = 11.083 plus margin
ROWCULL_PAD = 1.0
ROWCULL_LOWPASS_R = float(np.sqrt(ROWCULL_LEVEL / FILTER_INV_SQUARE))


# the backend names the port takes (the JAX package's `raster_backend` /
# `tracer_backend`): the first is the default, the kernels on a CUDA tensor
# and their plain versions on a CPU tensor; "ref" is the reference oracle
# wherever the tensors are. Nothing falls back from one to the other.
BACKENDS = {"raster": ("pallas", "ref"), "tracer": ("tiled", "ref")}


def check_backend(kind: str, name: str):
    """Raise, naming it, on a backend the port does not take (the JAX
    package's `*_interp` names among them)."""
    if name not in BACKENDS[kind]:
        raise NotImplementedError(
            f"{kind}_backend={name!r}: the port takes "
            f"{' or '.join(map(repr, BACKENDS[kind]))} (the first runs its "
            "kernels on a CUDA tensor, their plain versions on a CPU "
            "tensor; 'ref' the reference oracle)")


def _where_small(x, tiny, repl):
    """x with |x| < tiny replaced by the constant `repl`."""
    return torch.where(torch.abs(x) < tiny, torch.full_like(x, repl), x)


def rowcull_params(ccx, ccy, An, Bn, Cn, r0n):
    """Normalize the footprint quadratic {An dx^2 + 2 Bn dx dy + Cn dy^2
    <= r0n} around (ccx, ccy) into per-row interval params
    [ccx, ccy, sa, p1, p2, dy_t] (see envgs_tpu.ops.common.rowcull_params)."""
    An_safe = _where_small(An, 1e-12, 1e-12)
    sa = Bn / An_safe
    p1 = (Bn * Bn - An * Cn) / (An_safe * An_safe)
    p2 = r0n / An_safe
    p1_safe = _where_small(p1, 1e-12, -1e-12)
    denom = p1_safe * (p1_safe - sa * sa)
    dy_t2 = sa * sa * p2 / _where_small(denom, 1e-20, 1e-20)
    dy_t = -torch.sign(sa) * torch.sqrt(torch.clamp(dy_t2, min=0.0))
    return torch.stack([ccx, ccy, sa, p1, p2, dy_t], dim=-1)


def snug_row_interval(center_pix, rowcull, yb0, yb1, lowpass_r=0.0):
    """Conservative x-interval (x_lo, x_hi) of the footprint over the pixel
    row band [yb0, yb1]: the level-set ellipse union, when lowpass_r > 0,
    the low-pass circle around the projected center. Broadcasts over the
    leading shape of center_pix[..., 2] / rowcull[..., 6] / yb0 / yb1."""
    cx = rowcull[..., 0]
    cy = rowcull[..., 1]
    sa = rowcull[..., 2]
    p1 = rowcull[..., 3]
    p2 = rowcull[..., 4]
    dy_t = rowcull[..., 5]
    dy0 = yb0 - cy
    dy1 = yb1 - cy
    ey2 = -p2 / _where_small(p1, 1e-12, -1e-12)
    ey = torch.sqrt(torch.clamp(ey2, min=0.0))
    d0 = torch.minimum(torch.maximum(dy0, -ey), ey)
    d1 = torch.minimum(torch.maximum(dy1, -ey), ey)

    def right(dy):
        return -sa * dy + torch.sqrt(torch.clamp(p1 * dy * dy + p2, min=0.0))

    r = torch.maximum(right(d0), right(d1))
    r = torch.where((dy_t >= dy0) & (dy_t <= dy1), right(dy_t), r)
    # the left edge mirrors: left(dy) = -right_{-sa}(-dy); critical at -dy_t
    l = torch.minimum(-right(-d0), -right(-d1))
    l = torch.where((-dy_t >= dy0) & (-dy_t <= dy1), -right(dy_t), l)
    hits_e = (dy1 >= -ey) & (dy0 <= ey) & (p2 > 0)
    big = torch.full_like(cx, 1e9)
    x_lo = torch.where(hits_e, cx + l, big)
    x_hi = torch.where(hits_e, cx + r, -big)
    # unreliable conic normalization: fall back to the full row
    unreliable = (p2 <= 0) | (p1 >= 0)
    x_lo = torch.where(unreliable, -big, x_lo)
    x_hi = torch.where(unreliable, big, x_hi)

    if lowpass_r:
        ox = center_pix[..., 0]
        oy = center_pix[..., 1]
        cdy0 = yb0 - oy
        cdy1 = yb1 - oy
        dmin = torch.maximum(cdy0, torch.clamp(cdy1, max=0.0))
        hc2 = lowpass_r * lowpass_r - dmin * dmin
        hits_c = hc2 >= 0.0
        hc = torch.sqrt(torch.clamp(hc2, min=0.0))
        x_lo = torch.minimum(x_lo, torch.where(hits_c, ox - hc, big))
        x_hi = torch.maximum(x_hi, torch.where(hits_c, ox + hc, -big))
    return x_lo - ROWCULL_PAD, x_hi + ROWCULL_PAD


class PreparedSplats(NamedTuple):
    """Per-splat screen-space data, fixed shapes over the padded pool."""

    tmat: torch.Tensor  # (P, 3, 3) rows: x_pix*w | y_pix*w | w over (u,v,1)
    center_pix: torch.Tensor  # (P, 2) 3-sigma conic center (pixels)
    depth: torch.Tensor  # (P,) view-space z of the center
    radius: torch.Tensor  # (P,) conservative screen radius (0 if culled)
    normal: torch.Tensor  # (P, 3) view-space normal, flipped to the camera
    color: torch.Tensor  # (P, C) blended channels (rgb [+spec+rough])
    opacity: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,) bool
    ext: torch.Tensor  # (P, 2) per-axis half-extents (pixels)
    rowcull: torch.Tensor  # (P, 6) [ccx, ccy, sa, p1, p2, dy_t] alpha-floor
    #   iso-level row-interval params (see rowcull_params)


def screen_footprint(tmat: torch.Tensor, cam: Camera):
    """Screen footprint of surfels from their screen transforms (P, 3, 3):
    (center_pix, radius, valid, ext, rowcull) as in PreparedSplats, with
    `valid` not yet masked by the pool's active set. The rowcull conic is
    ill-conditioned for thin, edge-on surfels, where it moves with the last
    bits of `tmat` (the +1 pixel ROWCULL_PAD absorbs that)."""
    w_c = tmat[:, 2, 2]  # view depth of the center
    # 3-sigma dual conic rows . diag(9, 9, -1) . rows^T -> AABB
    a_row = tmat[:, 0, :]
    b_row = tmat[:, 1, :]
    w_row = tmat[:, 2, :]
    tvec = w_c.new_tensor([CUTOFF * CUTOFF, CUTOFF * CUTOFF, -1.0])
    m00 = torch.sum(tvec * a_row * a_row, dim=-1)
    m02 = torch.sum(tvec * a_row * w_row, dim=-1)
    m11 = torch.sum(tvec * b_row * b_row, dim=-1)
    m12 = torch.sum(tvec * b_row * w_row, dim=-1)
    d = torch.sum(tvec * w_row * w_row, dim=-1)  # m22
    d_safe = torch.where(torch.abs(d) < 1e-12, torch.ones_like(d), d)
    cx = m02 / d_safe
    cy = m12 / d_safe
    ext_x = torch.sqrt(torch.clamp(cx * cx - m00 / d_safe, min=1e-4))
    ext_y = torch.sqrt(torch.clamp(cy * cy - m11 / d_safe, min=1e-4))
    # per-row cull conic at the alpha-floor level, on rows recentered at
    # the 3-sigma center (keeps the adjugate's products inside f32)
    lvl = ROWCULL_LEVEL
    ar = a_row - cx[:, None] * w_row
    br = b_row - cy[:, None] * w_row
    n00 = lvl * torch.sum(ar[:, :2] * ar[:, :2], -1) - ar[:, 2] ** 2
    n01 = lvl * torch.sum(ar[:, :2] * br[:, :2], -1) - ar[:, 2] * br[:, 2]
    n02 = lvl * torch.sum(ar[:, :2] * w_row[:, :2], -1) - ar[:, 2] * w_row[:, 2]
    n11 = lvl * torch.sum(br[:, :2] * br[:, :2], -1) - br[:, 2] ** 2
    n12 = lvl * torch.sum(br[:, :2] * w_row[:, :2], -1) - br[:, 2] * w_row[:, 2]
    n22 = lvl * torch.sum(w_row[:, :2] * w_row[:, :2], -1) - w_row[:, 2] ** 2
    n22_safe = torch.where(torch.abs(n22) < 1e-12, torch.ones_like(n22), n22)
    q00 = n11 * n22 - n12 * n12
    q01 = n02 * n12 - n01 * n22
    q11 = n00 * n22 - n02 * n02
    detN = (n00 * (n11 * n22 - n12 * n12)
            - n01 * (n01 * n22 - n02 * n12)
            + n02 * (n01 * n12 - n02 * n11))
    E0 = detN / n22_safe
    s = torch.where(q00 >= 0, 1.0, -1.0)
    An, Bn, Cn, r0n = s * q00, s * q01, s * q11, -s * E0
    ccx = cx + n02 / n22_safe
    ccy = cy + n12 / n22_safe
    rowcull = rowcull_params(ccx, ccy, An, Bn, Cn, r0n)
    lowpass_r = CUTOFF * float(np.sqrt(1.0 / FILTER_INV_SQUARE))
    bx = torch.ceil(torch.clamp(ext_x, min=lowpass_r))
    by = torch.ceil(torch.clamp(ext_y, min=lowpass_r))
    radius = torch.maximum(bx, by)

    valid = (w_c > NEAR_PLANE) & (d < 0)
    in_img = (
        (cx + ext_x >= 0)
        & (cx - ext_x <= cam.W - 1)
        & (cy + ext_y >= 0)
        & (cy - ext_y <= cam.H - 1)
    )
    valid = valid & in_img
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    ext = torch.stack([bx, by], dim=-1) * valid[:, None]

    return torch.stack([cx, cy], dim=-1), radius, valid, ext, rowcull


def prepare_splats(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
    active: torch.Tensor | None = None,
) -> PreparedSplats:
    """Project surfels to screen space (see envgs_tpu.ops.common)."""
    with span("render.project"):
        R = quat_to_rotmat(quats)
        t_u, t_v, n_w = R[..., :, 0], R[..., :, 1], R[..., :, 2]
        su = scales[:, 0] * scale_modifier
        sv = scales[:, 1] * scale_modifier

        M = cam.pix_from_world
        A = M[:, :3]
        b = M[:, 3]
        col_u = (t_u * su[:, None]) @ A.T
        col_v = (t_v * sv[:, None]) @ A.T
        col_1 = means3d @ A.T + b
        tmat = torch.stack([col_u, col_v, col_1], dim=-1)  # (P, 3, 3)

        center_pix, radius, valid, ext, rowcull = screen_footprint(tmat, cam)
        if active is not None:
            valid = valid & active
            radius = torch.where(valid, radius, torch.zeros_like(radius))
            ext = ext * valid[:, None]

        p_view = means3d @ cam.R.T + cam.T[None, :]
        n_view = n_w @ cam.R.T
        flip = torch.where(torch.sum(p_view * n_view, -1, keepdim=True) > 0,
                           -1.0, 1.0)
        n_view = n_view * flip

        return PreparedSplats(
            tmat=tmat,
            center_pix=center_pix,
            depth=tmat[:, 2, 2],
            radius=radius,
            normal=n_view,
            color=colors,
            opacity=opacities,
            valid=valid,
            ext=ext,
            rowcull=rowcull,
        )


def splat_response(tmat, center_pix, px, py):
    """Gaussian response of one splat at pixel(s) (px, py) -> (G, z): the
    low-pass-filtered Gaussian value and the intersection's view depth
    (the centre's where the low-pass dominates, 2DGS semantics). Shapes
    broadcast: tmat (..., 3, 3), center_pix (..., 2), px / py (...,)."""
    T0 = tmat[..., 0, :]
    T1 = tmat[..., 1, :]
    T2 = tmat[..., 2, :]
    k = T0 - px[..., None] * T2  # the plane x - x0 = 0 in (u, v, 1)
    l = T1 - py[..., None] * T2  # noqa: E741
    q = torch.linalg.cross(k, l)
    qz = torch.where(torch.abs(q[..., 2]) < 1e-12, 1e-12, q[..., 2])
    u = q[..., 0] / qz
    v = q[..., 1] / qz
    rho3d = u * u + v * v
    dx = center_pix[..., 0] - px
    dy = center_pix[..., 1] - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    z = u * T2[..., 0] + v * T2[..., 1] + T2[..., 2]
    z = torch.where(rho2d < rho3d, T2[..., 2], z)
    return torch.exp(-0.5 * rho), z


def map_depth(z):
    """Depth -> [0, 1] disparity-style mapping for the distortion loss."""
    return (FAR_PLANE * (z - NEAR_PLANE)) / (
        (FAR_PLANE - NEAR_PLANE) * torch.clamp(z, min=1e-6))

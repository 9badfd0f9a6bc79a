"""Per-tile traced blend of the surfel tracer and its backward: the plain
PyTorch versions and the wrappers of their CUDA kernels K3 (forward) and K4
(backward) (the two blend kernels of envgs_tpu/ops/tracer.py).

Both directions take the per-splat scene table `packed` ((P+1, LO) f32 in
pool order, last row the zero sentinel; column layout below), the per-slot
splat indices of `ops/tracer.py::cull_and_sort` (tile ranges 64-aligned,
padding slots hold the sentinel P), the ray tiles `rays` (T, 8, 256) and
the per-tile slot ranges.

Forward, image-layout planes (F, tiles_y*16, tiles_x*16):
- render mode (`train=False`): F = 5, rgb (3), acc, final T;
- training mode (`train=True`): F = 13 + A in the JAX kernel's row order
  (`rows(A)`): rgb, depth*w (ray parameter t), acc, the ray-facing normal
  (the splat normal flipped against the ray), distortion with
  m = t / (1 + |t|), aux (A <= 2), final T, the moments D1, D2, and
  `last`, the rank of the last contributing slot, -1 if none.

Blend rule (the JAX kernel's, kept exactly): each tile walks its slots in
64-slot chunks from its range start. A candidate contributes iff its alpha
passes the 1/255 floor, t > T_MIN and |d.n| >= 1e-9, and T*(1-a) >= 1e-4;
within one chunk, the first candidate that fails the transmittance test
ends the chunk for that ray, and the next chunk starts afresh from T.

Backward (`trace_blend_bwd`, the reverse walk of tracer._bwd_kernel) over
the JAX backward's contributing set `amask & (rank <= last)`: the table
gradient (P+1, LO) — mean, t_u, t_v, normal, opacity, color, aux per slot,
added into the slot's splat row, and the slot's forward-exact wet into
column WET_COL — and the ray gradient (T, 8, 256) of origins (rows 0-2)
and directions (rows 3-5). The plain version is the JAX kernel's reverse
loop written out, not autograd of the plain forward. The kernel sums a
slot's row over a warp's 32 rays by transposition (`bwd_slot_columns`: 16
main slots, and the wet and aux values apart) and adds it into the table
gradient with one atomic reduction instruction.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_CUTOFF
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    NPIX,
    WET_COL,
    _to_image,
    _to_tiles,
)

T_MIN = 1e-4  # minimum ray parameter (self-hit guard)
# packed column layout (shared with envgs_tpu.ops.tracer)
_C_MEAN = 0  # 3
_C_TU = 3  # 3 (tangent / scale_u)
_C_TV = 6  # 3
_C_N = 9  # 3
_C_OPAC = 12
_C_COLOR = 13  # 3
_C_AUX = 16  # A <= 2


def rows(A: int) -> dict:
    """Plane index of each output of the training-mode (13 + A, H, W)
    result (the JAX kernel's `_rows(A)`)."""
    return dict(color=0, dpt=3, acc=4, normal=5, dist=8, aux=9,
                trans=9 + A, d1=10 + A, d2=11 + A, last=12 + A)


def _chunk_index(gauss_idx, start, nchunk, c, P):
    """Splat index (T, CHUNK) int64 of chunk c of every tile (the sentinel
    P for tiles with fewer chunks)."""
    live = (c < nchunk)[:, None]
    idx = torch.where(live, start[:, None] + c * CHUNK
                      + torch.arange(CHUNK, device=gauss_idx.device), 0)
    return torch.where(live, gauss_idx[idx].to(torch.int64), P)


def _ray_terms(col, ray):
    """The JAX kernel's `_ray_splat_terms` for one candidate per tile: col
    is the LO columns, each (T, 1); ray the six (T, NPIX) ray planes."""
    ox, oy, oz, dx, dy, dz = ray
    cx, cy, cz = col[_C_MEAN:_C_MEAN + 3]
    nx, ny, nz = col[_C_N:_C_N + 3]
    dn0 = dx * nx + dy * ny + dz * nz
    dn = torch.where(torch.abs(dn0) < 1e-9, 1e-9, dn0)
    num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz
    t = num / dn
    ex = ox + t * dx - cx
    ey = oy + t * dy - cy
    ez = oz + t * dz - cz
    u = ex * col[_C_TU] + ey * col[_C_TU + 1] + ez * col[_C_TU + 2]
    v = ex * col[_C_TV] + ey * col[_C_TV + 1] + ez * col[_C_TV + 2]
    rho = u * u + v * v
    G = torch.exp(-0.5 * rho)
    oG = col[_C_OPAC] * G
    a = torch.clamp(oG, max=ALPHA_MAX)
    amask = (a >= ALPHA_MIN) & (t > T_MIN) & (torch.abs(dn0) >= 1e-9)
    flip = torch.where(dn0 > 0, -1.0, 1.0)
    return dict(a=a, amask=amask, clampm=oG < ALPHA_MAX, G=G, t=t, u=u, v=v,
                dn=dn, flip=flip, e=(ex, ey, ez))


def trace_blend_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                      rays: torch.Tensor, tile_bounds: torch.Tensor,
                      tiles_x: int, tiles_y: int, train: bool = False,
                      A: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel K3, vectorized over tiles and rays
    with a loop over chunks and the candidates of a chunk."""
    dev = packed.device
    T = tiles_x * tiles_y
    start = tile_bounds[:-1].to(torch.int64)
    nchunk = (tile_bounds[1:].to(torch.int64) - start) // CHUNK
    nmax = int(nchunk.max()) if T else 0
    ray = rays[:, :6].unbind(1)  # (T, NPIX) each
    zeros = lambda: torch.zeros((T, NPIX), dtype=torch.float32, device=dev)
    rgb = [zeros() for _ in range(3)]
    nrm = [zeros() for _ in range(3)]
    aux = [zeros() for _ in range(A)]
    acc, dpt, dist, d1, d2 = (zeros() for _ in range(5))
    last = torch.full((T, NPIX), -1.0, device=dev)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    for c in range(nmax):
        rows_c = packed[_chunk_index(gauss_idx, start, nchunk, c,
                                     packed.shape[0] - 1)]
        fail = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
        for j in range(CHUNK):
            col = rows_c[:, j, :, None].unbind(1)  # LO x (T, 1)
            s = _ray_terms(col, ray)
            a, t = s["a"], s["t"]
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = s["amask"] & ~fail & passed
            fail = fail | (s["amask"] & ~passed)
            w = torch.where(contrib, a * trans, 0.0)
            if train:
                m = t / (1.0 + torch.abs(t))
                wm = w * m
                dist = dist + w * (m * m * acc + d2 - 2.0 * m * d1)
                d1 = d1 + wm
                d2 = d2 + wm * m
                for i in range(3):
                    nrm[i] = nrm[i] + w * (col[_C_N + i] * s["flip"])
                for i in range(A):
                    aux[i] = aux[i] + w * col[_C_AUX + i]
                dpt = dpt + w * t
                last = torch.where(contrib, float(c * CHUNK + j), last)
            for i in range(3):
                rgb[i] = rgb[i] + w * col[_C_COLOR + i]
            acc = acc + w
            trans = torch.where(contrib, test, trans)
    if train:
        planes = rgb + [dpt, acc] + nrm + [dist] + aux + [trans, d1, d2, last]
    else:
        planes = rgb + [acc, trans]
    return _to_image(torch.stack(planes), tiles_x, tiles_y)


def trace_blend(packed: torch.Tensor, gauss_idx: torch.Tensor,
                rays: torch.Tensor, tile_bounds: torch.Tensor, tiles_x: int,
                tiles_y: int, train: bool = False, A: int = 0) -> torch.Tensor:
    """The traced blend: kernel K3 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if packed.device.type == "cpu":
        return trace_blend_torch(packed, gauss_idx, rays, tile_bounds,
                                 tiles_x, tiles_y, train, A)
    return kernels.trace_blend_fwd(packed, gauss_idx, rays, tile_bounds,
                                   tiles_x, tiles_y, train, A)


def trace_blend_bwd_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                          rays: torch.Tensor, tile_bounds: torch.Tensor,
                          out: torch.Tensor, g_out: torch.Tensor,
                          tiles_x: int, tiles_y: int, A: int = 0):
    """Plain PyTorch version of kernel K4: the reverse walk of the JAX
    backward kernel, vectorized over tiles and rays, candidates in reverse.
    -> ((P+1, LO) table gradient with the per-splat wet in column WET_COL,
    (T, 8, 256) ray gradient)."""
    dev = packed.device
    T = tiles_x * tiles_y
    r = rows(A)
    res = _to_tiles(out, tiles_x, tiles_y)
    g = _to_tiles(g_out, tiles_x, tiles_y)
    A_tot, D1_tot, D2_tot = res[r["acc"]], res[r["d1"]], res[r["d2"]]
    T_fin, last = res[r["trans"]], res[r["last"]]
    g_trans, g_dpt, g_acc, g_dist = (g[r["trans"]], g[r["dpt"]], g[r["acc"]],
                                     g[r["dist"]])
    g_col = [g[i] for i in range(3)]
    g_nrm = [g[r["normal"] + i] for i in range(3)]
    g_aux = [g[r["aux"] + i] for i in range(A)]
    start = tile_bounds[:-1].to(torch.int64)
    nchunks = (tile_bounds[1:].to(torch.int64) - start) // CHUNK
    lastmax = last.amax(-1).to(torch.int64) if T else nchunks
    neff = torch.clamp(torch.minimum(nchunks, (lastmax + CHUNK) // CHUNK),
                       min=0)
    ray = rays[:, :6].unbind(1)
    ox, oy, oz, dx, dy, dz = ray
    g_packed = torch.zeros_like(packed)
    g_ray = [torch.zeros_like(T_fin) for _ in range(6)]
    tcur = T_fin.clone()
    suf = [torch.zeros_like(T_fin) for _ in range(4)]
    for c in range(int(neff.max()) - 1 if T else -1, -1, -1):
        gi = _chunk_index(gauss_idx, start, neff, c, packed.shape[0] - 1)
        rows_c = packed[gi]
        s_log = torch.zeros_like(T_fin)
        sw, sm, sm2, sgw = (torch.zeros_like(T_fin) for _ in range(4))
        grads = torch.zeros((T, CHUNK, LO), dtype=torch.float32, device=dev)
        for j in range(CHUNK - 1, -1, -1):
            col = rows_c[:, j, :, None].unbind(1)  # LO x (T, 1)
            s = _ray_terms(col, ray)
            t, u, v, dn, flip = s["t"], s["u"], s["v"], s["dn"], s["flip"]
            ex, ey, ez = s["e"]
            contrib = s["amask"] & (float(c * CHUNK + j) <= last)
            cf = contrib.to(torch.float32)
            a = torch.where(contrib, s["a"], 0.0)
            om = 1.0 - a
            s_log = s_log + torch.where(contrib, torch.log1p(-a), 0.0)
            T_bef = tcur * torch.exp(-s_log)
            w = torch.where(contrib, a * T_bef, 0.0)
            m = t / (1.0 + torch.abs(t))
            wm = w * m
            wm2 = wm * m
            sw, sm, sm2 = sw + w, sm + wm, sm2 + wm2
            A_suf = suf[0] + sw - w
            D1_suf = suf[1] + sm - wm
            D2_suf = suf[2] + sm2 - wm2
            A_pre = A_tot - suf[0] - sw
            D1_pre = D1_tot - suf[1] - sm
            D2_pre = D2_tot - suf[2] - sm2

            g_w = g_acc + g_dpt * t
            for i in range(3):
                g_w = g_w + g_col[i] * col[_C_COLOR + i]
                g_w = g_w + g_nrm[i] * (col[_C_N + i] * flip)
            for i in range(A):
                g_w = g_w + g_aux[i] * col[_C_AUX + i]
            g_w = g_w + g_dist * (m * m * (A_pre + A_suf) + (D2_pre + D2_suf)
                                  - 2.0 * m * (D1_pre + D1_suf))
            gww = g_w * w
            sgw = sgw + gww
            S_gw = suf[3] + sgw - gww
            g_a = torch.where(contrib,
                              g_w * T_bef - (S_gw + g_trans * T_fin) / om, 0.0)
            g_m = g_dist * 2.0 * (m * (A_pre + A_suf) - (D1_pre + D1_suf)) * w
            dm_dt = 1.0 / ((1.0 + torch.abs(t)) * (1.0 + torch.abs(t)))
            g_t = w * g_dpt + g_m * dm_dt

            clampm = s["clampm"].to(torch.float32)
            g_G = g_a * col[_C_OPAC] * clampm
            g_opac = g_a * s["G"] * clampm
            g_rho = -0.5 * s["G"] * g_G
            g_u = 2.0 * u * g_rho
            g_v = 2.0 * v * g_rho
            tu = col[_C_TU:_C_TU + 3]
            tv = col[_C_TV:_C_TV + 3]
            mean = col[_C_MEAN:_C_MEAN + 3]
            nvec = col[_C_N:_C_N + 3]
            g_e = [g_u * tu[i] + g_v * tv[i] for i in range(3)]
            g_t = g_t + g_e[0] * dx + g_e[1] * dy + g_e[2] * dz
            o, d = (ox, oy, oz), (dx, dy, dz)
            g_mean = [-g_e[i] + g_t * nvec[i] / dn for i in range(3)]
            g_n = [g_t * ((mean[i] - o[i]) - t * d[i]) / dn
                   + g_nrm[i] * flip * w for i in range(3)]
            e = (ex, ey, ez)
            cols = (g_mean + [g_u * e[i] for i in range(3)]
                    + [g_v * e[i] for i in range(3)] + g_n + [g_opac]
                    + [g_col[i] * w for i in range(3)]
                    + [g_aux[i] * w for i in range(A)])
            wet = torch.where(T_bef * om >= T_CUTOFF, w, 0.0)
            grads[:, j, :len(cols)] = (torch.stack(cols, -1)
                                       * cf[..., None]).sum(1)
            grads[:, j, WET_COL] = wet.sum(1)
            for i in range(3):
                g_ray[i] = g_ray[i] + (g_e[i] - g_t * nvec[i] / dn) * cf
                g_ray[3 + i] = g_ray[3 + i] + (
                    g_e[i] * t - g_t * t * nvec[i] / dn) * cf
        g_packed.index_add_(0, gi.reshape(-1), grads.reshape(-1, LO))
        suf = [suf[0] + sw, suf[1] + sm, suf[2] + sm2, suf[3] + sgw]
        tcur = tcur * torch.exp(-s_log)
    g_rays = torch.cat([torch.stack(g_ray, 1),
                        rays.new_zeros((T, 2, NPIX))], dim=1)
    return g_packed, g_rays


def bwd_slot_columns(A: int) -> tuple:
    """Table column of each slot of the gradient row kernel K4 reduces over
    a warp: (the 16 main slots: mean, t_u, t_v, normal, opacity, color; the
    1 + A extras, reduced apart and added by lanes 16 to 16 + A: the wet to
    column WET_COL, then the aux channels)."""
    main = list(range(_C_AUX))
    return main, [WET_COL] + [_C_AUX + i for i in range(A)]


def trace_blend_bwd(packed: torch.Tensor, gauss_idx: torch.Tensor,
                    rays: torch.Tensor, tile_bounds: torch.Tensor,
                    out: torch.Tensor, g_out: torch.Tensor, tiles_x: int,
                    tiles_y: int, A: int = 0):
    """The traced blend's backward: kernel K4 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if packed.device.type == "cpu":
        return trace_blend_bwd_torch(packed, gauss_idx, rays, tile_bounds,
                                     out, g_out, tiles_x, tiles_y, A)
    return kernels.trace_blend_bwd(packed, gauss_idx, rays, tile_bounds, out,
                                   g_out, tiles_x, tiles_y, A)


class _TraceTrain(torch.autograd.Function):
    """Training-mode traced blend with its reverse-walk backward: gradients
    for the scene table, the ray tiles, and (through the wet lane) the
    zeros hook wet_zero (P+1,)."""

    @staticmethod
    def forward(ctx, packed, rays, wet_zero, gauss_idx, tile_bounds, tiles_x,
                tiles_y, A):
        out = trace_blend(packed, gauss_idx, rays, tile_bounds, tiles_x,
                          tiles_y, train=True, A=A)
        ctx.save_for_backward(packed, rays, gauss_idx, tile_bounds, out)
        ctx.dims = (tiles_x, tiles_y, A)
        return out

    @staticmethod
    def backward(ctx, g_out):
        packed, rays, gauss_idx, tile_bounds, out = ctx.saved_tensors
        g_packed, g_rays = trace_blend_bwd(packed, gauss_idx, rays,
                                           tile_bounds, out,
                                           g_out.contiguous(), *ctx.dims)
        return (g_packed, g_rays, g_packed[:, WET_COL], None, None, None,
                None, None)


def trace_blend_train(packed: torch.Tensor, rays: torch.Tensor,
                      wet_zero: torch.Tensor, gauss_idx: torch.Tensor,
                      tile_bounds: torch.Tensor, tiles_x: int, tiles_y: int,
                      A: int = 0) -> torch.Tensor:
    """Training-mode traced blend -> (13 + A, H', W') planes in `rows(A)`
    order, differentiable in `packed`, `rays` and the `wet_zero` hook."""
    return _TraceTrain.apply(packed, rays, wet_zero, gauss_idx, tile_bounds,
                             tiles_x, tiles_y, A)

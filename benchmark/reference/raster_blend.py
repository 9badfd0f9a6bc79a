"""Per-tile blend of the rasterizer and its backward in plain PyTorch: the
plain versions of kernels K1 (forward) and K2 (backward), frozen copies of
the repository's, which follow the two blend kernels of the JAX package
(envgs_tpu/ops/raster_pallas.py) and are held to them by its CPU tests.

Both directions take the depth-permuted per-splat table `packed` ((P+1, LO)
f32, last row the zero sentinel; column layout below), the per-pair splat
indices of the binning (`surfels.py::bin_pairs`) and the per-tile pair
ranges. Two geometries (`mode`), as in the JAX kernels'
`_splat_pixel_terms`:
- "surfel" (2DGS): a ray-plane intersection through the 3x3 screen
  transform in columns 0-8, floored by the 2D low-pass circle;
- "gauss3d" (3DGS, EWA): the screen conic (a, b, c) in columns 0-2 and
  the splat's view depth in column 3 (columns 4-8 and the normal columns
  zero), rho = a dx^2 + c dy^2 + 2 b dx dy.

Forward: the JAX kernel's static switches, `needs` = (need_dist,
need_med, need_wet), on either pair layout (`aligned`: each tile's range
whole 64-pair windows, the training layout; else raw ranges, the render
layout). need_dist: the distortion, its moments D1 = sum w m and
D2 = sum w m^2 of m = map_depth(z), and `last`, the rank (pair offset
within the tile) of the last contributing pair, -1 if none; need_med: the
median depth; need_wet (aligned only): the per-pair blend weight ("wet",
the sum over the tile's pixels of the pair's w), one value per pair slot of
`gauss_idx` (zero outside the tiles' ranges and past a tile's early stop),
returned beside the planes. Image-layout planes (F, tiles_y*16,
tiles_x*16), `plane_rows(C, needs)`:
- with need_dist or need_med, F = C + 11 in the JAX kernel's row order
  (`rows`): C colors, depth*w, alpha, normal (3), median depth,
  distortion, final T, D1, D2, last; a plane whose switch is off reads as
  the JAX kernel leaves it: zero, `last` -1;
- with neither, F = C + 6 (`out_rows`): C colors, depth*w, alpha, view
  normal (3), final T.
A switch only strips work: every plane a configuration writes equals the
all-on configuration's to the bit.

Blend rule (the JAX kernel's, kept exactly): each tile walks its pairs in
64-pair windows that start at `start - start % 8` (in the aligned layout,
`start` itself: the JAX training chunk grid). A pair contributes iff its
alpha passes the 1/255 floor and the near plane and T*(1-a) >= 1e-4.
Within one window, the first pair that fails the transmittance test ends
the window for that pixel; the next window starts afresh from the pixel's
T. The sequential per-pair loop below selects the same pairs as the JAX
closed form.

Backward (`blend_tiles_bwd`, the reverse walk of raster_pallas._bwd_kernel):
per tile, windows in reverse from the last one holding a contributor; the
contributing set is the JAX backward's, `amask & (rank <= last)`, with T
rebuilt as T_fin * exp(-suffix sum of log(1 - a)). It returns the
gradient of the per-splat table (P+1, LO): each pair's gradient row
(surfel: tmat 9, center 2, opacity, normal 3, colors C; gauss3d: conic 3,
depth, center 2, opacity, colors C) is added into its splat's row, and
the pair's forward-exact blend weight ("wet": its w where the forward's
own transmittance test passes) into column WET_COL. The plain version is
that reverse loop written out, not autograd of the plain forward (which
would differentiate a different contributing set). The kernel sums a
pair's row over a warp's 32 pixels by transposition (lane k ends up with
column k) and adds it into the table gradient with one 128-byte atomic
reduction.
"""
from __future__ import annotations

import torch

# the blend's constants, the model's: alpha clamped at 0.99 and floored at
# 1/255, a pixel done once T (1 - alpha) < 1e-4, the splats' near plane,
# the distortion's far plane, the 2D low-pass filter's inverse variance
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_CUTOFF = 1e-4
NEAR_PLANE = 0.2
FAR_PLANE = 100.0
FILTER_INV_SQUARE = 2.0

TILE = 16
NPIX = TILE * TILE
CHUNK = 64
LO = 32  # packed row width
WET_COL = LO - 1  # gradient column carrying each splat's summed wet
# packed column layout (shared with envgs_tpu.ops.raster_pallas)
_C_TMAT = 0  # surfel: 9 floats, row-major (x-row, y-row, w-row over
#   (u, v, 1)); gauss3d: conic (a, b, c) at 0-2, view depth at 3
_C_CX = 9
_C_CY = 10
_C_OPAC = 11
_C_NRM = 12  # 3 floats
_C_COLOR = 15  # C floats, C <= 7


def out_rows(C: int) -> dict:
    """Plane index of each output of the (C + 6, H, W) result of a forward
    with neither need_dist nor need_med."""
    return dict(color=0, depth=C, alpha=C + 1, normal=C + 2, trans=C + 5)


def rows(C: int) -> dict:
    """Plane index of each output of the (C + 11, H, W) result of a forward
    with need_dist or need_med (the JAX kernel's `_rows(C)`; the planes of
    a switch that is off hold zeros, `last` -1)."""
    return dict(color=0, depth=C, alpha=C + 1, normal=C + 2, med=C + 5,
                dist=C + 6, trans=C + 7, d1=C + 8, d2=C + 9, last=C + 10)


def plane_rows(C: int, needs) -> dict:
    """The plane layout of a forward in configuration `needs`: `rows(C)`
    with need_dist or need_med, else `out_rows(C)`."""
    return rows(C) if needs[0] or needs[1] else out_rows(C)


def _map_depth(z):
    zc = torch.clamp(z, min=1e-6)
    return (FAR_PLANE * (zc - NEAR_PLANE)) / ((FAR_PLANE - NEAR_PLANE) * zc)


def _dmap_dz(z):
    zc = torch.clamp(z, min=1e-6)
    return FAR_PLANE * NEAR_PLANE / ((FAR_PLANE - NEAR_PLANE) * zc * zc)


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


def _to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(F, tiles_y*16, tiles_x*16) -> (F, T, 256), the inverse of _to_image."""
    F = img.shape[0]
    return (img.reshape(F, tiles_y, TILE, tiles_x, TILE)
            .permute(0, 1, 3, 2, 4).reshape(F, tiles_y * tiles_x, NPIX))


def _window_index(gauss_idx, start, end, base, P, live=None):
    """Splat index (T, CHUNK) int64 of the pairs base + [0, CHUNK); pairs
    outside [start, end) (or of tiles not `live`) take the sentinel P."""
    idx = base[:, None] + torch.arange(CHUNK, device=gauss_idx.device)
    inb = (idx >= start[:, None]) & (idx < end[:, None])
    if live is not None:
        inb = inb & live[:, None]
    g = gauss_idx[torch.clamp(idx, 0, gauss_idx.shape[0] - 1)]
    return torch.where(inb, g.to(torch.int64), P)


def _gauss3d_terms(col, px, py):
    """The JAX kernel's `_splat_pixel_terms` (gauss3d mode), as
    _surfel_terms; z is the splat's view depth, (T, 1)."""
    ca, cb, cc, z = col[0], col[1], col[2], col[3]
    dx = col[_C_CX] - px
    dy = col[_C_CY] - py
    rho = ca * dx * dx + cc * dy * dy + 2.0 * cb * dx * dy
    G = torch.exp(-0.5 * torch.clamp(rho, min=0.0))
    oG = col[_C_OPAC] * G
    a = torch.clamp(oG, max=ALPHA_MAX)
    amask = (a >= ALPHA_MIN) & (rho >= 0.0) & (z >= NEAR_PLANE)
    return dict(a=a, amask=amask, clampm=oG < ALPHA_MAX, G=G, z=z, dx=dx,
                dy=dy)


def _terms(mode: str):
    if mode not in ("surfel", "gauss3d"):
        raise ValueError(f"mode={mode!r}: 'surfel' or 'gauss3d'")
    return _surfel_terms if mode == "surfel" else _gauss3d_terms


def _surfel_terms(col, px, py):
    """The JAX kernel's `_splat_pixel_terms` (surfel mode) for one pair per
    tile: col is the LO columns, each (T, 1); px, py (T, NPIX)."""
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
    b3 = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    z = torch.where(b3, u * t20 + v * t21 + t22, t22)
    G = torch.exp(-0.5 * rho)
    oG = col[_C_OPAC] * G
    a = torch.clamp(oG, max=ALPHA_MAX)
    amask = (a >= ALPHA_MIN) & (z >= NEAR_PLANE)
    return dict(a=a, amask=amask, clampm=oG < ALPHA_MAX, G=G, u=u, v=v,
                qz=qz, z=z, b3=b3, dx=dx, dy=dy, k=(kx, ky, kz),
                l=(lx, ly, lz))


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    """(T, NPIX) -> (T,) sums over each tile's pixels in K1's order: a
    halving tree within each 32-pixel warp (its shuffles), then the warps'
    sums one after another, so kernel and plain version agree to the bit."""
    x = x.reshape(x.shape[0], NPIX // 32, 32)
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    s = x[:, 0, 0]
    for k in range(1, NPIX // 32):
        s = s + x[:, k, 0]
    return s


def _check_config(tile_bounds: torch.Tensor, needs, aligned: bool):
    """Raise on a configuration K1 does not take: the wet on the unaligned
    layout, or an `aligned` layout whose tile ranges are not whole windows
    from multiples of CHUNK (reads the bounds: the plain version's check)."""
    if needs[2] and not aligned:
        raise ValueError("need_wet: the per-pair wet needs the aligned "
                         "layout")
    if aligned and bool(torch.any(tile_bounds % CHUNK != 0)):
        raise ValueError(f"aligned: tile ranges must be whole {CHUNK}-pair "
                         "windows")


# what each plain forward walked: the benchmark's count of the (pair, pixel)
# evaluations that contribute, the least any blend of the same image has
# to make whatever its pair lists hold, read by the roofline and
# utilization metrics (the reference's own yardstick, never the kernels')
WALKS: list = []


def blend_tiles_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                      tile_bounds: torch.Tensor, C: int, tiles_x: int,
                      tiles_y: int, row_off: int = 0,
                      needs=(False, False, False), mode: str = "surfel",
                      aligned: bool = False):
    """Plain PyTorch version of kernel K1, vectorized over tiles and pixels
    with a loop over windows and the pairs of a window. -> planes in
    `plane_rows(C, needs)`, or (planes, per-pair wet (gauss_idx.numel(),))
    with need_wet."""
    need_dist, need_med, need_wet = map(bool, needs)
    _check_config(tile_bounds, needs, aligned)
    terms = _terms(mode)
    dev = packed.device
    T = tiles_x * tiles_y
    P = packed.shape[0] - 1
    start = tile_bounds[:-1].to(torch.int64)
    end = tile_bounds[1:].to(torch.int64)
    wstart = start - start % 8
    nwin = int(((end - wstart + CHUNK - 1) // CHUNK).max()) if T else 0
    px, py = _pixel_coords(T, tiles_x, row_off, dev)
    zeros = lambda: torch.zeros((T, NPIX), dtype=torch.float32, device=dev)
    color = [zeros() for _ in range(C)]
    nrm = [zeros() for _ in range(3)]
    dep, alp, dist, d1, d2, med = (zeros() for _ in range(6))
    last = torch.full((T, NPIX), -1.0, device=dev)
    used = torch.zeros((), device=dev)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    wet_pairs = torch.zeros(gauss_idx.shape[0], dtype=torch.float32,
                            device=dev)
    for c in range(nwin):
        rows_c = packed[_window_index(gauss_idx, start, end,
                                      wstart + c * CHUNK, P)]
        fail = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
        for j in range(CHUNK):
            col = rows_c[:, j, :, None].unbind(1)  # LO x (T, 1)
            s = terms(col, px, py)
            a, z = s["a"], s["z"]
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = s["amask"] & ~fail & passed
            fail = fail | (s["amask"] & ~passed)
            w = torch.where(contrib, a * trans, 0.0)
            if need_wet:
                i = wstart + c * CHUNK + j
                inb = (i >= start) & (i < end)
                wet_pairs[i[inb]] = _pixel_sum(w)[inb]
            if need_dist:
                m = _map_depth(z)
                wm = w * m
                dist = dist + w * (m * m * alp + d2 - 2.0 * m * d1)
                d1 = d1 + wm
                d2 = d2 + wm * m
                last = torch.where(contrib, float(c * CHUNK + j), last)
            if need_med:
                med = torch.where(contrib & (trans > 0.5), z, med)
            for i in range(C):
                color[i] = color[i] + w * col[_C_COLOR + i]
            dep = dep + w * z
            alp = alp + w
            for i in range(3):
                nrm[i] = nrm[i] + w * col[_C_NRM + i]
            trans = torch.where(contrib, test, trans)
            used = used + contrib.sum()
    WALKS.append(dict(blend="raster", mode=mode, aligned=bool(aligned),
                      walked=float(used),
                      slots=int(tile_bounds[-1]), table=packed.numel(),
                      npix=T * NPIX, C=C))
    if need_dist or need_med:
        planes = color + [dep, alp] + nrm + [med, dist, trans, d1, d2, last]
    else:
        planes = color + [dep, alp] + nrm + [trans]
    img = _to_image(torch.stack(planes), tiles_x, tiles_y)
    return (img, wet_pairs) if need_wet else img


def blend_tiles(packed: torch.Tensor, gauss_idx: torch.Tensor,
                tile_bounds: torch.Tensor, C: int, tiles_x: int, tiles_y: int,
                row_off: int = 0, needs=(False, False, False),
                mode: str = "surfel", aligned: bool = False):
    """The tile blend: the plain version on any device."""
    return blend_tiles_torch(packed, gauss_idx, tile_bounds, C, tiles_x,
                             tiles_y, row_off, needs, mode, aligned)


def blend_tiles_bwd_torch(packed: torch.Tensor, gauss_idx: torch.Tensor,
                          tile_bounds: torch.Tensor, out: torch.Tensor,
                          g_out: torch.Tensor, C: int, tiles_x: int,
                          tiles_y: int, row_off: int = 0,
                          mode: str = "surfel") -> torch.Tensor:
    """Plain PyTorch version of kernel K2: the reverse walk of the JAX
    backward kernel, vectorized over tiles and pixels, pairs in reverse.
    out / g_out: the training forward's planes and their cotangents
    (C + 11, tiles_y*16, tiles_x*16) -> (P+1, LO) table gradient with the
    per-splat wet in column WET_COL."""
    terms = _terms(mode)
    dev = packed.device
    T = tiles_x * tiles_y
    r = rows(C)
    res = _to_tiles(out, tiles_x, tiles_y)
    g = _to_tiles(g_out, tiles_x, tiles_y)
    A_tot, D1_tot, D2_tot = res[r["alpha"]], res[r["d1"]], res[r["d2"]]
    T_fin, last = res[r["trans"]], res[r["last"]]
    g_trans, g_depth, g_alpha = g[r["trans"]], g[r["depth"]], g[r["alpha"]]
    g_dist, g_d1, g_d2 = g[r["dist"]], g[r["d1"]], g[r["d2"]]
    g_nrm = [g[r["normal"] + i] for i in range(3)]
    start = tile_bounds[:-1].to(torch.int64)
    end = tile_bounds[1:].to(torch.int64)
    nchunks = (end - start) // CHUNK
    lastmax = last.amax(-1).to(torch.int64) if T else nchunks
    neff = torch.clamp(torch.minimum(nchunks, (lastmax + CHUNK) // CHUNK),
                       min=0)
    px, py = _pixel_coords(T, tiles_x, row_off, dev)
    g_packed = torch.zeros_like(packed)
    tcur = T_fin.clone()
    suf = [torch.zeros_like(T_fin) for _ in range(4)]
    for c in range(int(neff.max()) - 1 if T else -1, -1, -1):
        gi = _window_index(gauss_idx, start, end, start + c * CHUNK,
                           packed.shape[0] - 1, c < neff)
        rows_c = packed[gi]
        s_log = torch.zeros_like(T_fin)
        sw, sm, sm2, sgw = (torch.zeros_like(T_fin) for _ in range(4))
        grads = torch.zeros((T, CHUNK, LO), dtype=torch.float32, device=dev)
        for j in range(CHUNK - 1, -1, -1):
            col = rows_c[:, j, :, None].unbind(1)  # LO x (T, 1)
            s = terms(col, px, py)
            z = s["z"]
            contrib = s["amask"] & (float(c * CHUNK + j) <= last)
            a = torch.where(contrib, s["a"], 0.0)
            om = 1.0 - a
            s_log = s_log + torch.where(contrib, torch.log1p(-a), 0.0)
            T_bef = tcur * torch.exp(-s_log)
            w = torch.where(contrib, a * T_bef, 0.0)
            m = _map_depth(z)
            wm = w * m
            wm2 = wm * m
            sw, sm, sm2 = sw + w, sm + wm, sm2 + wm2
            A_suf = suf[0] + sw - w
            D1_suf = suf[1] + sm - wm
            D2_suf = suf[2] + sm2 - wm2
            A_pre = A_tot - suf[0] - sw
            D1_pre = D1_tot - suf[1] - sm
            D2_pre = D2_tot - suf[2] - sm2

            g_w = g_alpha + g_depth * z + g_d1 * m + g_d2 * m * m
            for i in range(C):
                g_w = g_w + g[i] * col[_C_COLOR + i]
            for i in range(3):
                g_w = g_w + g_nrm[i] * col[_C_NRM + i]
            g_w = g_w + g_dist * (m * m * (A_pre + A_suf) + (D2_pre + D2_suf)
                                  - 2.0 * m * (D1_pre + D1_suf))
            gww = g_w * w
            sgw = sgw + gww
            S_gw = suf[3] + sgw - gww
            g_a = torch.where(contrib,
                              g_w * T_bef - (S_gw + g_trans * T_fin) / om, 0.0)
            g_m = (g_dist * 2.0 * (m * (A_pre + A_suf) - (D1_pre + D1_suf)) * w
                   + (g_d1 + 2.0 * g_d2 * m) * w)
            g_z = w * g_depth + g_m * _dmap_dz(z)

            clampm = s["clampm"].to(torch.float32)
            g_G = g_a * col[_C_OPAC] * clampm
            g_opac = g_a * s["G"] * clampm
            g_rho = -0.5 * s["G"] * g_G
            wet = torch.where(T_bef * om >= T_CUTOFF, w, 0.0)
            g_col = [g[i] * w for i in range(C)]
            if mode == "gauss3d":
                ca, cb, cc = col[0], col[1], col[2]
                dx, dy = s["dx"], s["dy"]
                zero = torch.zeros_like(w)
                cols = ([g_rho * dx * dx, 2.0 * g_rho * dx * dy,
                         g_rho * dy * dy, g_z] + [zero] * 5
                        + [g_rho * (2.0 * ca * dx + 2.0 * cb * dy),
                           g_rho * (2.0 * cc * dy + 2.0 * cb * dx), g_opac]
                        + [zero] * 3 + g_col)
                grads[:, j, :len(cols)] = torch.stack(cols, -1).sum(1)
                grads[:, j, WET_COL] = wet.sum(1)
                continue
            u, v, qz = s["u"], s["v"], s["qz"]
            cf = contrib.to(torch.float32)
            b3f = s["b3"].to(torch.float32) * cf
            b2f = (1.0 - s["b3"].to(torch.float32)) * cf
            g_u = b3f * (2.0 * u * g_rho + g_z * col[6])
            g_v = b3f * (2.0 * v * g_rho + g_z * col[7])
            g_t20 = g_z * u * b3f
            g_t21 = g_z * v * b3f
            g_t22 = g_z * cf
            g_qx = g_u / qz
            g_qy = g_v / qz
            g_qzz = -(u * g_u + v * g_v) / qz
            kx, ky, kz = s["k"]
            lx, ly, lz = s["l"]
            g_kx = ly * g_qzz - lz * g_qy
            g_ky = lz * g_qx - lx * g_qzz
            g_kz = lx * g_qy - ly * g_qx
            g_lx = g_qy * kz - g_qzz * ky
            g_ly = g_qzz * kx - g_qx * kz
            g_lz = g_qx * ky - g_qy * kx
            g_T2 = (-px * g_kx - py * g_lx + g_t20,
                    -px * g_ky - py * g_ly + g_t21,
                    -px * g_kz - py * g_lz + g_t22)
            g_cx = g_rho * b2f * 2.0 * FILTER_INV_SQUARE * s["dx"]
            g_cy = g_rho * b2f * 2.0 * FILTER_INV_SQUARE * s["dy"]
            cols = ([g_kx, g_ky, g_kz, g_lx, g_ly, g_lz, *g_T2, g_cx, g_cy,
                     g_opac] + [g_nrm[i] * w for i in range(3)] + g_col)
            grads[:, j, :len(cols)] = torch.stack(cols, -1).sum(1)
            grads[:, j, WET_COL] = wet.sum(1)
        g_packed.index_add_(0, gi.reshape(-1), grads.reshape(-1, LO))
        suf = [suf[0] + sw, suf[1] + sm, suf[2] + sm2, suf[3] + sgw]
        tcur = tcur * torch.exp(-s_log)
    return g_packed


def gauss3d_slot_columns(C: int) -> list:
    """Table column of each live slot of the 16-slot row kernel K2 reduces
    in gauss3d mode: conic and depth, centre and opacity, C colors; the wet
    rides in slot 15 to column WET_COL."""
    return [0, 1, 2, 3, _C_CX, _C_CY, _C_OPAC] + [
        _C_COLOR + c for c in range(C)]


def blend_tiles_bwd(packed: torch.Tensor, gauss_idx: torch.Tensor,
                    tile_bounds: torch.Tensor, out: torch.Tensor,
                    g_out: torch.Tensor, C: int, tiles_x: int, tiles_y: int,
                    row_off: int = 0, mode: str = "surfel") -> torch.Tensor:
    """The blend backward: the plain version on any device."""
    return blend_tiles_bwd_torch(packed, gauss_idx, tile_bounds, out, g_out,
                                 C, tiles_x, tiles_y, row_off, mode)


class _BlendTrain(torch.autograd.Function):
    """The blend with its reverse-walk backward, on the aligned layout. The
    forward runs (need_dist, need_med, fwd_wet) with need_dist on, as the
    JAX package's VJP forward does: the backward reads D1, D2 and `last`,
    not the median. wet_zero (P+1,), when given, is a zeros hook: the
    forward ignores it, its gradient is the per-splat wet (the table
    gradient's column WET_COL, which is a padding column of the table and
    so dropped by the table's own construction). The forward per-pair wet,
    when asked for, is not differentiable."""

    @staticmethod
    def forward(ctx, packed, wet_zero, gauss_idx, tile_bounds, C, tiles_x,
                tiles_y, row_off, mode, need_med, fwd_wet):
        out = blend_tiles(packed, gauss_idx, tile_bounds, C, tiles_x,
                          tiles_y, row_off, (True, need_med, fwd_wet), mode,
                          aligned=True)
        out, wet = out if fwd_wet else (out, packed.new_zeros(0))
        ctx.mark_non_differentiable(wet)
        ctx.save_for_backward(packed, gauss_idx, tile_bounds, out)
        ctx.dims = (C, tiles_x, tiles_y, row_off, mode)
        return out, wet

    @staticmethod
    def backward(ctx, g_out, _g_wet):
        packed, gauss_idx, tile_bounds, out = ctx.saved_tensors
        g = blend_tiles_bwd(packed, gauss_idx, tile_bounds, out,
                            g_out.contiguous(), *ctx.dims)
        g_wz = g[:, WET_COL] if ctx.needs_input_grad[1] else None
        return (g, g_wz, None, None, None, None, None, None, None, None,
                None)


def blend_tiles_train(packed: torch.Tensor, wet_zero: torch.Tensor | None,
                      gauss_idx: torch.Tensor, tile_bounds: torch.Tensor,
                      C: int, tiles_x: int, tiles_y: int, mode: str = "surfel",
                      fwd_wet: bool = False, row_off: int = 0,
                      need_med: bool = True):
    """The differentiable tile blend (aligned layout) -> ((C + 11, H', W')
    planes in `rows(C)` order, the median plane zero without `need_med`,
    differentiable in `packed` and (through the wet lane) in the
    `wet_zero` hook; the forward per-pair wet (gauss_idx.numel(),) with
    `fwd_wet`, else None). row_off: the pixel row of the first tile row (a
    band of a larger image), for both the forward and its backward."""
    out, wet = _BlendTrain.apply(packed, wet_zero, gauss_idx, tile_bounds, C,
                                 tiles_x, tiles_y, int(row_off), mode,
                                 bool(need_med), bool(fwd_wet))
    return out, (wet if fwd_wet else None)

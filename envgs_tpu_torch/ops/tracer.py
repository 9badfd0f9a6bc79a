"""Surfel ray tracer: ray-tile cone culling + the traced blend (port of
envgs_tpu/ops/tracer.py: the render path and the training path).

Per frame: 16x16 ray tiles become cones with direction-space probe boxes
(`build_ray_tiles`); splats are Morton-chunked (`build_chunk_index`); each
tile keeps the nearest chunks whose bounding spheres meet its cone, refines
them per splat (sphere test, then the direction-space footprint probe) and
sorts the kept candidates by quantized radial distance from the tile apex
(`cull_and_sort`); the traced blend (kernel K3 on CUDA tensors) composites
each tile's candidates front to back. Blend order is the per-tile radial
order, the JAX package's documented deviation from per-ray order;
`trace_rays(exact_order=True)` re-blends the same candidate windows in each
ray's own depth order for evaluation.

`trace_rays` honours each of the JAX package's `needs` (kernel K3 in its
render, geometry, training and training-with-wet configurations). Where
autograd records it blends in training mode (kernels K3 and K4): the cull
stays integer and carries no gradient; the gradient reaches the scene
table and, through the ray tiles (`ray_planes`, plain differentiable
torch ops), the ray origins and directions. `trace_rays_multibounce`
bounces the rays off the blended surface to `max_trace_depth`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.common import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_CUTOFF,
    check_backend,
)
from envgs_tpu_torch.ops.raster_blend import CHUNK, LO
from envgs_tpu_torch.ops.trace_blend import (
    T_MIN,
    rows,
    trace_blend,
    trace_blend_train,
)
from envgs_tpu_torch.ops.tracer_ref import (
    TraceOutput,
    TraceScene,
    _excl,
    trace_rays_reference,
)
from envgs_tpu_torch.utils.timer import count, span

RTH = 16  # tile height in rays
RTW = 16  # tile width in rays
NRAY = RTH * RTW
NQUAD = 4  # probe boxes per tile (2x2 spatial quadrants of the ray grid)
# elements of one (tiles, candidates) plane of a block of the plain cull:
# 64 MB in f32
_CULL_BLOCK_ELEMS = 1 << 24
# elements of one (tiles, rays, candidates) array of an exact-order block:
# 128 MB in f32; the blend holds a few dozen such arrays at once
_EXACT_BLOCK_ELEMS = 1 << 25


class RayTiles(NamedTuple):
    rays: torch.Tensor  # (T, 8, NRAY): rows ox oy oz dx dy dz 0 0
    apex: torch.Tensor  # (T, 3)
    axis: torch.Tensor  # (T, 3) unit mean direction
    tan_half: torch.Tensor  # (T,) cone tangent
    spread: torch.Tensor  # (T,) origin spread radius
    n_tiles: int
    # direction-space probe: a frame perpendicular to `axis` and, per ray
    # quadrant, gnomonic center/half-width boxes of the ray directions and
    # of the ray-origin offsets from the apex
    probe_frame: torch.Tensor  # (T, 2, 3): ex, ey rows
    probe_box: torch.Tensor  # (T, NQUAD, 10):
    #   u_c u_a v_c v_a ox_c ox_a oy_c oy_a oz_c oz_a
    probe_ok: torch.Tensor  # (T,) bool


def ray_planes(ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) origins and directions -> the kernels' ray tiles (T, 8,
    NRAY): rows ox oy oz dx dy dz 0 0, (H, W) edge-padded to whole 16x16
    tiles. Plain torch indexing, so differentiable in both inputs."""
    H, W = ray_o.shape[:2]
    dev = ray_o.device
    ty, tx = -(-H // RTH), -(-W // RTW)
    od = torch.cat([ray_o, ray_d], dim=-1)  # (H, W, 6)
    r = torch.clamp(torch.arange(ty * RTH, device=dev), max=H - 1)
    c = torch.clamp(torch.arange(tx * RTW, device=dev), max=W - 1)
    planes = (od[r][:, c].reshape(ty, RTH, tx, RTW, 6).permute(0, 2, 4, 1, 3)
              .reshape(ty * tx, 6, NRAY))
    return torch.cat([planes, planes.new_zeros((ty * tx, 2, NRAY))], dim=1)


def build_ray_tiles(ray_o: torch.Tensor, ray_d: torch.Tensor) -> RayTiles:
    """Group an (H, W) ray grid into RTW x RTH cones (H, W edge-padded)."""
    rays = ray_planes(ray_o, ray_d)
    T = rays.shape[0]
    ox, oy, oz, dx, dy, dz = rays[:, :6].unbind(1)  # (T, NRAY)
    dinv = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-18))
    dnx, dny, dnz = dx * dinv, dy * dinv, dz * dinv

    apx, apy, apz = ox.mean(-1), oy.mean(-1), oz.mean(-1)
    axx, axy, axz = dnx.mean(-1), dny.mean(-1), dnz.mean(-1)
    ainv = torch.rsqrt(torch.clamp(axx * axx + axy * axy + axz * axz,
                                   min=1e-18))
    axx, axy, axz = axx * ainv, axy * ainv, axz * ainv
    apex = torch.stack([apx, apy, apz], dim=-1)
    axis = torch.stack([axx, axy, axz], dim=-1)
    cosang = torch.clamp(
        dnx * axx[:, None] + dny * axy[:, None] + dnz * axz[:, None],
        -1.0, 1.0)
    min_cos = cosang.min(-1).values
    sin_half = torch.sqrt(torch.clamp(1.0 - min_cos * min_cos, 0.0, 1.0))
    tan_half = sin_half / torch.clamp(min_cos, min=1e-3)
    rox = ox - apx[:, None]
    roy = oy - apy[:, None]
    roz = oz - apz[:, None]
    spread = torch.sqrt((rox * rox + roy * roy + roz * roz).max(-1).values)

    # ---- direction-space probe tables (see envgs_tpu.ops.tracer) ----
    up = torch.where(torch.abs(axis[:, 2:3]) < 0.9,
                     axis.new_tensor([0.0, 0.0, 1.0]),
                     axis.new_tensor([1.0, 0.0, 0.0]))
    ex = torch.linalg.cross(up, axis)
    ex = ex / torch.clamp(torch.sqrt(torch.sum(ex * ex, -1, keepdim=True)),
                          min=1e-9)
    ey = torch.linalg.cross(axis, ex)
    wr = dnx * axx[:, None] + dny * axy[:, None] + dnz * axz[:, None]
    probe_ok = wr.min(-1).values > 0.2
    inv_wr = 1.0 / torch.clamp(wr, min=0.2)
    exx, exy, exz = ex[:, 0, None], ex[:, 1, None], ex[:, 2, None]
    eyx, eyy, eyz = ey[:, 0, None], ey[:, 1, None], ey[:, 2, None]
    u = (dnx * exx + dny * exy + dnz * exz) * inv_wr
    v = (dnx * eyx + dny * eyy + dnz * eyz) * inv_wr
    odx = rox * exx + roy * exy + roz * exz
    ody = rox * eyx + roy * eyy + roz * eyz
    odz = rox * axx[:, None] + roy * axy[:, None] + roz * axz[:, None]

    def cbox(x):  # center/half-width boxes per 2x2 spatial quadrant
        q = x.reshape(T, 2, RTH // 2, 2, RTW // 2)
        hi = q.amax(dim=(2, 4)).reshape(T, NQUAD)
        lo = q.amin(dim=(2, 4)).reshape(T, NQUAD)
        return 0.5 * (hi + lo), 0.5 * (hi - lo)

    boxes = [b for x in (u, v, odx, ody, odz) for b in cbox(x)]
    probe_box = torch.stack(boxes, dim=-1)
    probe_frame = torch.stack([ex, ey], dim=1)
    return RayTiles(rays, apex, axis, tan_half, spread, T,
                    probe_frame, probe_box, probe_ok)


def _morton3(u: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(P, 3) coords in [0, 1] -> 30-bit Morton codes (int32)."""
    xi = torch.clamp((u * (1 << bits)).to(torch.int32), 0, (1 << bits) - 1)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return ((spread(xi[:, 0]) << 2) | (spread(xi[:, 1]) << 1)
            | spread(xi[:, 2]))


class ChunkIndex(NamedTuple):
    """Spatially coherent splat chunking (built once per scene per frame)."""

    order: torch.Tensor  # (Pp,) sorted position -> pool index (sentinel P)
    mean_s: torch.Tensor  # (Pp, 3) means in Morton order
    rad_s: torch.Tensor  # (Pp,) 3-sigma radii in Morton order (0 inactive)
    cmean: torch.Tensor  # (NC, 3) chunk sphere centers
    crad: torch.Tensor  # (NC,) chunk sphere radii
    cact: torch.Tensor  # (NC,) any active member


def build_chunk_index(scene: TraceScene, radius3: torch.Tensor,
                      chunk: int = CHUNK) -> ChunkIndex:
    """Morton-sort splats and build per-chunk bounding spheres."""
    P = scene.mean.shape[0]
    act = scene.valid
    actf = act[:, None]
    big = 3.4e38
    mean = scene.mean
    mlo = torch.where(actf, mean, big).amin(0)
    mhi = torch.where(actf, mean, -big).amax(0)
    u = (mean - mlo) / torch.clamp(mhi - mlo, min=1e-6)
    key = torch.where(act, _morton3(torch.clamp(u, 0.0, 1.0)), 2 ** 30)
    order = torch.argsort(key, stable=True)
    Pp = -(-P // chunk) * chunk
    pad = Pp - P
    F = torch.nn.functional
    mean_s = F.pad(mean[order], (0, 0, 0, pad))
    rad_s = F.pad((radius3 * act)[order], (0, pad))
    act_s = F.pad(act[order], (0, pad))
    order = F.pad(order, (0, pad), value=P)
    order = torch.where(act_s, order, P).to(torch.int32)
    NC = Pp // chunk
    mm = mean_s.reshape(NC, chunk, 3)
    aa = act_s.reshape(NC, chunk)
    cnt = torch.clamp(aa.sum(1), min=1)[:, None]
    cmean = torch.sum(mm * aa[..., None], dim=1) / cnt
    dist = torch.linalg.vector_norm(mm - cmean[:, None, :], dim=-1)
    crad = torch.where(aa, dist + rad_s.reshape(NC, chunk), 0.0).amax(1)
    return ChunkIndex(order, mean_s, rad_s, cmean, crad, aa.any(1))


def coarse_radial(idx: ChunkIndex, apex, axis, tan_half, spread,
                  tmask) -> torch.Tensor:
    """The coarse pass over a block of B tiles: (B, NC) distance from each
    tile's apex to each chunk sphere's centre where the sphere meets the
    tile's cone, inf elsewhere (inactive chunks, masked-out tiles). Its dot
    products are sums written out left to right, as the kernel writes them
    (csrc/env_cull.cuh): a matrix product would sum in the library's own
    order, which differs between devices."""
    cx, cy, cz = idx.cmean.unbind(-1)
    ax0, ax1, ax2 = axis[:, 0:1], axis[:, 1:2], axis[:, 2:3]
    ap0, ap1, ap2 = apex[:, 0:1], apex[:, 1:2], apex[:, 2:3]
    cm2 = cx * cx + cy * cy + cz * cz
    proj = (ax0 * cx + ax1 * cy + ax2 * cz) - (ax0 * ap0 + ax1 * ap1
                                               + ax2 * ap2)
    d2 = ((cm2 - 2.0 * (ap0 * cx + ap1 * cy + ap2 * cz))
          + (ap0 * ap0 + ap1 * ap1 + ap2 * ap2))
    d2 = torch.clamp(d2, min=0.0)
    axis_dist = torch.sqrt(torch.clamp(d2 - proj * proj, min=0.0))
    slack = spread[:, None] + idx.crad[None, :] * (1.0 + tan_half[:, None])
    hit = axis_dist <= proj * tan_half[:, None] + slack
    near = d2 <= slack * slack
    keep = (hit | near) & (proj + idx.crad[None, :] > 0)
    keep = keep & idx.cact[None, :] & tmask[:, None]
    return torch.where(keep, torch.sqrt(d2), float("inf"))


def _block_cull(idx: ChunkIndex, packed_cand, cand_idx, Kc: int, P: int,
                apex, axis, tan_half, spread, tmask, pframe, pbox, pok):
    """Cull and radially sort the candidates of a block of B tiles:
    (cid_sorted (B, Kc*CHUNK) int64, keep (B, Kc*CHUNK) bool, cut (B,)
    int32: the chunks whose sphere met the tile's cone past the Kc nearest
    it keeps, met (B,) int64: the chunks that met it). pok None: no
    direction-space footprint rejection."""
    B = apex.shape[0]
    C = Kc * CHUNK
    radial = coarse_radial(idx, apex, axis, tan_half, spread, tmask)
    # the Kc nearest chunks, ties to the lower chunk index (lax.top_k's rule)
    srt = torch.sort(radial, dim=-1, stable=True)
    idc = srt.indices[:, :Kc]
    cvalid = srt.values[:, :Kc] < float("inf")
    cut = (srt.values[:, Kc:] < float("inf")).sum(-1, dtype=torch.int32)
    met = cvalid.sum(-1) + cut
    # ---- refine: exact per-splat cone test on the candidates ----
    pc = packed_cand[idc]  # (B, Kc, 8, CHUNK)

    def comp(i):
        return pc[:, :, i, :].reshape(B, C)

    cmx, cmy, cmz = comp(0), comp(1), comp(2)
    cvC = cvalid[:, :, None].expand(B, Kc, CHUNK).reshape(B, C)
    cr = torch.where(cvC, comp(3), 0.0)
    cnx, cny, cnz = comp(4), comp(5), comp(6)
    crc = torch.where(cvC, comp(7), 0.0)
    cid = torch.where(cvalid[:, :, None], cand_idx[idc].to(torch.int64),
                      P).reshape(B, C)
    relx = cmx - apex[:, 0:1]
    rely = cmy - apex[:, 1:2]
    relz = cmz - apex[:, 2:3]
    proj_s = relx * axis[:, 0:1] + rely * axis[:, 1:2] + relz * axis[:, 2:3]
    d2_s = relx * relx + rely * rely + relz * relz
    axd_s = torch.sqrt(torch.clamp(d2_s - proj_s * proj_s, min=0.0))
    slack_s = spread[:, None] + cr
    hit_s = axd_s <= proj_s * tan_half[:, None] + slack_s
    near_s = d2_s <= slack_s * slack_s
    keep_s = (hit_s | near_s) & (proj_s + cr > 0) & (cid < P) & (cr > 0)
    if pok is not None:
        # ---- direction-space footprint rejection: a contributing ray passes
        # within rc + origin spread of the splat center, so its direction lies
        # in the candidate's angular disk; reject a candidate whose disk misses
        # all four quadrant boxes of the tile's actual ray directions ----
        exx, exy, exz = pframe[:, 0, 0:1], pframe[:, 0, 1:2], pframe[:, 0, 2:3]
        eyx, eyy, eyz = pframe[:, 1, 0:1], pframe[:, 1, 1:2], pframe[:, 1, 2:3]
        ax0, ax1, ax2 = axis[:, 0:1], axis[:, 1:2], axis[:, 2:3]
        w = relx * ax0 + rely * ax1 + relz * ax2  # depth along the axis
        invw = 1.0 / torch.clamp(w, min=1e-6)
        u0 = (relx * exx + rely * exy + relz * exz) * invw
        v0 = (relx * eyx + rely * eyy + relz * eyz) * invw
        npx = cnx * exx + cny * exy + cnz * exz
        npy = cnx * eyx + cny * eyy + cnz * eyz
        npz = cnx * ax0 + cny * ax1 + cnz * ax2
        bnu = npx - u0 * npz
        bnv = npy - v0 * npz
        scl = invw * 1.10
        slu = crc * torch.sqrt(
            torch.clamp(1.0 + u0 * u0 - bnu * bnu, min=0.0)) * scl
        slv = crc * torch.sqrt(
            torch.clamp(1.0 + v0 * v0 - bnv * bnv, min=0.0)) * scl
        au0 = torch.abs(u0)
        av0 = torch.abs(v0)
        inside = torch.zeros_like(keep_s)
        for qd in range(NQUAD):
            cu, au, cv, av, ocu, oau, ocv, oav, ocz, oaz = (
                pbox[:, qd, i:i + 1] for i in range(10))
            du = (torch.abs(u0 - cu - (ocu - u0 * ocz) * invw)
                  - (au + (oau + au0 * oaz) * invw * 1.10))
            dv = (torch.abs(v0 - cv - (ocv - v0 * ocz) * invw)
                  - (av + (oav + av0 * oaz) * invw * 1.10))
            inside = inside | ((du <= slu) & (dv <= slv))
        far = w > 4.0 * (crc + spread[:, None])
        applies = far & pok[:, None]
        keep_s = keep_s & (inside | ~applies)
    rad_key = torch.where(keep_s, torch.sqrt(d2_s), float("inf"))
    cid = torch.where(keep_s, cid, P)
    cid_bits = int(P).bit_length()
    qbits = 32 - cid_bits
    if qbits >= 14:
        # (quantized radial, cid) in one integer key, as the JAX package
        # packs it into int32; int64 keeps the same unsigned order
        qmax = (1 << qbits) - 1
        rmax = torch.where(keep_s, rad_key, 0.0).amax(-1, keepdim=True)
        rq = torch.clamp(rad_key / torch.clamp(rmax, min=1e-12) * (qmax - 1),
                         0, qmax - 1).to(torch.int64)
        rq = torch.where(keep_s, rq, qmax)
        key = (rq << cid_bits) | cid
        cid_sorted = torch.sort(key, dim=-1).values & ((1 << cid_bits) - 1)
    else:
        o = torch.sort(rad_key, dim=-1, stable=True).indices
        cid_sorted = torch.gather(cid, 1, o)
    return cid_sorted, keep_s, cut, met


def _cull_tables(scene: TraceScene, radius3: torch.Tensor):
    """What both versions of the cull read: the chunk index and the (NC, 8,
    CHUNK) candidate table (mx my mz rad nx ny nz rc in Morton order)."""
    idx = build_chunk_index(scene, radius3)
    NC = idx.cmean.shape[0]
    # plane-footprint tables (sentinel row P -> zeros): splat normal and the
    # contribution radius rc = sigma_max * sqrt(2 ln(op / ALPHA_MIN))
    nrm1 = torch.cat([scene.normal, scene.normal.new_zeros((1, 3))], dim=0)
    rc = (radius3 / 3.0) * torch.sqrt(2.0 * torch.clamp(torch.log(
        torch.clamp(scene.opacity, min=1e-12) / ALPHA_MIN), min=0.0))
    rc1 = torch.cat([rc, rc.new_zeros(1)], dim=0)
    order = idx.order.to(torch.int64)
    nrm_s = nrm1[order]
    rc_s = rc1[order]
    packed_cand = torch.stack(
        [x.reshape(NC, CHUNK) for x in (
            idx.mean_s[:, 0], idx.mean_s[:, 1], idx.mean_s[:, 2], idx.rad_s,
            nrm_s[:, 0], nrm_s[:, 1], nrm_s[:, 2], rc_s)], dim=1)
    return idx, packed_cand


def _slot_budget(T: int, K: int, total_pair_cap: int | None) -> int:
    """The output's slots: room for every tile's K candidates and a
    chunk of padding, rounded to 1024, at most total_pair_cap rounded."""
    cap_aligned = -(-(T * K + T * CHUNK) // 1024) * 1024
    if total_pair_cap is not None:
        cap_aligned = min(cap_aligned, -(-total_pair_cap // 1024) * 1024)
    return cap_aligned


def cull_and_sort_torch(
    tiles: RayTiles, scene: TraceScene, radius3: torch.Tensor,
    per_tile_cap: int = 4096, tile_block: int | None = None,
    total_pair_cap: int | None = None,
    tile_mask: torch.Tensor | None = None,
    probe: bool = True,
):
    """The plain version of cull_and_sort (its contract), a chain of torch
    ops: tiles are culled `tile_block` at a time; each tile's result is
    independent of the blocking. The default takes as many tiles as keep
    each (tiles, candidates) plane within _CULL_BLOCK_ELEMS: each block is
    a long chain of small torch ops, so fewer blocks mean fewer launches.
    Its time and memory are O(tiles x per_tile_cap): every candidate slot
    is refined and sorted, and the sorted slots sit in one (T, K) plane."""
    dev = scene.mean.device
    P = scene.mean.shape[0]
    T = tiles.n_tiles
    idx, packed_cand = _cull_tables(scene, radius3)
    NC = idx.cmean.shape[0]
    Kc = max(min(per_tile_cap // CHUNK, NC), 1)
    K = Kc * CHUNK
    tile_block = tile_block or max(1, _CULL_BLOCK_ELEMS // K)
    cand_idx = idx.order.reshape(NC, CHUNK)
    if tile_mask is None:
        tile_mask = torch.ones(T, dtype=torch.bool, device=dev)
    # each block's sorted slots written in place, as int32 (pool indices
    # and the sentinel P): one (T, K) plane, 13 GB at K = 2^19
    idmat = torch.empty((T, K), dtype=torch.int32, device=dev)
    counts = torch.empty(T, dtype=torch.int32, device=dev)
    cut = torch.zeros((), dtype=torch.int32, device=dev)
    met = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, T, tile_block):
        sl = slice(b0, min(b0 + tile_block, T))
        cs, ks, ct, mt = _block_cull(
            idx, packed_cand, cand_idx, Kc, P, tiles.apex[sl],
            tiles.axis[sl], tiles.tan_half[sl], tiles.spread[sl],
            tile_mask[sl], tiles.probe_frame[sl], tiles.probe_box[sl],
            tiles.probe_ok[sl] if probe else None)
        idmat[sl] = cs
        counts[sl] = ks.sum(-1, dtype=torch.int32)
        cut += ct.sum(dtype=torch.int32)
        met += mt.sum()
    count("env.met", met)
    padded = -(-counts // CHUNK) * CHUNK
    poffs = torch.cat([counts.new_zeros(1),
                       torch.cumsum(padded, 0, dtype=torch.int32)])
    cap_aligned = _slot_budget(T, K, total_pair_cap)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if total_pair_cap is not None:
        # tiles past the budget lose their tail slots (their range clamps
        # to the cap); count what was dropped so truncation is observable
        dropped = torch.clamp(poffs[-1] - cap_aligned, min=0)
        poffs = torch.clamp(poffs, max=cap_aligned)
    # slot chunk i belongs to the tile whose [start, end) holds it; chunks
    # past the last range hold the sentinel
    NCH = cap_aligned // CHUNK
    coffs = (poffs // CHUNK).to(torch.int64)
    i = torch.arange(NCH, device=dev)
    t_of = torch.clamp(torch.searchsorted(coffs[1:], i, right=True), max=T - 1)
    k = i - coffs[t_of]
    src = t_of * Kc + torch.clamp(k, 0, Kc - 1)
    gathered = idmat.reshape(-1, CHUNK)[src]  # (NCH, CHUNK)
    valid = (i < coffs[-1])[:, None]
    gauss_aligned = torch.where(valid, gathered, P).reshape(-1)
    return gauss_aligned.to(torch.int32), poffs, dropped, cut


def use_kernel(tiles: RayTiles, scene: TraceScene, radius3: torch.Tensor,
               tile_mask: torch.Tensor | None = None) -> bool:
    """The cull's dispatch rule: False (the plain version) where every
    tensor it reads is on the CPU, True (the kernels) where every one is
    on the card; a mix of the two raises ValueError."""
    tensors = {f"tiles.{k}": getattr(tiles, k) for k in (
        "apex", "axis", "tan_half", "spread", "probe_frame", "probe_box",
        "probe_ok")}
    tensors.update({f"scene.{k}": getattr(scene, k) for k in (
        "mean", "valid", "normal", "opacity")}, radius3=radius3)
    if tile_mask is not None:
        tensors["tile_mask"] = tile_mask
    off = [k for k, t in tensors.items() if not t.is_cuda]
    if len(off) == len(tensors):
        return False
    if off:
        raise ValueError(f"the cull's tensors are on two devices: {off} on "
                         "the CPU, the rest on the card")
    return True


def cull_and_sort(
    tiles: RayTiles, scene: TraceScene, radius3: torch.Tensor,
    per_tile_cap: int = 4096, tile_block: int | None = None,
    total_pair_cap: int | None = None,
    tile_mask: torch.Tensor | None = None,
    probe: bool = True,
):
    """Hierarchical cone culling -> chunk-aligned radially sorted slots.

    Returns (gauss_idx (cap_aligned,) int32 pool indices with sentinel P,
    tile_bounds (T+1,) int32 64-aligned, dropped () int32 slots cut by
    `total_pair_cap`, cut () int32 chunks cut by `per_tile_cap`: summed
    over the tiles, the chunks whose bounding sphere met a tile's cone
    beyond the per_tile_cap // CHUNK nearest it keeps; 0 = no tile lost a
    candidate to the cap). probe=False switches the direction-space
    footprint rejection off. Counts `env.met`, the (tile, chunk) pairs
    whose sphere met a tile's cone before the cap, on the open span.

    Each tile keeps the Kc = per_tile_cap // CHUNK nearest chunks its cone
    meets (ties to the lower chunk index), refines their candidates (the
    sphere test and the probe) and orders the kept ones: where P < 2^18 by
    (radial quantized to the tile's largest, pool index), else by radial,
    ties to the chunk's coarse rank and then its lane. On CUDA tensors the
    kernels of csrc/env_cull.cu do it at a cost that follows the chunks
    each tile meets, and nothing waits for the card; on CPU tensors the
    plain version, `cull_and_sort_torch`, whose alone `tile_block` is
    (`use_kernel`). Their outputs are equal, integer for integer."""
    if not use_kernel(tiles, scene, radius3, tile_mask):
        return cull_and_sort_torch(tiles, scene, radius3, per_tile_cap,
                                   tile_block, total_pair_cap, tile_mask,
                                   probe)
    P = scene.mean.shape[0]
    T = tiles.n_tiles
    idx, packed_cand = _cull_tables(scene, radius3)
    NC = idx.cmean.shape[0]
    Kc = max(min(per_tile_cap // CHUNK, NC), 1)
    if tile_mask is None:
        tile_mask = torch.ones(T, dtype=torch.bool, device=scene.mean.device)
    gauss, bounds, dropped, cut, met = kernels.env_cull(
        idx.cmean, idx.crad, idx.cact, packed_cand, idx.order,
        *(x.contiguous() for x in (tiles.apex, tiles.axis, tiles.tan_half,
                                   tiles.spread, tile_mask,
                                   tiles.probe_frame, tiles.probe_box)),
        tiles.probe_ok.contiguous() if probe else None, Kc, P,
        _slot_budget(T, Kc * CHUNK, total_pair_cap))
    count("env.met", met)
    return gauss, bounds, dropped, cut


def tile_mask_of(ray_mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool rays to trace -> (T,) bool ray tiles holding one."""
    H, W = ray_mask.shape
    ty, tx = -(-H // RTH), -(-W // RTW)
    m = torch.nn.functional.pad(ray_mask.to(torch.bool),
                                (0, tx * RTW - W, 0, ty * RTH - H))
    return (m.reshape(ty, RTH, tx, RTW).permute(0, 2, 1, 3)
            .reshape(ty * tx, NRAY).any(dim=1))


def _pack_scene_table(scene: TraceScene) -> torch.Tensor:
    """Per-splat packed table (P+1, LO) f32; last row = zero sentinel."""
    packed = torch.cat(
        [scene.mean, scene.t_u, scene.t_v, scene.normal,
         (scene.opacity * scene.valid)[:, None], scene.color, scene.aux],
        dim=1)
    return torch.nn.functional.pad(packed, (0, LO - packed.shape[1], 0, 1))


def default_per_tile_cap(P: int) -> int:
    """Candidates per ray tile: all P for small scenes, else the nearest
    2048 (the JAX package's measured floor: 1024 truncates visibly)."""
    return min(-(-P // CHUNK) * CHUNK, 2048)


def splat_radius3(scene: TraceScene) -> torch.Tensor:
    """(P,) 3-sigma world bounding radius of each splat."""
    su = 1.0 / torch.clamp(torch.linalg.vector_norm(scene.t_u, dim=-1), min=1e-12)
    sv = 1.0 / torch.clamp(torch.linalg.vector_norm(scene.t_v, dim=-1), min=1e-12)
    return 3.0 * torch.maximum(su, sv)


def _trace_tiles_exact(scene: TraceScene, rays: torch.Tensor,
                       gauss_idx: torch.Tensor, bounds: torch.Tensor,
                       K: int, tile_block: int | None = None) -> torch.Tensor:
    """Exact per-ray-ordered blend over the culled candidate windows (port
    of envgs_tpu's `_trace_tiles_exact`, plain PyTorch as it is plain JAX
    there): every tile's window [bounds[t], bounds[t+1]) is blended with
    each ray's own depth order of its hits, so what is left against the
    exact tracer is the cull alone. O(K log K) per ray; no wet (eval only).

    Tiles go `tile_block` at a time (default: as many as keep one (tiles,
    rays, candidates) array within _EXACT_BLOCK_ELEMS), each block over
    the longest window among its tiles rather than all K slots: a slot
    past a tile's window never contributes.

    -> (T, 10 + A, NRAY): rgb (3), depth*w, acc, normal (3), distortion,
    final T, aux."""
    dev = rays.device
    T = rays.shape[0]
    P = scene.mean.shape[0]
    A = scene.aux.shape[-1]
    starts = bounds[:-1].to(torch.int64)
    cnts = torch.clamp(bounds[1:].to(torch.int64) - starts, max=K)
    gidx = gauss_idx.to(torch.int64)
    B = tile_block or max(1, _EXACT_BLOCK_ELEMS // (K * NRAY))
    # the longest window of each block, fetched in one transfer
    kmax = torch.stack([cnts[b0:b0 + B].max()
                        for b0 in range(0, T, B)]).tolist() if T else []
    out = torch.zeros((T, 10 + A, NRAY), dtype=torch.float32, device=dev)
    for blk, b0 in enumerate(range(0, T, B)):
        Kb = kmax[blk]
        if Kb == 0:
            out[b0:b0 + B, 9] = 1.0
            continue
        st, cnt, r8 = starts[b0:b0 + B], cnts[b0:b0 + B], rays[b0:b0 + B]
        k = torch.arange(Kb, device=dev)
        idxw = gidx[torch.clamp(st[:, None] + k, max=gidx.shape[0] - 1)]
        valid = (k < cnt[:, None]) & (idxw < P)
        g = torch.clamp(idxw, 0, P - 1)  # (b, Kb)
        col3 = lambda t: [t[g][..., i, None] for i in range(3)]  # noqa: E731
        mx, my, mz = col3(scene.mean)  # (b, Kb, 1) each
        ux, uy, uz = col3(scene.t_u)
        vx, vy, vz = col3(scene.t_v)
        nx, ny, nz = col3(scene.normal)
        op = torch.where(valid, scene.opacity[g], 0.0)[..., None]
        ox, oy, oz, dx, dy, dz = (r8[:, i, None, :] for i in range(6))
        dn = nx * dx + ny * dy + nz * dz  # (b, Kb, NRAY)
        dn_safe = torch.where(torch.abs(dn) < 1e-9, 1e-9, dn)
        t = ((mx * nx + my * ny + mz * nz)
             - (nx * ox + ny * oy + nz * oz)) / dn_safe
        u = ((ux * ox + uy * oy + uz * oz) + t * (ux * dx + uy * dy + uz * dz)
             - (ux * mx + uy * my + uz * mz))
        v = ((vx * ox + vy * oy + vz * oz) + t * (vx * dx + vy * dy + vz * dz)
             - (vx * mx + vy * my + vz * mz))
        alpha = torch.clamp(op * torch.exp(-0.5 * (u * u + v * v)),
                            max=ALPHA_MAX)
        ok = (alpha >= ALPHA_MIN) & (t > T_MIN) & (torch.abs(dn) >= 1e-9)
        alpha = torch.where(ok, alpha, 0.0)
        flip = torch.where(dn > 0, -1.0, 1.0)
        # ---- each ray's own depth order of its hits ----
        keys = torch.where(alpha > 0, t, float("inf")).transpose(1, 2)
        order = torch.sort(keys, dim=2, stable=True).indices  # (b, NRAY, Kb)
        del keys, u, v, ok, dn_safe

        def per_ray(x):  # (b, Kb, NRAY or 1) -> (b, NRAY, Kb) in ray order
            return torch.gather(
                x.transpose(1, 2).expand(-1, NRAY, -1), 2, order)

        a_s = per_ray(alpha)
        t_s = per_ray(t)
        m_s = t_s / (1.0 + torch.abs(t_s))
        log_om = torch.log1p(-a_s)
        Ttil = torch.exp(_excl(log_om))
        contrib = (a_s > 0) & (Ttil * (1.0 - a_s) >= T_CUTOFF)
        w = torch.where(contrib, a_s * Ttil, 0.0)
        res = out[b0:b0 + B]
        for c in range(3):
            res[:, c] = torch.sum(w * per_ray(scene.color[g][..., c, None]), 2)
        res[:, 3] = torch.sum(w * t_s, 2)
        res[:, 4] = torch.sum(w, 2)
        for c, n in enumerate((nx, ny, nz)):
            res[:, 5 + c] = torch.sum(w * per_ray(n * flip), 2)
        res[:, 8] = torch.sum(
            w * (m_s * m_s * _excl(w) + _excl(w * m_s * m_s)
                 - 2 * m_s * _excl(w * m_s)), 2)
        res[:, 9] = torch.exp(torch.sum(torch.where(contrib, log_om, 0.0), 2))
        for c in range(A):
            res[:, 10 + c] = torch.sum(
                w * per_ray(scene.aux[g][..., c, None]), 2)
    return out


def trace_rays(
    scene: TraceScene,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    bg_color: torch.Tensor,
    per_tile_cap: int | None = None,
    total_pair_cap: int | None = 2 ** 21,
    ray_mask: torch.Tensor | None = None,
    needs: tuple = (False, False, False),
    wet_zero: torch.Tensor | None = None,
    compose_raw: bool = False,
    exact_order: bool = False,
    probe: bool = True,
) -> TraceOutput:
    """Tiled tracer over an (H, W) ray grid.

    needs = (need_dist, need_wet[, need_geo]), need_geo True when left
    out, as the JAX package reads them: the blend's configuration follows
    (need_dist, need_wet and no hook, need_geo); outputs not asked for come
    back zero (depth, normal and aux without need_geo; distortion without
    need_dist). All False is the render path; need_geo alone the geometry
    path of a traced base pass. With the (P,) zeros hook `wet_zero` the
    per-splat wet is the hook's gradient and TraceOutput.wet exact zeros;
    without it, need_wet gives the forward wet (detached), each slot's
    weight summed per splat. Where autograd records (the scene or the rays
    require gradients), the blend runs in training mode with need_dist on,
    as the JAX package's custom VJP does, and its backward (kernel K4)
    reaches the scene table, the rays and the hook. ray_mask (H, W) bool
    culls whole ray tiles with no masked-in ray. compose_raw: rgb without
    the bg * T term, dpt not normalized, d1 / d2 filled (the premultiplied
    form two tracer outputs compose in). probe=False switches the cull's
    direction-space footprint rejection off. exact_order: the eval-time
    blend in each ray's own depth order (`_trace_tiles_exact`, plain
    PyTorch, no kernel), every output filled, no gradient and no wet.
    per_tile_cap: candidates a ray tile keeps (default_per_tile_cap when
    None); the chunks it cuts come back as TraceOutput.cut_chunks. Its
    stages are the spans env.tiles, env.cull (counters env.met, the
    (tile, chunk) pairs that met before the cap; env.pairs, the slots
    used; env.slots, the slot budget; env.cut) and env.blend of
    utils/timer.py, a traced base pass's too."""
    need_dist, need_wet = bool(needs[0]), bool(needs[1])
    need_geo = bool(needs[2]) if len(needs) > 2 else True
    if exact_order and (wet_zero is not None or compose_raw):
        raise ValueError("exact_order: an eval path, no wet hook and no "
                         "slab composition")
    H, W = ray_o.shape[:2]
    dev = ray_o.device
    P = scene.mean.shape[0]
    A = scene.aux.shape[-1]
    K = per_tile_cap or default_per_tile_cap(P)
    ty, tx = -(-H // RTH), -(-W // RTW)
    with torch.no_grad():  # the cull is integer and carries no gradient
        with span("env.tiles"):
            tiles = build_ray_tiles(ray_o, ray_d)
        with span("env.cull"):
            gauss_idx, bounds, dropped, cut = cull_and_sort(
                tiles, scene, splat_radius3(scene), per_tile_cap=K,
                total_pair_cap=total_pair_cap,
                tile_mask=None if ray_mask is None else tile_mask_of(
                    ray_mask),
                probe=probe)
            count("env.pairs", bounds, at=-1)
            count("env.slots", gauss_idx.numel())
            count("env.cut", cut)
    wet = torch.zeros(P, dtype=torch.float32, device=dev)
    if exact_order:
        # eval-time exact per-ray blend order over the same candidate
        # windows; every output, whatever `needs` says
        with torch.no_grad():
            Kw = max(min(K // CHUNK, -(-P // CHUNK)), 1) * CHUNK
            te = _trace_tiles_exact(scene, tiles.rays, gauss_idx, bounds, Kw)
        img = (te.reshape(ty, tx, 10 + A, RTH, RTW).permute(2, 0, 3, 1, 4)
               .reshape(10 + A, ty * RTH, tx * RTW)[:, :H, :W])
        acc, trans = img[4], img[9]
        return TraceOutput(
            rgb=img[:3].permute(1, 2, 0) + trans[..., None] * bg_color,
            dpt=torch.where(acc > 1e-8, img[3] / torch.clamp(acc, min=1e-8),
                            0.0),
            acc=acc,
            norm=img[5:8].permute(1, 2, 0),
            dist=img[8],
            aux=img[10:].permute(1, 2, 0),
            wet=wet,
            trans=trans,
            dropped_pairs=dropped,
            num_pairs=bounds[-1],
            cut_chunks=cut,
        )
    packed = _pack_scene_table(scene)
    fwd_wet = need_wet and wet_zero is None
    grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad
        for x in (packed, ray_o, ray_d, wet_zero))
    wet_slots = None
    with span("env.blend"):
        if grad:
            # the backward reads d1, d2 and last: the training configuration
            res = trace_blend_train(
                packed, ray_planes(ray_o, ray_d),
                None if wet_zero is None
                else torch.nn.functional.pad(wet_zero, (0, 1)),
                gauss_idx, bounds, tx, ty, A, fwd_wet=fwd_wet)
            img, wet_slots = res if fwd_wet else (res, None)
            need_dist = True
        elif need_dist or fwd_wet:
            res = trace_blend(packed, gauss_idx, tiles.rays, bounds, tx, ty,
                              train=True, A=A, wet=fwd_wet)
            img, wet_slots = res if fwd_wet else (res, None)
        else:
            img = trace_blend(packed, gauss_idx, tiles.rays, bounds, tx, ty,
                              A=A, geo=need_geo)
    img = img[:, :H, :W]
    F = img.shape[0]
    r = rows(A)
    zeros = torch.zeros_like(img[0])
    if F == 5:  # the render configuration: rgb, acc, T
        plane = {"acc": img[3], "trans": img[4]}
    else:
        plane = {k: img[r[k]] for k in ("acc", "trans", "dpt", "dist")}
        plane["normal"] = img[r["normal"]:r["normal"] + 3]
        plane["aux"] = img[r["aux"]:r["aux"] + A]
        if F == 13 + A:
            plane["d1"], plane["d2"] = img[r["d1"]], img[r["d2"]]
    # the strips asked for off come back zero, as the JAX kernel leaves
    # them; where autograd records, their gradient still reaches the blend
    # (the JAX backward reads the cotangent of every plane)
    strip = (lambda x: x - x.detach()) if grad else torch.zeros_like
    if not need_geo:
        for k in ("dpt", "normal", "aux"):
            if k in plane:
                plane[k] = strip(plane[k])
    if not need_dist:
        for k in ("dist", "d1", "d2"):
            if k in plane:
                plane[k] = strip(plane[k])
    acc, trans = plane["acc"], plane["trans"]
    dptw = plane.get("dpt", zeros)
    if compose_raw:
        rgb, dpt = img[:3].permute(1, 2, 0), dptw
    else:
        rgb = img[:3].permute(1, 2, 0) + trans[..., None] * bg_color
        dpt = torch.where(acc > 1e-8, dptw / torch.clamp(acc, min=1e-8), 0.0)
    if wet_slots is not None:
        sums = torch.zeros(P + 1, dtype=torch.float32, device=dev)
        sums.index_add_(0, gauss_idx.to(torch.int64), wet_slots.detach())
        wet = sums[:P]
    normal = plane.get("normal", zeros[None].expand(3, H, W))
    aux = plane.get("aux", zeros[None].expand(A, H, W))
    return TraceOutput(
        rgb=rgb,
        dpt=dpt,
        acc=acc,
        norm=normal.permute(1, 2, 0),
        dist=plane.get("dist", zeros),
        aux=aux.permute(1, 2, 0),
        wet=wet,
        trans=trans,
        dropped_pairs=dropped,
        d1=plane.get("d1", zeros) if compose_raw else None,
        d2=plane.get("d2", zeros) if compose_raw else None,
        num_pairs=bounds[-1],
        cut_chunks=cut,
    )


def trace_rays_multibounce(
    scene: TraceScene,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    bg_color: torch.Tensor,
    max_trace_depth: int = 0,
    specular_threshold: float = 0.0,
    backend: str = "tiled",
    total_pair_cap: int | None = 2 ** 21,
    ray_mask: torch.Tensor | None = None,
    per_tile_cap: int | None = None,
):
    """Recursive specular tracing (the JAX package's max_trace_depth > 0
    path). Each bounce b traces the current rays; rays whose blended
    specular (aux channel 0) exceeds `specular_threshold` and whose hit is
    solid (acc > 0.5) spawn reflected rays at the blended hit (origin o +
    dpt d, direction reflected about the blended normal). Bounce colours
    composite back to front, rgb_b' = (1 - s_b) rgb_b + s_b rgb_{b+1}, on
    the reflected set. backend "tiled": trace_rays with JAX's default
    needs and no hook (the training configuration with the forward wet)
    and `per_tile_cap`, "ref": the reference tracer. -> (bounce 0's
    TraceOutput with the composited rgb and the chunks cut summed over the
    bounces, the per-bounce TraceOutput list)."""
    check_backend("tracer", backend)
    scene_has_spec = scene.aux.shape[-1] > 0

    def trace(o, d, m):
        if backend == "ref":
            return trace_rays_reference(scene, o, d, bg_color)
        return trace_rays(scene, o, d, bg_color, per_tile_cap=per_tile_cap,
                          total_pair_cap=total_pair_cap, ray_mask=m,
                          needs=(True, True, True))

    bounces, masks = [], []
    o, d, m = ray_o, ray_d, ray_mask
    for b in range(max_trace_depth + 1):
        out = trace(o, d, m)
        bounces.append(out)
        if b == max_trace_depth:
            break
        n = out.norm * torch.rsqrt(
            torch.sum(out.norm * out.norm, -1, keepdim=True) + 1e-12)
        d_new = d - 2.0 * torch.sum(d * n, -1, keepdim=True) * n
        o_new = o + d * out.dpt[..., None]
        spec_b = (out.aux[..., 0] if scene_has_spec
                  else torch.zeros_like(out.acc))
        bounce_m = (spec_b > specular_threshold) & (out.acc > 0.5)
        m = bounce_m if m is None else (m & bounce_m)
        masks.append(m)
        o, d = o_new, d_new
    rgb = bounces[-1].rgb
    for b in range(max_trace_depth - 1, -1, -1):
        s = (torch.clamp(bounces[b].aux[..., :1], 0.0, 1.0) if scene_has_spec
             else torch.zeros_like(bounces[b].rgb[..., :1]))
        mixed = (1.0 - s) * bounces[b].rgb + s * rgb
        rgb = torch.where(masks[b][..., None], mixed, bounces[b].rgb)
    cut = None
    if backend != "ref":
        cut = torch.stack([b.cut_chunks for b in bounces]).sum(
            dtype=torch.int32)
    return bounces[0]._replace(rgb=rgb, cut_chunks=cut), bounces

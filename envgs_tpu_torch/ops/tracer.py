"""Surfel ray tracer: ray-tile cone culling + the traced blend (port of
envgs_tpu/ops/tracer.py: the render path and the training path).

Per frame: 16x16 ray tiles become cones with direction-space probe boxes
(`build_ray_tiles`); splats are Morton-chunked (`build_chunk_index`); each
tile keeps the nearest chunks whose bounding spheres meet its cone, refines
them per splat (sphere test, then the direction-space footprint probe) and
sorts the kept candidates by quantized radial distance from the tile apex
(`cull_and_sort`); the traced blend (kernel K3 on CUDA tensors) composites
each tile's candidates front to back. Blend order is the per-tile radial
order, the JAX package's documented deviation from per-ray order.

The training path (`needs` all True with a `wet_zero` hook) blends in
training mode (kernels K3 and K4): the cull stays integer and carries no
gradient; the gradient reaches the scene table and, through the ray tiles
(`ray_planes`, plain differentiable torch ops), the ray origins and
directions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import ALPHA_MIN
from envgs_tpu_torch.ops.raster_blend import CHUNK, LO
from envgs_tpu_torch.ops.trace_blend import rows, trace_blend, trace_blend_train
from envgs_tpu_torch.ops.tracer_ref import TraceOutput, TraceScene

RTH = 16  # tile height in rays
RTW = 16  # tile width in rays
NRAY = RTH * RTW
NQUAD = 4  # probe boxes per tile (2x2 spatial quadrants of the ray grid)
# elements of one (tiles, candidates) plane of a cull block: 64 MB in f32.
# The bench scene (6435 tiles x 2048 candidates) then culls in one block;
# its render peaked at 3.1 GiB of device memory (H100 80GB HBM3, 700 W)
_CULL_BLOCK_ELEMS = 1 << 24


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


def _block_cull(idx: ChunkIndex, packed_cand, cand_idx, Kc: int, P: int,
                apex, axis, tan_half, spread, tmask, pframe, pbox, pok):
    """Cull and radially sort the candidates of a block of B tiles:
    (cid_sorted (B, Kc*CHUNK) int64, keep (B, Kc*CHUNK) bool)."""
    B = apex.shape[0]
    C = Kc * CHUNK
    # ---- coarse: cone vs chunk spheres ----
    cmeanT = idx.cmean.T
    cm2 = torch.sum(idx.cmean * idx.cmean, dim=-1)
    proj = axis @ cmeanT - torch.sum(axis * apex, -1, keepdim=True)
    d2 = (cm2[None, :] - 2.0 * (apex @ cmeanT)
          + torch.sum(apex * apex, -1, keepdim=True))
    d2 = torch.clamp(d2, min=0.0)
    axis_dist = torch.sqrt(torch.clamp(d2 - proj * proj, min=0.0))
    slack = spread[:, None] + idx.crad[None, :] * (1.0 + tan_half[:, None])
    hit = axis_dist <= proj * tan_half[:, None] + slack
    near = d2 <= slack * slack
    keep = (hit | near) & (proj + idx.crad[None, :] > 0)
    keep = keep & idx.cact[None, :] & tmask[:, None]
    radial = torch.where(keep, torch.sqrt(d2), float("inf"))
    # the Kc nearest chunks, ties to the lower chunk index (lax.top_k's rule)
    srt = torch.sort(radial, dim=-1, stable=True)
    idc = srt.indices[:, :Kc]
    cvalid = srt.values[:, :Kc] < float("inf")
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
    slu = crc * torch.sqrt(torch.clamp(1.0 + u0 * u0 - bnu * bnu, min=0.0)) * scl
    slv = crc * torch.sqrt(torch.clamp(1.0 + v0 * v0 - bnv * bnv, min=0.0)) * scl
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
    return cid_sorted, keep_s


def cull_and_sort(
    tiles: RayTiles, scene: TraceScene, radius3: torch.Tensor,
    per_tile_cap: int = 4096, tile_block: int | None = None,
    total_pair_cap: int | None = None,
    tile_mask: torch.Tensor | None = None,
):
    """Hierarchical cone culling -> chunk-aligned radially sorted slots.

    Returns (gauss_idx (cap_aligned,) int32 pool indices with sentinel P,
    tile_bounds (T+1,) int32 64-aligned, dropped () int32 slots cut by
    `total_pair_cap`). Tiles are culled `tile_block` at a time; each
    tile's result is independent of the blocking. The default takes as
    many tiles as keep each (tiles, candidates) plane within
    _CULL_BLOCK_ELEMS: each block is a long chain of small torch ops, so
    fewer blocks mean fewer launches, and launches bound the render."""
    dev = scene.mean.device
    P = scene.mean.shape[0]
    T = tiles.n_tiles
    idx = build_chunk_index(scene, radius3)
    NC = idx.cmean.shape[0]
    Kc = max(min(per_tile_cap // CHUNK, NC), 1)
    K = Kc * CHUNK
    tile_block = tile_block or max(1, _CULL_BLOCK_ELEMS // K)
    cand_idx = idx.order.reshape(NC, CHUNK)
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
        [idx.mean_s[:, 0], idx.mean_s[:, 1], idx.mean_s[:, 2], idx.rad_s,
         nrm_s[:, 0], nrm_s[:, 1], nrm_s[:, 2], rc_s],
        dim=0).reshape(8, NC, CHUNK).permute(1, 0, 2)  # (NC, 8, CHUNK)
    if tile_mask is None:
        tile_mask = torch.ones(T, dtype=torch.bool, device=dev)
    ids, keeps = [], []
    for b0 in range(0, T, tile_block):
        sl = slice(b0, min(b0 + tile_block, T))
        cs, ks = _block_cull(
            idx, packed_cand, cand_idx, Kc, P, tiles.apex[sl],
            tiles.axis[sl], tiles.tan_half[sl], tiles.spread[sl],
            tile_mask[sl], tiles.probe_frame[sl], tiles.probe_box[sl],
            tiles.probe_ok[sl])
        ids.append(cs)
        keeps.append(ks.sum(-1, dtype=torch.int32))
    idmat = torch.cat(ids)  # (T, K)
    counts = torch.cat(keeps)  # (T,)
    padded = -(-counts // CHUNK) * CHUNK
    poffs = torch.cat([counts.new_zeros(1),
                       torch.cumsum(padded, 0, dtype=torch.int32)])
    cap_aligned = -(-(T * K + T * CHUNK) // 1024) * 1024
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if total_pair_cap is not None:
        cap_aligned = min(cap_aligned, -(-total_pair_cap // 1024) * 1024)
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
    return gauss_aligned.to(torch.int32), poffs, dropped


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
    exact_order: bool = False,
) -> TraceOutput:
    """Tiled tracer over an (H, W) ray grid.

    needs = (need_dist, need_wet, need_geo): all False is the render path
    (depth, normal, aux, distortion and wet come back zero, as in the JAX
    package's render mode); all True with the (P,) zeros hook `wet_zero` is
    the training path (TraceOutput.wet exact zeros: wet is the hook's
    gradient). ray_mask (H, W) bool culls whole ray tiles with no
    masked-in ray."""
    train = all(needs) and wet_zero is not None
    if (any(needs) and not train) or exact_order:
        raise NotImplementedError(
            f"trace_rays needs={needs} wet_zero given: {wet_zero is not None}"
            f" exact_order={exact_order}: the render path and the train path"
            " (all needs with the wet_zero hook) are ported; forward wet and"
            " the exact per-ray order are not")
    H, W = ray_o.shape[:2]
    dev = ray_o.device
    P = scene.mean.shape[0]
    A = scene.aux.shape[-1]
    K = per_tile_cap or default_per_tile_cap(P)
    ty, tx = -(-H // RTH), -(-W // RTW)
    with torch.no_grad():  # the cull is integer and carries no gradient
        tiles = build_ray_tiles(ray_o, ray_d)
        tile_mask = None
        if ray_mask is not None:
            m = torch.nn.functional.pad(ray_mask.to(torch.bool),
                                        (0, tx * RTW - W, 0, ty * RTH - H))
            tile_mask = (m.reshape(ty, RTH, tx, RTW).permute(0, 2, 1, 3)
                         .reshape(tiles.n_tiles, NRAY).any(dim=1))
        gauss_idx, bounds, dropped = cull_and_sort(
            tiles, scene, splat_radius3(scene), per_tile_cap=K,
            total_pair_cap=total_pair_cap, tile_mask=tile_mask)
    packed = _pack_scene_table(scene)
    wet = torch.zeros(P, dtype=torch.float32, device=dev)
    if train:
        img = trace_blend_train(packed, ray_planes(ray_o, ray_d),
                                torch.nn.functional.pad(wet_zero, (0, 1)),
                                gauss_idx, bounds, tx, ty, A)[:, :H, :W]
        r = rows(A)
        acc, trans = img[r["acc"]], img[r["trans"]]
        return TraceOutput(
            rgb=img[:3].permute(1, 2, 0) + trans[..., None] * bg_color,
            dpt=torch.where(acc > 1e-8,
                            img[r["dpt"]] / torch.clamp(acc, min=1e-8), 0.0),
            acc=acc,
            norm=img[r["normal"]:r["normal"] + 3].permute(1, 2, 0),
            dist=img[r["dist"]],
            aux=img[r["aux"]:r["aux"] + A].permute(1, 2, 0),
            wet=wet,
            trans=trans,
            dropped_pairs=dropped,
            num_pairs=bounds[-1],
        )
    img = trace_blend(packed, gauss_idx, tiles.rays, bounds, tx, ty)[:, :H, :W]
    acc, trans = img[3], img[4]
    zeros = torch.zeros_like(acc)
    return TraceOutput(
        rgb=img[:3].permute(1, 2, 0) + trans[..., None] * bg_color,
        dpt=zeros,
        acc=acc,
        norm=zeros[..., None].expand(H, W, 3),
        dist=zeros,
        aux=zeros[..., None].expand(H, W, A),
        wet=wet,
        trans=trans,
        dropped_pairs=dropped,
        num_pairs=bounds[-1],
    )

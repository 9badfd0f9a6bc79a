"""The designs of kernels K1 (raster blend forward) and K5 (fill-forward),
on the CPU.

K1 tests, per (pair, warp), whether the pair's alpha-floor footprint may
reach the warp's patch (`may_reach`, modelled by
`blend_variants.footprint_may`), and a warp evaluates a pair only where it
may and some pixel of the warp can still take it; it sums each pair's wet
over a warp of 16x2 pixels by a shuffle tree. K5 carries the last marker
between blocks by a decoupled look-back. The kernels themselves run only on
a card, where they are held against their plain versions. These cases guard
the designs' models: the footprint model refuses no pixel the exact terms
admit (over random surfels from round to thin and edge-on, opacities up to
0.99, and 3DGS conics with the 0.3 low-pass), the walk with every skip
gives the plain forward's planes and wet to the bit in all four
configurations, the wet's tree is the plain version's order, and the
look-back gives the plain fill-forward on ragged inputs. What ties them to
the sources: the footprint test's constants, the warps' shapes, the skip's
votes and K5's block size are parsed from the `.cu` files.

    python -m pytest tests/test_torch_raster_fwd_design.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.binning import aligned_markers, bin_splats
from envgs_tpu_torch.ops.common import (
    ALPHA_MIN,
    ROWCULL_LOWPASS_R,
    T_CUTOFF,
    prepare_splats,
)
from envgs_tpu_torch.ops.fill_forward import fill_forward_torch
from envgs_tpu_torch.ops.raster import _pack_table
from envgs_tpu_torch.ops.raster3d import bin_and_pack, prepare_gaussians3d
from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    NPIX,
    TILE,
    _map_depth,
    _pixel_coords,
    _pixel_sum,
    _terms,
    _to_image,
    _window_index,
    blend_tiles_torch,
)
from envgs_tpu_torch.probes import blend_variants
from envgs_tpu_torch.utils.camera import make_camera

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "envgs_tpu_torch"
        / "kernels" / "csrc")
K1_SOURCE = CSRC / "raster_blend_fwd.cu"
K5_SOURCE = CSRC / "fill_forward.cu"
H, W = 48, 64  # 3 x 4 tiles
C = 3


def _camera():
    f = 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return make_camera(H, W, K, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))


def _quats(rng, n, mean_dir=None):
    """Random unit quaternions (w, x, y, z); with `mean_dir` (n, 3), the
    rotation takes the local z axis (the surfel's normal) perpendicular to
    mean_dir, give or take 1e-3 rad: surfels seen edge-on."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if mean_dir is None:
        return q
    d = mean_dir / np.linalg.norm(mean_dir, axis=1, keepdims=True)
    side = np.cross(d, rng.normal(size=(n, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    normal = side + 1e-3 * rng.normal(size=(n, 3)) * d
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    # rotate z onto `normal`: axis z x normal, angle acos(normal_z)
    axis = np.cross(np.array([0.0, 0.0, 1.0]), normal)
    s = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = axis / np.maximum(s, 1e-12)
    half = 0.5 * np.arccos(np.clip(normal[:, 2], -1, 1))[:, None]
    return np.concatenate([np.cos(half), axis * np.sin(half)], 1)


def _surfels(seed, P=400, edge_on=0.2, opacity=(0.05, 0.99), wall=0):
    """P seeded surfels in front of the camera: depths 1-6, sizes over a
    decade and a half, anisotropy up to 100, a share seen edge-on; and
    `wall` round, nearly opaque ones facing the camera in front of the
    image's left third, where pixels saturate. -> (means, quats, scales
    (P + wall, 2), opacities, colors)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, P)
    xyz = np.stack([rng.uniform(-0.6, 0.6, P) * z,
                    rng.uniform(-0.45, 0.45, P) * z, z], 1)
    q = _quats(rng, P)
    edge = rng.random(P) < edge_on
    q[edge] = _quats(rng, int(edge.sum()), xyz[edge])
    su = np.exp(rng.uniform(np.log(0.01), np.log(0.3), P))
    sv = su / np.exp(rng.uniform(0, np.log(100.0), P))
    scales = np.stack([su, sv], 1)
    opac = rng.uniform(*opacity, P)
    if wall:
        zw = rng.uniform(0.8, 1.0, wall)
        xyz = np.concatenate([xyz, np.stack(
            [rng.uniform(-0.55, -0.2, wall) * zw,
             rng.uniform(-0.4, 0.4, wall) * zw, zw], 1)])
        q = np.concatenate([q, np.tile([[1.0, 0, 0, 0]], (wall, 1))])
        scales = np.concatenate([scales, np.full((wall, 2), 0.08)])
        opac = np.concatenate([opac, np.full(wall, 0.99)])
        P += wall
    colors = rng.random((P, C))
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    return f32(xyz), f32(q), f32(scales), f32(opac), f32(colors)


def _k1_inputs(seed, aligned, mode="surfel"):
    """K1's arguments for a seeded scene: surfels through prepare_splats and
    bin_splats (render layout, or the aligned training layout), or 3D
    Gaussians (three scales, the 0.3 low-pass) through bin_and_pack."""
    cam = _camera()
    xyz, q, scales, opac, colors = _surfels(seed, wall=40)
    if mode == "gauss3d":
        s3 = torch.cat([scales, scales[:, :1] * 0.5], 1)
        prep = prepare_gaussians3d(xyz, q, s3, opac, colors, cam)
        packed, bins = bin_and_pack(prep, cam, 1 << 15)
    else:
        prep = prepare_splats(xyz, q, scales, opac, colors, cam)
        bins = bin_splats(prep, H, W, TILE, 1 << 15, align=CHUNK,
                          lowpass_r=ROWCULL_LOWPASS_R, aligned=aligned)
        packed = _pack_table(prep, bins.order)
    return (packed, bins.gauss_idx, bins.tile_bounds, C, bins.tiles_x,
            bins.tiles_y)


def _warp_of_pixel(shape):
    """(256,) the warp of each pixel of a tile (row-major) for warps of
    `shape`, numbered as the kernel numbers them."""
    w, h = shape
    lane = torch.arange(NPIX)
    ix, iy = lane % TILE, lane // TILE
    return (iy // h) * (TILE // w) + ix // w


def raster_blend_skip_model(packed, gidx, bounds, C, tiles_x, tiles_y,
                            train=False, mode="surfel", wet=False):
    """Model of the new K1's walk: blend_tiles_torch's loop in which a
    warp (8x4, or 16x2 with the wet) evaluates a pair only where the
    footprint model lets it reach the warp's patch and some pixel of the
    warp has neither failed in this window nor saturated, and a tile stops
    after the window in which all its pixels saturated. -> (planes, wet or
    None, (pair, warp) combinations evaluated)."""
    terms = _terms(mode)
    shape = (16, 2) if wet else (8, 4)
    T = tiles_x * tiles_y
    P = packed.shape[0] - 1
    start = bounds[:-1].to(torch.int64)
    end = bounds[1:].to(torch.int64)
    wstart = start - start % 8
    nwin = ((end - wstart + CHUNK - 1) // CHUNK).clamp(min=0)
    px, py = _pixel_coords(T, tiles_x, 0, packed.device)
    x0, y0 = blend_variants.warp_origins(shape, T, tiles_x, 0, packed.device)
    warp_of = _warp_of_pixel(shape)
    zeros = lambda: torch.zeros((T, NPIX))  # noqa: E731
    color = [zeros() for _ in range(C)]
    nrm = [zeros() for _ in range(3)]
    dep, alp, dist, d1, d2, med = (zeros() for _ in range(6))
    last = torch.full((T, NPIX), -1.0)
    trans = torch.ones((T, NPIX))
    dead = torch.zeros((T, NPIX), dtype=torch.bool)
    walking = torch.ones(T, dtype=torch.bool)
    wet_pairs = torch.zeros(gidx.shape[0])
    evaluated = 0
    for c in range(int(nwin.max()) if T else 0):
        in_tile = (c < nwin) & walking
        rows_c = packed[_window_index(gidx, start, end, wstart + c * CHUNK,
                                      P)]
        fail = torch.zeros_like(dead)
        for j in range(CHUNK):
            may = blend_variants.footprint_may(rows_c[:, j, None, :], x0, y0,
                                               *shape, mode)
            stop = ~blend_variants._warp_any(~(fail | dead), shape)
            ev_warp = may & ~stop & in_tile[:, None]
            evaluated += int(ev_warp.sum())
            ev = ev_warp[:, warp_of]
            col = rows_c[:, j, :, None].unbind(1)
            s = terms(col, px, py)
            a, z = s["a"], s["z"]
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = ev & s["amask"] & ~fail & passed
            fail = fail | (ev & s["amask"] & ~passed)
            w = torch.where(contrib, a * trans, 0.0)
            if wet:
                i = wstart + c * CHUNK + j
                inb = (i >= start) & (i < end) & in_tile
                wet_pairs[i[inb]] = _pixel_sum(w)[inb]
            if train:
                m = _map_depth(z)
                wm = w * m
                dist = dist + w * (m * m * alp + d2 - 2.0 * m * d1)
                d1 = d1 + wm
                d2 = d2 + wm * m
                med = torch.where(contrib & (trans > 0.5), z, med)
                last = torch.where(contrib, float(c * CHUNK + j), last)
            for k in range(C):
                color[k] = color[k] + w * col[15 + k]
            dep = dep + w * z
            alp = alp + w
            for k in range(3):
                nrm[k] = nrm[k] + w * col[12 + k]
            trans = torch.where(contrib, test, trans)
            dead = ~(trans * (1.0 - ALPHA_MIN) >= T_CUTOFF)
        walking = walking & ~dead.all(1)
    if train:
        planes = color + [dep, alp] + nrm + [med, dist, trans, d1, d2, last]
    else:
        planes = color + [dep, alp] + nrm + [trans]
    return (_to_image(torch.stack(planes), tiles_x, tiles_y),
            wet_pairs if wet else None, evaluated)


# render, render with the median depth, train, gauss3d with the wet
CONFIGS = {"render": (False, False, "surfel", False),  # aligned, train, ...
           "median": (False, True, "surfel", False),
           "train": (True, True, "surfel", False),
           "gauss3d": (True, True, "gauss3d", True)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_with_every_skip_changes_no_plane(config, seed):
    """The pairs a warp skips (footprint out of reach, every pixel failed
    or saturated) and the windows a saturated tile no longer walks could
    not have contributed: planes and wet are array-equal to the plain
    forward's, while a good part of the (pair, warp) combinations is not
    evaluated."""
    aligned, train, mode, wet = CONFIGS[config]
    args = _k1_inputs(seed, aligned, mode)
    want = blend_tiles_torch(*args, 0, train, mode, wet)
    got, got_wet, evaluated = raster_blend_skip_model(*args, train, mode,
                                                      wet)
    if wet:
        want, want_wet = want
        assert torch.equal(got_wet, want_wet)
        assert float(want_wet.max()) > 1.0
    assert torch.equal(got, want)
    bounds = args[2].to(torch.int64)
    start = bounds[:-1] - bounds[:-1] % 8
    walked = int(((bounds[1:] - start + CHUNK - 1) // CHUNK).sum())
    assert 0 < evaluated < 0.8 * walked * CHUNK * 8
    trans = want[C + 7 if train else C + 5]
    assert float(trans.min()) < 1e-3  # pixels saturate


def test_probe_counts_agree_with_the_skip_model():
    """The probe's count of the (pair, warp) combinations the new kernel
    evaluates is the skip model's."""
    for config in ("render", "gauss3d"):
        aligned, train, mode, wet = CONFIGS[config]
        args = _k1_inputs(3, aligned, mode)
        counts = blend_variants.raster_counts(args, mode)
        _, _, evaluated = raster_blend_skip_model(*args, train, mode, wet)
        shape = "16x2" if wet else "8x4"
        assert counts[f"slot_warps_evaluated_{shape}"] == evaluated
        assert (counts[f"slot_warps_contributing_{shape}"]
                <= counts[f"slot_warps_foot_{shape}"]
                <= counts[f"slot_warps_model_{shape}"]
                <= counts["slot_warps_walked"])
        assert counts["windows_walked"] <= counts["windows"]


def _exact_and_model(packed, mode, shape):
    """Every row of `packed` against every tile of the camera: (exact amask
    any over each warp's pixels, the footprint model) (P, tiles, 8)."""
    tiles_x, tiles_y = W // TILE, H // TILE
    T = tiles_x * tiles_y
    px, py = _pixel_coords(T, tiles_x, 0, packed.device)
    x0, y0 = blend_variants.warp_origins(shape, T, tiles_x, 0, packed.device)
    terms = _terms(mode)
    col = packed[:, None, :, None].expand(-1, T, -1, -1).unbind(2)
    amask = terms(col, px, py)["amask"]  # (P, T, 256)
    P = packed.shape[0]
    exact = blend_variants._warp_any(amask.reshape(P * T, NPIX), shape)
    may = blend_variants.footprint_may(packed[:, None, None, :], x0, y0,
                                       *shape, mode)
    return exact.reshape(P, T, -1), may


@pytest.mark.parametrize("shape", blend_variants.WARP_SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_footprint_test_refuses_no_pixel_the_exact_test_admits(seed, shape):
    """Surfels of every size, anisotropy up to 100, a fifth of them seen
    edge-on, opacities from under the floor to 0.99, each against every
    warp of the image: wherever the exact terms admit a pixel of a warp's
    patch, the footprint test lets the pair through; and it turns away
    most of the (pair, warp) combinations the exact terms refuse."""
    cam = _camera()
    xyz, q, scales, opac, colors = _surfels(seed, P=600, edge_on=0.3,
                                            opacity=(0.002, 0.99))
    prep = prepare_splats(xyz, q, scales, opac, colors, cam)
    packed = _pack_table(prep)[:-1]
    exact, may = _exact_and_model(packed, "surfel", shape)
    assert int(exact.sum()) > 500
    assert not bool((exact & ~may).any())
    assert int((~exact & ~may).sum()) > 0.6 * int((~exact).sum())
    under = packed[:, 11] < ALPHA_MIN
    assert bool(under.any()) and not bool(may[under].any())


@pytest.mark.parametrize("shape", blend_variants.WARP_SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_footprint_test_is_safe_for_gauss3d_conics(seed, shape):
    """3D Gaussians through the EWA projection with the 0.3 low-pass: round
    to a hundred times longer than wide, at any angle, opacities to 0.99."""
    cam = _camera()
    xyz, q, scales, opac, colors = _surfels(seed, P=600,
                                            opacity=(0.002, 0.99))
    s3 = torch.cat([scales, scales[:, :1] * 0.3], 1)
    prep = prepare_gaussians3d(xyz, q, s3, opac, colors, cam)
    packed, _ = bin_and_pack(prep, cam, 1 << 15)
    packed = packed[:-1]
    exact, may = _exact_and_model(packed, "gauss3d", shape)
    assert int(exact.sum()) > 500
    assert not bool((exact & ~may).any())
    assert int((~exact & ~may).sum()) > 0.6 * int((~exact).sum())


def test_footprint_test_at_its_edges():
    """What the test does with rows the tables do not hold: a NaN opacity
    (whose exact alpha is fminf(NaN, 0.99) = 0.99) and a conic that is not
    positive definite let the pair through (the exact terms decide); the
    zero row of padding and a splat far off are refused."""
    row = torch.zeros(LO)
    x0, y0 = torch.tensor([0.0]), torch.tensor([0.0])
    may = lambda r, mode: bool(blend_variants.footprint_may(  # noqa: E731
        r, x0, y0, 8, 4, mode)[0])
    assert not may(row, "surfel") and not may(row, "gauss3d")
    far = row.clone()
    far[9], far[10], far[11] = 500.0, 500.0, 0.9
    far[0], far[2] = 1.0, 1.0  # a unit conic, far off
    far[6:9] = torch.tensor([0.0, 0.0, 1.0])
    far[0:6] = torch.tensor([1.0, 0.0, 500.0, 0.0, 1.0, 500.0])
    assert not may(far, "surfel")
    g = torch.zeros(LO)
    g[0], g[2], g[9], g[10], g[11] = 1.0, 1.0, 500.0, 500.0, 0.9
    assert not may(g, "gauss3d")
    for r, mode in ((far, "surfel"), (g, "gauss3d")):
        bad = r.clone()
        bad[11] = float("nan")
        assert may(bad, mode), mode
    indefinite = g.clone()
    indefinite[1] = 2.0  # b^2 > a c
    assert may(indefinite, "gauss3d")


def shfl_down_tree(v: torch.Tensor) -> torch.Tensor:
    """Model of K1's warp_sum: v (..., 32) -> (...,) lane 0 after
    __shfl_down_sync by 16, 8, 4, 2, 1 (a lane whose source is past lane 31
    adds its own value, which lane 0 never reads)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        src = torch.where(lanes + o < 32, lanes + o, lanes)
        v = v + v[..., src]
    return v[..., 0]


def kernel_wet_model(w: torch.Tensor, shape=(16, 2)) -> torch.Tensor:
    """K1's wet of one pair: w (T, 256) per pixel -> (T,): each warp of
    `shape` (lanes in the kernel's order) summed by the shuffle tree into
    its slot, the 8 slots then added in order after 0."""
    warp_of = _warp_of_pixel(shape)
    per_warp = torch.stack([w[:, warp_of == k] for k in range(NPIX // 32)],
                           1)  # (T, 8, 32), lanes in pixel order
    s = torch.zeros(w.shape[0])
    for k, part in enumerate(shfl_down_tree(per_warp).unbind(1)):
        s = s + part
    return s


@pytest.mark.parametrize("live", ["all", "half", "one lane", "none"])
def test_wet_tree_is_the_plain_versions_order(live):
    """The wet of a pair summed as the kernel sums it (16x2 warps, the
    shuffle tree, the warps in order) is _pixel_sum's value to the bit,
    also where a warp has a single live lane or none; 8x4 warps would sum
    the same numbers in another order."""
    rng = np.random.default_rng(4)
    w = torch.tensor(rng.random((64, NPIX)).astype(np.float32))
    if live == "half":
        w = torch.where(torch.tensor(rng.random((64, NPIX)) < 0.5), w, 0.0)
    elif live == "one lane":
        keep = torch.zeros((64, NPIX), dtype=torch.bool)
        keep[torch.arange(64), torch.tensor(rng.integers(0, NPIX, 64))] = True
        w = torch.where(keep, w, 0.0)
    elif live == "none":
        w = torch.zeros_like(w)
    assert torch.equal(kernel_wet_model(w), _pixel_sum(w))
    if live in ("all", "half"):
        assert not torch.equal(kernel_wet_model(w, (8, 4)), _pixel_sum(w))


def fill_forward_lookback_model(vals, valid, block: int, seed: int = 0):
    """Model of K5: blocks of `block` positions scan their markers (running
    max of the position), publish an inclusive prefix at once where they
    hold a marker and `no marker` otherwise; then, in a random order (the
    kernel's blocks finish in any order), each looks back 32 blocks at a
    time for the nearest inclusive prefix, takes it as its carry and, if it
    holds no marker, publishes the carry as its own prefix."""
    n = valid.numel()
    nb = -(-n // block)
    pos = torch.where(valid != 0, torch.arange(n, dtype=torch.int64), -1)
    scan = torch.cummax(torch.nn.functional.pad(pos, (0, nb * block - n),
                                                value=-1)
                        .reshape(nb, block), 1).values
    agg = scan[:, -1]
    status = [("inclusive", int(a)) if a >= 0 else ("no marker", -1)
              for a in agg.tolist()]
    carry = [-1] * nb
    for b in np.random.default_rng(seed).permutation(nb).tolist():
        for p in range(b - 1, -1, -32):
            window = [status[q] for q in range(p, max(p - 32, -1), -1)]
            hits = [v for flag, v in window if flag == "inclusive"]
            if hits:
                carry[b] = hits[0]
                break
        if agg[b] < 0:
            status[b] = ("inclusive", carry[b])
    src = torch.maximum(scan, torch.tensor(carry)[:, None]).reshape(-1)[:n]
    return torch.where(src >= 0, vals[:, src.clamp(min=0)], 0)


def _ragged_markers(n, kind, rng):
    valid = torch.zeros(n, dtype=torch.int32)
    if kind == "ends":
        valid[0] = valid[-1] = 1
    elif kind == "sparse":
        valid[torch.tensor(rng.choice(n, max(1, n // 300), replace=False))] = 1
    elif kind == "empty runs":  # markers, then > 32 empty blocks, then more
        valid[:50:7] = 1
        valid[n - 40::9] = 1
    elif kind == "last only":
        valid[-1] = 1
    return valid


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 4099, 2048 * 3 + 17])
@pytest.mark.parametrize("kind", ["ends", "sparse", "empty runs",
                                  "last only", "none"])
def test_lookback_model_is_the_plain_fill_forward(n, kind):
    rng = np.random.default_rng(n)
    valid = _ragged_markers(n, kind, rng)
    vals = torch.tensor(rng.integers(-1000, 1000, (3, n)).astype(np.int32))
    want = fill_forward_torch(vals, valid)
    for block in (64, 2048):
        got = fill_forward_lookback_model(vals, valid, block, seed=n)
        assert torch.equal(got, want), block


def test_lookback_model_on_the_aligned_layouts_markers():
    """The markers aligned_markers leaves (each tile's aligned start, empty
    tiles sharing one, the long empty tail up to cap_aligned)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 300, 96)
    counts[10:60] = 0  # a run of empty tiles
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(counts)])
                          .astype(np.int32))
    marks, valid, _ = aligned_markers(bounds, int(bounds[-1]) + 1000, 96,
                                      CHUNK)
    assert int(valid[-5000:].sum()) == 0  # the empty tail
    want = fill_forward_torch(marks, valid)
    for block in (64, 2048):
        assert torch.equal(fill_forward_lookback_model(marks, valid, block),
                           want)


def _text(path):
    return path.read_text()


def test_sources_keep_the_models_constants():
    """The footprint test's margins, the warps' shapes and the skip's votes
    as the model has them, in every configuration the wrapper launches."""
    text = _text(K1_SOURCE)
    for name in ("FOOT_RHO_MARGIN", "FOOT_RHO_SLACK", "FOOT_EPS"):
        value = float(re.search(rf"{name} = ([0-9.e+-]+)f[;,]", text)
                      .group(1))
        assert value == getattr(blend_variants, name), name
    assert "constexpr int WW = WET ? 16 : 8, WH = 32 / WW;" in text
    assert "if (opac < ALPHA_MIN) return false;" in text
    assert "logf(opac / ALPHA_MIN)" in text
    assert "__all_sync(FULL, fail || dead)" in text
    assert "__syncthreads_or(!dead)" in text
    assert "T * (1.f - ALPHA_MIN) >= T_CUTOFF" in text
    assert "cp.async.cg.shared.global" in text
    assert ("constexpr float HX = 0.5f * (WW - 1), HY = 0.5f * (WH - 1);"
            in text)
    assert "ALPHA_MIN = (float)(1.0 / 255.0)" in text
    assert "T_CUTOFF = (float)1e-4" in text
    for mode in ("SURFEL", "GAUSS3D"):
        for train in ("true", "false"):
            for wet in ("true", "false"):
                assert f"F<{mode}, {train}, {wet}>::run(args...)" in text
    # map_depth keeps its two divisions (fused or shared reciprocals move
    # the comparisons, see K2)
    assert ("return (FAR_PLANE * (zc - NEAR_PLANE)) / (FAR_M_NEAR * zc);"
            in text)


def test_k5_block_and_scratch_are_the_wrappers():
    text = _text(K5_SOURCE)
    threads = int(re.search(r"constexpr int THREADS = (\d+);", text).group(1))
    per = int(re.search(r"constexpr int PER = (\d+);", text).group(1))
    assert threads * per == kernels.FF_BLOCK
    assert "sizeof(unsigned long long)\n" in text or (
        "sizeof(unsigned long long) * (nb + 1)" in " ".join(text.split()))
    # the wrapper's scratch holds the counter and a 64-bit word a block
    n = 2048 * 5 + 3
    nb = -(-n // kernels.FF_BLOCK)
    assert 2 * (nb + 1) * 4 >= 8 * (nb + 1)

"""The index algebra of the traced blend's kernels K3 and K4, on the CPU.

K4 sums each slot's gradient row over a warp's 32 rays by transposition:
the 16 columns every slot has in halving steps and one fold, the wet and
the aux values (1 + A of them, padded to a power of two) the same way on
their own; lanes 0-15 and 16 to 16 + A then add into the table row. K3
skips, warp by warp, the slots none of the warp's rays can still take. The
kernels themselves run only on a card, where they are held against their
plain versions. These cases guard the designs' models, not the kernels'
code: `transpose_reduce_model` and `trace_blend_skip_model` below are the
same steps written in PyTorch, so a wrong shuffle or vote in a `.cu` passes
them. What does tie to the sources: the slot-to-column map
(`bwd_slot_columns`) is held against the columns the plain backward writes
and against the constants parsed from `trace_blend_bwd.cu`, and the warp's
patch and the skip's constants against `trace_blend_fwd.cu`.

    python -m pytest tests/test_torch_trace_design.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from envgs_tpu_torch.ops.common import ALPHA_MIN, T_CUTOFF
from envgs_tpu_torch.ops.raster_blend import CHUNK, LO, NPIX, WET_COL, _to_image
from envgs_tpu_torch.ops.trace_blend import (
    _C_AUX,
    _C_COLOR,
    _C_N,
    _chunk_index,
    _ray_terms,
    bwd_slot_columns,
    trace_blend_bwd_torch,
    trace_blend_torch,
)
from envgs_tpu_torch.probes import blend_variants

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "envgs_tpu_torch"
        / "kernels" / "csrc")
K3_SOURCE = CSRC / "trace_blend_fwd.cu"
K4_SOURCE = CSRC / "trace_blend_bwd.cu"
HEADER = CSRC / "trace_blend.cuh"  # what the two share


def _text(path):
    """A source as compiled: its shared header, then the file."""
    text = path.read_text()
    assert text.count(f'#include "{HEADER.name}"') == 1
    return HEADER.read_text() + text


def transpose_reduce_model(v: torch.Tensor) -> torch.Tensor:
    """Model of the kernels' warp reduction by transposition: v (32 lanes,
    N slots), N a power of two -> (32,), what each lane holds in slot 0
    afterwards: lane l the sum over all lanes of slot l % N. In each halving
    step h = N/2 .. 1, lane l and its partner l ^ h split their 2h
    remaining slots: the lane with bit h set keeps the upper h, the other
    the lower h, each adding what the partner hands over; then one fold
    across each lane bit from N up to 16."""
    lanes = torch.arange(32)
    n = v.shape[1]
    if v.shape[0] != 32 or n not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"v: expected (32, power of two), got "
                         f"{tuple(v.shape)}")
    h = n // 2
    while h >= 1:
        up = ((lanes & h) != 0)[:, None]
        lo, hi = v[:, :h], v[:, h:2 * h]
        send = torch.where(up, lo, hi)
        keep = torch.where(up, hi, lo)
        v = keep + send[lanes ^ h]  # __shfl_xor_sync(send, h)
        h //= 2
    out = v[:, 0]
    o = n
    while o < 32:
        out = out + out[lanes ^ o]
        o *= 2
    return out


def extras_width(A: int) -> int:
    """Slots of the extras' row: 1 + A values padded to a power of two."""
    return {0: 1, 1: 2, 2: 4}[A]


def k4_row_model(v_out: torch.Tensor, x_out: torch.Tensor, A: int):
    """Model of what one warp adds to a splat's table row for one slot:
    v_out (32, 16) main slots and x_out (32, extras_width(A)) per lane ->
    (LO,) row: lanes 0-15 add main slot `lane` to column `lane`, lanes 16 to
    16 + A add extra `lane - 16` to its column."""
    main, extras = bwd_slot_columns(A)
    vm = transpose_reduce_model(v_out)
    vx = transpose_reduce_model(x_out)
    row = torch.zeros(LO)
    for lane in range(32):
        if lane < len(main):
            row[main[lane]] += vm[lane]
        elif lane < len(main) + 1 + A:
            row[extras[lane - len(main)]] += vx[lane]
    return row


@pytest.mark.parametrize("n", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_transposing_reduction_leaves_column_k_on_lane_k(n, seed):
    """Integer-valued floats: every partial sum is exact, so the model must
    equal the column sums to the bit whatever the order."""
    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.integers(-50, 50, (32, n)).astype(np.float32))
    assert torch.equal(transpose_reduce_model(v),
                       v.sum(0)[torch.arange(32) % n])


@pytest.mark.parametrize("A", [0, 1, 2])
@pytest.mark.parametrize("live", [[3], [0, 31], list(range(32))])
def test_k4_row_is_the_column_sums(A, live):
    """The row a warp adds equals the plain sums over its contributing
    lanes, column by column: main slots in columns 0-15, the wet in column
    31, the aux values in columns 16 and 17; nothing elsewhere."""
    rng = np.random.default_rng(10 * A + len(live))
    v_out = torch.zeros(32, 16)
    x_out = torch.zeros(32, extras_width(A))
    v_out[live] = torch.tensor(rng.integers(-9, 9, (len(live), 16))
                               .astype(np.float32))
    x_out[live, :1 + A] = torch.tensor(
        rng.integers(1, 9, (len(live), 1 + A)).astype(np.float32))
    want = torch.zeros(LO)
    want[:16] = v_out.sum(0)
    want[WET_COL] = x_out[:, 0].sum()
    for i in range(A):
        want[_C_AUX + i] = x_out[:, 1 + i].sum()
    got = k4_row_model(v_out, x_out, A)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) <= 16 + 1 + A


def _scene(A: int, seed: int = 0, tiles_x: int = 2, layers: int = 40):
    """Two ray tiles looking down +z at `layers` nearly opaque surfels per
    tile (two chunks of slots, the second partly padding), so rays saturate
    after a few hits; the right half of tile 1 looks away and meets
    nothing. -> K3's arguments."""
    rng = np.random.default_rng(seed)
    T = tiles_x
    P = layers * T
    packed = torch.zeros(P + 1, LO)
    rays = torch.zeros(T, 8, NPIX)
    ii, jj = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    idx = np.full((T, 2 * CHUNK), P, np.int32)
    for t in range(T):
        dx = (jj.reshape(-1) + 16 * t - 8 * T) * 0.02
        dy = (ii.reshape(-1) - 8) * 0.02
        d = np.stack([dx, dy, np.ones(NPIX)], 0)
        if t == 1:
            d[2, jj.reshape(-1) >= 8] = -1.0  # these rays look away
        rays[t, 3:6] = torch.tensor(d.astype(np.float32))
        rays[t, :3] = torch.tensor(rng.normal(size=(3, NPIX)) * 1e-3)
        z = np.sort(rng.uniform(1.0, 6.0, layers))
        rows = slice(t * layers, (t + 1) * layers)
        cx = (16 * t - 8 * T + rng.uniform(0, 16, layers)) * 0.02 * z
        cy = rng.uniform(-8, 8, layers) * 0.02 * z
        packed[rows, 0:3] = torch.tensor(np.stack([cx, cy, z], 1)
                                         .astype(np.float32))
        s = 1.0 / (rng.uniform(0.2, 0.5, layers) * z)
        packed[rows, 3] = torch.tensor(s.astype(np.float32))  # t_u = x / su
        packed[rows, 7] = torch.tensor(s.astype(np.float32))  # t_v = y / sv
        packed[rows, _C_N + 2] = -1.0
        packed[rows, 12] = torch.tensor(rng.uniform(0.7, 0.99, layers)
                                        .astype(np.float32))
        packed[rows, _C_COLOR:_C_COLOR + 3 + A] = torch.tensor(
            rng.random((layers, 3 + A)).astype(np.float32))
        idx[t, :layers] = np.arange(t * layers, (t + 1) * layers)
    bounds = torch.tensor([2 * CHUNK * t for t in range(T + 1)],
                          dtype=torch.int32)
    return (packed, torch.tensor(idx.reshape(-1)), rays, bounds, tiles_x, 1)


def _rotated(args, seed=0):
    """The scene turned by a fixed rotation, so that no gradient column is
    zero by the axes' alignment."""
    packed, gidx, rays, bounds, tx, ty = args
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    R = torch.tensor((q * np.sign(np.linalg.det(q))).astype(np.float32))
    packed = packed.clone()
    for c in (0, 3, 6, _C_N):
        packed[:, c:c + 3] = packed[:, c:c + 3] @ R.T
    rays = rays.clone()
    rays[:, 0:3] = torch.einsum("ij,tjp->tip", R, rays[:, 0:3])
    rays[:, 3:6] = torch.einsum("ij,tjp->tip", R, rays[:, 3:6])
    return packed, gidx, rays, bounds, tx, ty


def trace_blend_skip_model(packed, gauss_idx, rays, tile_bounds, tiles_x,
                           tiles_y, train=False, A=0, warp=(8, 4)):
    """Model of kernel K3's walk: the plain forward, but a warp (a `warp` =
    (width, height) patch of the tile's rays) evaluates a slot only while
    one of its rays has neither failed in this chunk nor saturated
    (T (1 - 1/255) < 1e-4), and a block walks a chunk only while one of its
    rays has not saturated. -> (planes, (slot, warp) combinations
    evaluated, of all)."""
    dev = packed.device
    T = tiles_x * tiles_y
    w_, h_ = warp
    start = tile_bounds[:-1].to(torch.int64)
    nchunk = (tile_bounds[1:].to(torch.int64) - start) // CHUNK
    ray = rays[:, :6].unbind(1)
    zeros = lambda: torch.zeros((T, NPIX), dtype=torch.float32, device=dev)
    rgb = [zeros() for _ in range(3)]
    nrm = [zeros() for _ in range(3)]
    aux = [zeros() for _ in range(A)]
    acc, dpt, dist, d1, d2 = (zeros() for _ in range(5))
    last = torch.full((T, NPIX), -1.0, device=dev)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    dead = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)

    def per_warp(x):  # any over each warp's rays, broadcast back to rays
        y = x.reshape(T, 16 // h_, h_, 16 // w_, w_)
        y = y.any(4, keepdim=True).any(2, keepdim=True)
        return y.expand(T, 16 // h_, h_, 16 // w_, w_).reshape(T, NPIX)

    evaluated = 0
    for c in range(int(nchunk.max())):
        block_on = (~dead).any(1) & (c < nchunk)
        rows_c = packed[_chunk_index(gauss_idx, start, nchunk, c,
                                     packed.shape[0] - 1)]
        fail = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
        for j in range(CHUNK):
            on = per_warp(~(fail | dead)) & block_on[:, None]
            evaluated += int(on.sum()) // 32
            col = rows_c[:, j, :, None].unbind(1)
            s = _ray_terms(col, ray)
            a, t = s["a"], s["t"]
            test = trans * (1.0 - a)
            passed = test >= T_CUTOFF
            contrib = s["amask"] & ~fail & passed & on
            fail = fail | (s["amask"] & ~passed & on)
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
            dead = ~(trans * np.float32(1.0 - np.float32(ALPHA_MIN))
                     >= T_CUTOFF)
    if train:
        planes = rgb + [dpt, acc] + nrm + [dist] + aux + [trans, d1, d2, last]
    else:
        planes = rgb + [acc, trans]
    return (_to_image(torch.stack(planes), tiles_x, tiles_y), evaluated,
            int(nchunk.sum()) * CHUNK * 8)


@pytest.mark.parametrize("train,A", [(False, 0), (True, 0), (True, 1),
                                     (True, 2)])
def test_warp_wide_skip_changes_no_plane(train, A):
    """The skipped slots could not have contributed: the planes of the walk
    with the skip are array-equal to the plain forward's, in render and in
    training mode, while a good part of the (slot, warp) combinations is
    skipped (rays saturate after a few of the 40 layers) and not all (half
    a tile's rays look away and stay open to every slot)."""
    args = _scene(A, seed=A)
    want = trace_blend_torch(*args, train, A)
    got, evaluated, total = trace_blend_skip_model(*args, train, A)
    assert torch.equal(got, want)
    assert 0.05 * total < evaluated < 0.8 * total
    acc = want[4 if train else 3]
    assert float(acc.max()) > 0.99 and float(acc.min()) == 0.0


def test_square_warps_skip_more_than_strips():
    args = _scene(0, seed=5)
    _, square, total = trace_blend_skip_model(*args, warp=(8, 4))
    _, strip, _ = trace_blend_skip_model(*args, warp=(16, 2))
    assert square <= strip < total


def test_probe_counts_agree_with_the_skip_model():
    """The probe's count of (slot, warp) combinations in which a ray can
    still take the slot is the skip model's count of evaluated ones."""
    args = _scene(0, seed=6)
    counts = blend_variants.forward_counts(args)
    for shape in blend_variants.WARP_SHAPES:
        _, evaluated, total = trace_blend_skip_model(*args, warp=shape)
        assert counts[f"slot_warps_live_{shape[0]}x{shape[1]}"] == evaluated
        assert counts["slot_warps_all"] == total
    fwd = trace_blend_torch(*args, True, 0)
    back = blend_variants.backward_counts(args, fwd)
    assert back["chunks_walked"] <= back["chunks"] == counts["chunks"]
    assert (back["slot_warps_contributing_8x4"]
            <= back["slot_warps_warp_last_8x4"]
            <= back["slot_warps_tile_last"])
    assert back["contributing_lanes"] >= counts["contributions"] > 0


@pytest.mark.parametrize("A", [0, 1, 2])
def test_slot_columns_cover_the_plain_backwards_columns(A):
    """The main slots and the extras hold every column the plain backward
    writes, each once."""
    main, extras = bwd_slot_columns(A)
    cols = main + extras
    assert len(cols) == len(set(cols)) == 16 + 1 + A
    assert len(extras) <= extras_width(A)
    args = _rotated(_scene(A, seed=7 + A))
    out = trace_blend_torch(*args, True, A)
    rng = np.random.default_rng(A)
    g_out = torch.tensor(rng.standard_normal(tuple(out.shape))
                         .astype(np.float32))
    grad, g_rays = trace_blend_bwd_torch(*args[:4], out, g_out, *args[4:], A)
    live = {k for k in range(LO) if bool(grad[:, k].any())}
    assert live == set(cols)
    assert bool(g_rays[:, :6].any()) and not bool(g_rays[:, 6:].any())


def _fconst(text, name):
    return float(re.search(rf"{name} = ([0-9.e+-]+)f[;,]", text).group(1))


def _random_surfels(seed, T=24, scale=(0.002, 2.0), ratio=30.0):
    """T tiles of one surfel each with random orientation, sizes over three
    decades, anisotropy up to `ratio`, opacity from under the floor to 1,
    and 256 rays each toward points spread over a few or over a hundred
    sigmas around the surfel, a part of them grazing its plane. -> (packed (T, LO), the six ray planes (T, NPIX))."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(T, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)  # (T, 3, 3)
    su = np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), T))
    sv = su * np.exp(rng.uniform(0, np.log(ratio), T))
    c = rng.normal(size=(T, 3)) * 10
    packed = np.zeros((T, LO), np.float32)
    packed[:, 0:3] = c
    packed[:, 3:6] = R[:, :, 0] / su[:, None]
    packed[:, 6:9] = R[:, :, 1] / sv[:, None]
    packed[:, 9:12] = R[:, :, 2]
    packed[:, 12] = rng.uniform(0.004, 1.0, T)
    packed[0, 12] = 0.003  # under the 1/255 floor
    o = c[:, None, :] + rng.normal(size=(T, NPIX, 3)) * rng.uniform(
        0.5, 30, (T, 1, 1))
    # in sigmas: half the rays aim at the footprint, half far around it
    uv = rng.normal(size=(T, NPIX, 2)) * np.where(
        rng.random((T, NPIX, 1)) < 0.5, 2.5, 100.0)
    target = (c[:, None, :] + uv[..., :1] * su[:, None, None] * R[:, None, :, 0]
              + uv[..., 1:] * sv[:, None, None] * R[:, None, :, 1])
    graze = rng.random((T, NPIX)) < 0.2  # origins almost in the plane
    height = ((o - c[:, None, :]) * R[:, None, :, 2]).sum(-1, keepdims=True)
    o = np.where(graze[..., None],
                 o - (1 - 1e-4) * height * R[:, None, :, 2], o)
    d = (target - o) * rng.uniform(0.2, 3.0, (T, NPIX, 1))
    ray = [torch.tensor(v.astype(np.float32))
           for v in (*np.moveaxis(o, -1, 0), *np.moveaxis(d, -1, 0))]
    return torch.tensor(packed), ray


@pytest.mark.parametrize("source", ["trace_blend_fwd.cu",
                                    "trace_blend_bwd.cu"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reach_test_refuses_no_ray_the_exact_test_admits(source, seed):
    """The bounding test ahead of the exact terms is safe: every (splat,
    ray) pair whose exact alpha, t and d.n tests pass lies within the
    splat's reach, over surfels of every size, anisotropy and opacity and
    rays from head-on to grazing; and it is worth having: it turns away
    a good part of the pairs that fail (the ball is as wide as the longer
    axis, so a ray close by the shorter one is let through)."""
    text = _text(CSRC / source)
    for name in ("RHO_MARGIN", "RHO_SLACK", "POS_SLACK"):  # the model's
        assert _fconst(text, name) == getattr(blend_variants, name)
    assert "- 1e-5f * half" in text
    packed, ray = _random_surfels(seed)
    amask = _ray_terms(packed[:, :, None].unbind(1), ray)["amask"]
    may = blend_variants.in_reach(packed[:, 0:3],
                                  blend_variants.reach2(packed), ray)
    assert int(amask.sum()) > 500
    assert not bool((amask & ~may).any())
    assert int((~amask & ~may).sum()) > 0.4 * int((~amask).sum())
    under = packed[:, 12] < 1.0 / 255.0  # opacity under the floor: no ray
    assert bool(under.any()) and not bool(may[under].any())


def test_reach_of_the_design_scene_and_of_padding_rows():
    text = _text(K3_SOURCE)
    assert text.count("RHO_MARGIN = 1.1f, RHO_SLACK = 0.01f;") == 1
    k4 = _text(K4_SOURCE)
    for name in ("RHO_MARGIN", "RHO_SLACK", "POS_SLACK"):
        assert _fconst(text, name) == _fconst(k4, name)
    packed, gidx, rays, bounds, tx, ty = _scene(0, seed=8)
    r2 = blend_variants.reach2(packed)
    assert float(r2[-1]) == -1.0  # the zero row of padding slots
    ray = rays[:, :6].unbind(1)
    start = bounds[:-1].to(torch.int64)
    nchunk = (bounds[1:].to(torch.int64) - start) // CHUNK
    for c in range(2):
        gi = _chunk_index(gidx, start, nchunk, c, packed.shape[0] - 1)
        for j in range(CHUNK):
            row = packed[gi[:, j]]
            amask = _ray_terms(row[:, :, None].unbind(1), ray)["amask"]
            may = blend_variants.in_reach(row[:, 0:3], r2[gi[:, j]], ray)
            assert not bool((amask & ~may).any())


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+)[;,]", text).group(1))


@pytest.mark.parametrize("A", [0, 1, 2])
def test_slot_columns_are_the_k4_sources(A):
    """MAIN, WET_COL, extra_column() and Extras<A>::N as parsed from the
    `.cu` give the map the tests and the card checks use."""
    text = _text(K4_SOURCE)
    assert _const(text, "LO") == LO and _const(text, "MAIN") == 16
    assert re.search(r"constexpr int WET_COL = LO - 1;", text)
    assert re.search(r"C_COLOR = 13, C_AUX = (\d+);", text).group(1) == str(
        _C_AUX)
    body = re.search(r"int extra_column\(int e\)\s*\{\s*return (.*?);", text,
                     re.S).group(1)
    assert " ".join(body.split()) == "e == 0 ? WET_COL : C_AUX + e - 1"
    extra_column = lambda e: WET_COL if e == 0 else _C_AUX + e - 1  # noqa: E731
    widths = re.search(
        r"N = A == 0 \? (\d+) : A == 1 \? (\d+) : (\d+);", text).groups()
    assert int(widths[A]) == extras_width(A)
    main, extras = bwd_slot_columns(A)
    assert main == list(range(_const(text, "MAIN")))
    assert extras == [extra_column(e) for e in range(1 + A)]
    # the lanes that add: main slots, then 1 + A extras
    assert "lane < MAIN + 1 + A" in text
    for a in range(3):
        assert f"trace_blend_bwd_kernel<{a}><<<" in text


def test_both_sources_walk_square_warps_and_k3_keeps_its_rule():
    for path in (K3_SOURCE, K4_SOURCE):
        text = _text(path)
        assert re.search(r"WARP_W = 8, WARP_H = 4;", text), path.name
        assert "cp.async.cg.shared.global" in text, path.name
    text = _text(K3_SOURCE)
    # the skip's saturation test is the block exit's, on the rule's constants
    assert text.count("T * (1.f - ALPHA_MIN) >= T_CUTOFF") == 1
    assert "__all_sync(FULL, fail || dead)" in text
    assert "__syncthreads_or(!dead)" in text
    assert "ALPHA_MIN = (float)(1.0 / 255.0)" in text
    assert "T_CUTOFF = (float)1e-4" in text and "T_MIN = (float)1e-4" in text
    assert abs(ALPHA_MIN - 1 / 255) < 1e-12 and T_CUTOFF == 1e-4
    # the configurations dispatched: render (A not read), then geometry,
    # training and training with the forward wet, each with A = 0, 1, 2
    assert "if (mode == 0) return F<CFG_RENDER, 0>::run(args...);" in text
    for cfg in ("CFG_GEO", "CFG_WET", "CFG_TRAIN"):
        assert f"with_aux<F, {cfg}>(A, args...)" in text
    for a in range(3):
        assert f"F<CFG, {a}>::run(args...)" in text


def test_k3_wet_tree_is_the_plain_versions_order():
    """K3 sums a slot's wet over a warp by a halving shuffle tree, the 8
    warps' sums one after another: a model of those steps, with the lane of
    each ray and the offsets parsed from trace_blend_fwd.cu, gives
    `_ray_sum`'s float32 result to the bit on values of many magnitudes."""
    text = _text(K3_SOURCE)
    assert re.search(r"for \(int o = 16; o > 0; o >>= 1\) v \+= "
                     r"__shfl_down_sync\(FULL, v, o\);", text)
    assert "sum += wpart[ch & 1][k][tid];" in text and "float sum = 0.f;" in text
    assert "(warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W" in text
    assert "(warp / (TILE / WARP_W)) * WARP_H + lane / WARP_W" in text
    from envgs_tpu_torch.ops.trace_blend import _lane_rays, _ray_sum

    lane = torch.arange(NPIX) % 32
    warp = torch.arange(NPIX) // 32
    ix = (warp % (16 // 8)) * 8 + lane % 8
    iy = (warp // (16 // 8)) * 4 + lane // 8
    assert torch.equal(_lane_rays("cpu"), iy * 16 + ix)
    rng = np.random.default_rng(4)
    x = torch.tensor((rng.random((50, NPIX)) * 10.0 ** rng.integers(
        -6, 3, (50, NPIX))).astype(np.float32))
    v = x[:, iy * 16 + ix].reshape(50, 8, 32).numpy()
    for o in (16, 8, 4, 2, 1):  # lane l adds lane l + o (shfl_down)
        v = v.copy()
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
    total = np.zeros(50, np.float32)
    for k in range(8):
        total = total + v[:, k, 0]
    np.testing.assert_array_equal(_ray_sum(x).numpy(), total)

"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and skip without one; on the card:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from envgs_tpu_torch import bench, kernels
from envgs_tpu_torch.models.envgs import EnvGSConfig
from envgs_tpu_torch.models.gaussians import create_pool
from envgs_tpu_torch.models.gaussiant import (
    GaussianTConfig,
    init_gaussiant_pool,
)
from envgs_tpu_torch.ops.fill_forward import fill_forward, fill_forward_torch
from envgs_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_win8,
    gather_rows_win8_torch,
)
from envgs_tpu_torch.ops.raster_blend import (
    WET_COL,
    blend_tiles,
    blend_tiles_bwd,
    blend_tiles_bwd_torch,
    blend_tiles_torch,
    gauss3d_slot_columns,
)
from envgs_tpu_torch.ops.segsum import (
    segmented_inclusive_sum,
    segmented_inclusive_sum_torch,
)
from envgs_tpu_torch.ops.trace_blend import (
    trace_blend,
    trace_blend_bwd,
    trace_blend_bwd_torch,
    trace_blend_torch,
)
from envgs_tpu_torch.utils.camera import make_camera

pytestmark = pytest.mark.cuda
# the kernels round every operation as the plain versions do (-fmad=false);
# what is left is expf / division ulps moving a pixel across the 1e-4
# transmittance test, bounded by T ~ 1e-4 times a channel value
ATOL = 1e-4
# backward kernels: per gradient column, max|d| / max|ref|. The kernels sum
# each pair's column over the tile's pixels with warp shuffles and add the
# pairs of a splat with atomics, in another order than the plain versions'
# torch sums (and from run to run); the terms are the same
GRAD_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(device, H=80, W=104):
    """A small scene (seeded numpy); W is not a multiple of 16."""
    rng = np.random.default_rng(7)
    P, Pe = 600, 800
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.7,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                       sh_degree=3, init_opacity=0.7, device=device)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                      sh_degree=3, init_opacity=0.7, device=device)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    cfg = EnvGSConfig(pair_cap=2 ** 15, env_pair_cap=2 ** 16,
                      reflection_start_iter=0, render_mode=True)
    return base, env, cam, cfg


def _inputs(device):
    """K1 and K3 arguments of a small render."""
    return bench.blend_inputs(*_scene(device))


def _cotangent(like, seed):
    g = torch.Generator(device=like.device).manual_seed(seed)
    return torch.randn(like.shape, generator=g, device=like.device)


def _close_columns(got, want, rtol=GRAD_RTOL):
    """Per column of a gradient table (or row of a ray gradient)."""
    for k in range(want.shape[1]):
        scale = float(want[:, k].abs().max())
        err = float((got[:, k] - want[:, k]).abs().max())
        assert err <= rtol * scale, (k, err, scale)


def test_raster_blend_kernel_matches_plain(cuda):
    args = _inputs(cuda)[0]
    n = kernels.LAUNCHES["raster_blend_fwd"]
    got = blend_tiles(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_blend_fwd"] == n + 1
    want = blend_tiles_torch(*args)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ATOL
    assert float(want[args[3] + 1].max()) > 0.9  # saturated pixels


def test_trace_blend_kernel_matches_plain(cuda):
    args = _inputs(cuda)[1]
    n = kernels.LAUNCHES["trace_blend_fwd"]
    got = trace_blend(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_blend_fwd"] == n + 1
    want = trace_blend_torch(*args)
    assert float((got - want).abs().max()) <= ATOL
    assert float(want[3].max()) > 0.5


def test_kernel_wrappers_reject_bad_inputs(cuda):
    packed = torch.zeros(5, 32, device=cuda)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    bounds = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.raster_blend_fwd(packed, idx.long(), bounds, 3, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        kernels.trace_blend_fwd(packed, idx, torch.zeros(2, 8, 256,
                                                         device=cuda),
                                bounds, 1, 1)
    out = kernels.raster_blend_fwd(packed, idx, bounds, 3, 1, 1)
    assert float(out[-1].min()) == 1.0  # empty tile: T stays 1


def test_fill_forward_kernel_matches_plain(cuda):
    """K5 integer-equal to its plain version: a length that is no multiple
    of the kernel's 2048-position blocks, random markers, a marker-free
    stretch longer than a block, and an empty marker set."""
    g = torch.Generator(device=cuda).manual_seed(0)
    N = 1024 * 37 + 5
    vals = torch.randint(-2 ** 30, 2 ** 30, (3, N), generator=g,
                         device=cuda, dtype=torch.int32)
    valid = torch.rand(N, generator=g, device=cuda) < 0.002
    valid[3000:9000] = False
    for v in (valid, torch.zeros_like(valid)):
        n = kernels.LAUNCHES["fill_forward"]
        got = fill_forward(vals, v)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fill_forward"] == n + 1
        assert torch.equal(got, fill_forward_torch(vals, v))
    assert not got.any()


def test_train_raster_kernels_match_plain(cuda):
    """K1 in training mode (aligned layout) and K2 on the same inputs and a
    random cotangent of every plane."""
    args = bench.train_blend_inputs(*_scene(cuda))["k1"]
    out = blend_tiles(*args, train=True)
    want = blend_tiles_torch(*args, train=True)
    assert float((out - want).abs().max()) <= ATOL
    g_out = _cotangent(out, 1)
    n = kernels.LAUNCHES["raster_blend_bwd"]
    got = blend_tiles_bwd(*args[:3], out, g_out, *args[3:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_blend_bwd"] == n + 1
    ref = blend_tiles_bwd_torch(*args[:3], out, g_out, *args[3:])
    C = args[3]
    cols = list(range(15 + C)) + [31]  # the gradient columns and the wet
    _close_columns(got[:, cols], ref[:, cols])
    assert float(ref[:, 31].max()) > 1.0  # wet: splats cover many pixels


def test_train_trace_kernels_match_plain(cuda):
    """K3 in training mode and K4 (table and ray gradients) on the same
    inputs and a random cotangent of every plane."""
    args = bench.train_blend_inputs(*_scene(cuda))["k3"]
    out = trace_blend(*args, train=True)
    want = trace_blend_torch(*args, train=True)
    assert float((out - want).abs().max()) <= ATOL
    g_out = _cotangent(out, 2)
    n = kernels.LAUNCHES["trace_blend_bwd"]
    got, got_rays = trace_blend_bwd(*args[:4], out, g_out, *args[4:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_blend_bwd"] == n + 1
    ref, ref_rays = trace_blend_bwd_torch(*args[:4], out, g_out, *args[4:])
    _close_columns(got[:, list(range(16)) + [31]],
                   ref[:, list(range(16)) + [31]])
    _close_columns(got_rays[:, :6].transpose(0, 1).reshape(6, -1).T,
                   ref_rays[:, :6].transpose(0, 1).reshape(6, -1).T)
    assert float(ref_rays.abs().max()) > 0


def _ragged_trace_inputs(device, A, opacity=(0.5, 0.99)):
    """K3 arguments of four ray tiles with ragged slot ranges: tile 0 has no
    slot at all, tile 1 one chunk (40 surfels and padding), tile 2 two
    chunks (100 surfels, the second chunk partly padding), tile 3 three
    chunks (150 surfels) with half its rays looking away (they take
    nothing: last = -1). Surfels in random orientation around the rays,
    nearly opaque by default, so that most rays saturate within a chunk
    and some within the second; A aux channels."""
    rng = np.random.default_rng(20 + A)
    counts = [0, 40, 100, 150]
    T, P = len(counts), sum(counts)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.linalg.det(q))
    packed = np.zeros((P + 1, 32), np.float32)
    rays = np.zeros((T, 8, 256), np.float32)
    ii, jj = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    idx, bounds, row = [], [0], 0
    for t, n in enumerate(counts):
        d = np.stack([(jj.reshape(-1) + 16 * t - 32) * 0.02,
                      (ii.reshape(-1) - 8) * 0.02, np.ones(256)], 0)
        if t == 3:
            d[:, jj.reshape(-1) >= 8] *= -1.0  # these rays look away
        rays[t, 3:6] = rot @ d
        rays[t, 0:3] = rot @ (rng.normal(size=(3, 256)) * 1e-3)
        z = np.sort(rng.uniform(1.0, 6.0, n))
        c = np.stack([(16 * t - 32 + rng.uniform(0, 16, n)) * 0.02 * z,
                      rng.uniform(-8, 8, n) * 0.02 * z, z], 1)
        tilt, _ = np.linalg.qr(np.eye(3) + 0.3 * rng.normal(size=(n, 3, 3)))
        frame = rot @ tilt  # (n, 3, 3): columns t_u, t_v, normal directions
        s = rng.uniform(0.1, 0.4, (n, 2)) * z[:, None]
        r = slice(row, row + n)
        packed[r, 0:3] = c @ rot.T
        packed[r, 3:6] = frame[:, :, 0] / s[:, :1]
        packed[r, 6:9] = frame[:, :, 1] / s[:, 1:]
        packed[r, 9:12] = frame[:, :, 2]
        packed[r, 12] = rng.uniform(*opacity, n)
        packed[r, 13:16 + A] = rng.random((n, 3 + A))
        slots = -(-n // 64) * 64
        idx += list(range(row, row + n)) + [P] * (slots - n)
        bounds.append(bounds[-1] + slots)
        row += n
    return (torch.tensor(packed, device=device),
            torch.tensor(np.asarray(idx, np.int32), device=device),
            torch.tensor(rays, device=device),
            torch.tensor(np.asarray(bounds, np.int32), device=device), T, 1)


@pytest.mark.parametrize("A", [0, 1, 2])
def test_trace_kernels_on_ragged_tiles(cuda, A):
    """K3 in render and in training mode and K4 with A = 0, 1, 2 aux
    channels where the tiles' slot ranges are ragged: an empty tile, one
    chunk, a last chunk that is partly padding, rays that take nothing.
    K3 against its plain version per plane, K4 per gradient column (the
    wet in column 31, aux in 16 and 17, nothing elsewhere) and per ray
    gradient row."""
    args = _ragged_trace_inputs(cuda, A)
    render = trace_blend(*args)
    assert float((render - trace_blend_torch(*args)).abs().max()) <= ATOL
    out = trace_blend(*args, train=True, A=A)
    want = trace_blend_torch(*args, train=True, A=A)
    assert out.shape == want.shape == (13 + A, 16, 64)
    assert float((out - want).abs().max()) <= ATOL
    last = want[12 + A]
    assert float(last[:, :16].max()) == -1.0  # the empty tile
    assert float(last[:, 56:].max()) == -1.0  # the rays that look away
    assert float(last[:, 32:48].max()) >= 64  # into the padded chunk
    assert float(want[4].max()) > 0.99  # saturated rays
    # the backward on fainter surfels: no ray fails a chunk's transmittance
    # test and takes slots again in the next, so the rebuilt T stays finite
    args = _ragged_trace_inputs(cuda, A, opacity=(0.02, 0.12))
    out = trace_blend(*args, train=True, A=A)
    assert float(out[9 + A].min()) > 1e-4 and float(out[12 + A].max()) >= 128
    g_out = _cotangent(out, 5 + A)
    got, got_rays = trace_blend_bwd(*args[:4], out, g_out, *args[4:], A=A)
    torch.cuda.synchronize()
    ref, ref_rays = trace_blend_bwd_torch(*args[:4], out, g_out, *args[4:],
                                          A=A)
    cols = list(range(16 + A)) + [WET_COL]
    _close_columns(got[:, cols], ref[:, cols])
    others = [k for k in range(32) if k not in cols]
    assert not got[:, others].any() and not got[-1].any()
    assert all(float(ref[:, k].abs().max()) > 0 for k in cols)
    _close_columns(got_rays[:, :6].transpose(0, 1).reshape(6, -1).T,
                   ref_rays[:, :6].transpose(0, 1).reshape(6, -1).T)
    assert not got_rays[:, 6:].any() and not got_rays[0].any()


def test_trace_kernel_resources(cuda):
    """What K3 and K4 were compiled to: they fit an SM several times over
    and the reductions' rows stay in registers (a row in local memory
    shows as hundreds of bytes of stack)."""
    for train, A in ((False, 0), (True, 0), (True, 2)):
        res = kernels.trace_blend_fwd_resources(train, A)
        assert res["blocks_per_sm"] >= 3 and res["local_bytes"] <= 64, res
    for A in (0, 1, 2):
        res = kernels.trace_blend_bwd_resources(A)
        assert res["blocks_per_sm"] >= 16 and res["local_bytes"] <= 256, res
    with pytest.raises(ValueError, match="aux"):
        kernels.trace_blend_bwd_resources(3)


def _gaussiant_inputs(device):
    """K1 arguments (gauss3d, aligned layout) of a small 3DGS render: 600
    Gaussians with anisotropic scales, 80x104 pixels."""
    rng = np.random.default_rng(8)
    P, H, W = 600, 80, 104
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.7,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    cfg = GaussianTConfig(pair_cap=2 ** 15)
    pool = init_gaussiant_pool(xyz, rng.random((P, 3)).astype(np.float32), P,
                               cfg, init_opacity=0.7, device=device)
    pool = pool._replace(params=pool.params._replace(scaling=torch.tensor(
        np.log(rng.uniform(0.01, 0.08, (P, 3))).astype(np.float32),
        device=device)))
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    return bench.gaussiant_blend_inputs(pool, cam, cfg)[0]


def test_gauss3d_raster_kernels_match_plain(cuda):
    """K1 in gauss3d mode with the per-pair forward wet, and K2 in gauss3d
    mode on a random cotangent of every plane: counted under their own
    LAUNCHES keys, the surfel keys untouched; K2's tmat columns 4-8 and
    normal columns 12-14 exactly zero."""
    args = _gaussiant_inputs(cuda)
    before = dict(kernels.LAUNCHES)
    out, wet = blend_tiles(*args, train=True, mode="gauss3d", wet=True)
    want, want_wet = blend_tiles_torch(*args, train=True, mode="gauss3d",
                                       wet=True)
    assert float((out - want).abs().max()) <= ATOL
    assert float((wet - want_wet).abs().max()) <= ATOL
    assert float(want_wet.max()) > 1.0 and float(want[args[3] + 1].max()) > 0.9
    g_out = _cotangent(out, 3)
    got = blend_tiles_bwd(*args[:3], out, g_out, *args[3:], mode="gauss3d")
    torch.cuda.synchronize()
    rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert rose == {**{k: 0 for k in before}, "raster_blend_fwd_gauss3d": 1,
                    "raster_blend_bwd_gauss3d": 1}
    ref = blend_tiles_bwd_torch(*args[:3], out, g_out, *args[3:],
                                mode="gauss3d")
    C = args[3]
    cols = [0, 1, 2, 3, 9, 10, 11] + list(range(15, 15 + C)) + [31]
    _close_columns(got[:, cols], ref[:, cols])
    unused = [4, 5, 6, 7, 8, 12, 13, 14]
    assert not got[:, unused].any() and not ref[:, unused].any()


def test_segscan_kernel_matches_plain(cuda):
    """K6 against its plain version (a float64 running sum; the kernel sums
    each 1024-row block sequentially in float32 and adds a carry): random
    starts, a segment of some 6000 rows that runs through five blocks
    without a start, no start at row 0, and a NaN row that must poison its
    own segment and nothing after the next start. Bound: rtol 1e-5 plus the
    rounding of a sequential float32 sum of n terms taken as a random walk,
    4 * sqrt(n) * 2^-24 * the largest |sum| (about 5e-3 here; a wrong
    carry or a missed start errs by whole sums)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    N = 1024 * 40
    rows = torch.randn((N, 128), generator=g, device=cuda)
    seg = (torch.rand(N, generator=g, device=cuda) < 0.01).to(torch.int32)
    seg[3000:9000] = 0
    seg[0] = 0
    n = kernels.LAUNCHES["segscan"]
    got = segmented_inclusive_sum(rows, seg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segscan"] == n + 1
    want = segmented_inclusive_sum_torch(rows, seg)
    starts = torch.nonzero(seg)[:, 0]
    longest = int((starts[1:] - starts[:-1]).max())
    assert longest >= 6000
    atol = 4 * longest ** 0.5 * 2.0 ** -24 * float(want.abs().max())
    assert torch.allclose(got, want, rtol=1e-5, atol=atol), atol
    assert float(want[8999].abs().max()) > 50  # the long segment summed up
    rows[3500] = float("nan")
    bad = segmented_inclusive_sum(rows, seg)
    nxt = int(torch.nonzero(seg[3500:])[0]) + 3500
    assert torch.isnan(bad[3500:nxt]).all()
    assert torch.equal(bad[nxt:], got[nxt:])
    assert torch.equal(bad[:3500], got[:3500])
    with pytest.raises(ValueError, match="multiple"):
        kernels.segscan(rows[:1000].contiguous(), seg[:1000].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernels_match_plain(cuda, dtype):
    """P1 and P2 bit-equal to table[idx] (and P2's window form), a row
    count that fills no whole block, repeated indices, both table ends."""
    g = torch.Generator(device=cuda).manual_seed(1)
    S, n = 4096, 1024 * 9 + 7
    table = torch.randn((S, 128), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, S, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([0, S - 1], dtype=torch.int32, device=cuda)
    want = table[idx.long()]
    assert torch.equal(gather_rows_win8_torch(table, idx), want)
    for name, fn in (("gather_rows", gather_rows),
                     ("gather_rows_win8", gather_rows_win8)):
        before = kernels.LAUNCHES[name]
        got = fn(table, idx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert got.dtype == dtype and torch.equal(got, want), name
    with pytest.raises(ValueError, match="int32"):
        kernels.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.gather_rows_win8(table[:4091].contiguous(), idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 17, 31, 33, 255, 256, 257,
                               511, 513, 1024 * 3 + 5])
def test_gather_kernels_ragged_and_out_of_range(cuda, dtype, n):
    """P1 and P2 at row counts around P2's stage (8 rows), ring (32), run
    (256) and block (512), with a repeated, the first, the last and two
    out-of-range indices: bit-equal to table[idx] with idx clamped."""
    g = torch.Generator(device=cuda).manual_seed(n)
    S = 1024
    table = torch.randn((S, 128), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, S, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0] = -3
    idx[-1] = S + 11
    if n > 4:
        idx[1], idx[2], idx[3] = 0, S - 1, idx[4]
    want = table[idx.long().clamp(0, S - 1)]
    for fn in (gather_rows, gather_rows_win8):
        got = fn(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__


def _lopsided_inputs(device, mode):
    """K1 arguments (aligned layout) of a 96x128 view whose splats all sit
    in the left half, 3000 faint ones of them piled onto one spot: one tile
    holds many times the chunks of the others, and the right half's tiles
    are empty."""
    rng = np.random.default_rng(11)
    H, W = 96, 128
    n_pile, n_rest = 3000, 300
    pile = np.concatenate([rng.normal(size=(n_pile, 2)) * 0.004
                           + np.array([-0.55, 0.1]),
                           rng.random((n_pile, 1)) * 0.5 + 3.0], -1)
    rest = np.concatenate([-rng.random((n_rest, 1)) * 1.2 - 0.1,
                           rng.normal(size=(n_rest, 1)) * 0.5,
                           rng.random((n_rest, 1)) * 2 + 2.0], -1)
    xyz = np.concatenate([pile, rest]).astype(np.float32)
    P = xyz.shape[0]
    rgb = rng.random((P, 3)).astype(np.float32)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    if mode == "gauss3d":
        cfg = GaussianTConfig(pair_cap=2 ** 16)
        pool = init_gaussiant_pool(xyz, rgb, P, cfg, init_opacity=0.02,
                                   device=device)
        return bench.gaussiant_blend_inputs(pool, cam, cfg)[0]
    base = create_pool(xyz, rgb, cap=P, sh_degree=3, init_opacity=0.02,
                       device=device)
    env = _scene(device)[1]
    cfg = EnvGSConfig(pair_cap=2 ** 16, env_pair_cap=2 ** 16,
                      reflection_start_iter=0, render_mode=True)
    return bench.train_blend_inputs(base, env, cam, cfg)["k1"]


@pytest.mark.parametrize("mode", ["surfel", "gauss3d"])
def test_raster_bwd_kernel_on_lopsided_tiles(cuda, mode):
    """K2 where the tiles' chunk counts differ widely: one tile walks many
    more 64-pair chunks than the rest, some tiles are empty. Against the
    plain version, per gradient column."""
    args = _lopsided_inputs(cuda, mode)
    packed, gauss_idx, bounds, C, tiles_x, tiles_y = args
    out = blend_tiles(*args, train=True, mode=mode)
    last = out[-1].reshape(tiles_y, 16, tiles_x, 16).amax((1, 3)).reshape(-1)
    chunks = torch.minimum((bounds[1:] - bounds[:-1]) // 64,
                           ((last + 64) // 64).clamp(min=0).to(torch.int32))
    assert int((chunks == 0).sum()) >= tiles_x * tiles_y // 6
    busy = chunks[chunks > 0].float()
    assert float(busy.max()) >= 4 * float(busy.median())
    assert float(busy.max()) >= 8  # the double-buffered walk wraps often
    g_out = _cotangent(out, 4)
    got = blend_tiles_bwd(*args[:3], out, g_out, *args[3:], mode=mode)
    torch.cuda.synchronize()
    ref = blend_tiles_bwd_torch(*args[:3], out, g_out, *args[3:], mode=mode)
    cols = (gauss3d_slot_columns(C) + [WET_COL]
            if mode == "gauss3d" else list(range(15 + C)) + [WET_COL])
    _close_columns(got[:, cols], ref[:, cols])
    others = [k for k in range(32) if k not in cols]
    assert not got[:, others].any()
    assert float(ref[:, 31].max()) > 0


def _ragged_k1_inputs(device, config):
    """K1 arguments for 8 tiles (a 32x64 view) of hand-picked pair lists:
    tile 0 empty, tile 1 one pair, tile 2 two opaque splats over the whole
    tile (every pixel saturates in the first window) and 300 more, tile 3
    2000 faint pairs (32 windows), tiles 4-7 100-300 random
    pairs. Render configurations get the unaligned layout (tile starts off
    the 8-pair grid), the others the aligned one (64-pair padding)."""
    from envgs_tpu_torch.ops.common import prepare_splats
    from envgs_tpu_torch.ops.raster import _pack_table
    from envgs_tpu_torch.ops.raster3d import _pack_table3d, prepare_gaussians3d

    rng = np.random.default_rng(21)
    H, W, P = 32, 64, 3000
    f = 40.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    z = rng.uniform(1.5, 5.0, P)
    xyz = np.stack([rng.uniform(-0.8, 0.8, P) * z,
                    rng.uniform(-0.4, 0.4, P) * z, z], 1)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.2), (P, 3)))
    opac = rng.uniform(0.02, 0.9, P)
    # splats 0 and 1: so large and facing the camera that alpha is their
    # opacity at every pixel of tile 2 (x 32..47, y 0..15): 0.99 leaves T at
    # 1 - 0.99, then 0.98999 at 1.001e-4, under 1e-4 / (1 - 1/255): every
    # pixel saturates in the first window
    xyz[:2] = [[0.2, -0.2, 1.0], [0.21, -0.21, 1.05]]
    q[:2] = [1.0, 0.0, 0.0, 0.0]
    scales[:2] = 1e5
    opac[:2] = [0.99, 0.98999]
    opac[1000:3000] = 0.02  # the faint ones of tile 3
    t = lambda x: torch.tensor(np.asarray(x, np.float32),  # noqa: E731
                               device=device)
    colors = t(rng.random((P, 3)))
    if config == "gauss3d":
        prep = prepare_gaussians3d(t(xyz), t(q), t(scales), t(opac), colors,
                                   cam)
        packed = _pack_table3d(prep)
    else:
        prep = prepare_splats(t(xyz), t(q), t(scales[:, :2]), t(opac),
                              colors, cam)
        packed = _pack_table(prep)
    lists = [[], [5], list(range(2)) + list(range(10, 310)),
             list(range(1000, 3000))]
    lists += [rng.choice(np.arange(310, 1000), rng.integers(100, 300),
                         replace=False).tolist() for _ in range(4)]
    aligned = config in ("train", "gauss3d")
    idx, bounds = [], [0]
    for pairs in lists:
        pad = (-len(pairs)) % 64 if aligned else 0
        idx += pairs + [P] * pad
        bounds.append(len(idx))
    idx += [P] * 64  # the sentinel window past the last tile
    return (packed, torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(bounds, dtype=torch.int32, device=device), 3, 4, 2)


# render, render with the median depth, train, gauss3d with the wet
K1_CONFIGS = {"render": (False, "surfel", False),
              "median": (True, "surfel", False),
              "train": (True, "surfel", False),
              "gauss3d": (True, "gauss3d", True)}


@pytest.mark.parametrize("config", sorted(K1_CONFIGS))
def test_raster_fwd_kernel_on_ragged_tiles(cuda, config):
    """K1 in each configuration where tiles are empty, hold one pair,
    saturate in their first window (the block stops early) or walk 32
    windows: every plane (and the wet) against the plain version."""
    train, mode, wet = K1_CONFIGS[config]
    args = _ragged_k1_inputs(cuda, config)
    bounds = args[2].to(torch.int64)
    assert int(bounds[1] - bounds[0]) == 0
    assert (int(bounds[4] - bounds[3]) + 63) // 64 >= 30
    got = kernels.raster_blend_fwd(*args, 0, train, mode, wet)
    torch.cuda.synchronize()
    want = blend_tiles_torch(*args, 0, train, mode, wet)
    if wet:
        (got, got_wet), (want, want_wet) = got, want
        assert float((got_wet - want_wet).abs().max()) <= ATOL
        assert float(want_wet.max()) > 1.0
    assert float((got - want).abs().max()) <= ATOL
    C = args[3]
    trans = want[C + 7 if train else C + 5]
    # tile 2 (columns 32-47 of the top row of tiles) saturates everywhere
    assert float(trans[:16, 32:48].max()) * (1 - 1 / 255) < 1e-4
    assert float(trans[:16, :16].min()) == 1.0  # tile 0: nothing


@pytest.mark.parametrize("n", [1, 5, 2047, 2048, 2049, 2048 * 40 + 3])
@pytest.mark.parametrize("kind", ["ends", "empty blocks", "last only",
                                  "offset view"])
def test_fill_forward_kernel_on_ragged_inputs(cuda, n, kind):
    """K5 bit-equal to its plain version with markers at the first and the
    last position, runs of empty blocks (more than the 32 the look-back
    reads at once), a single marker at the end, and inputs that are views
    at an odd offset (no 16-byte loads)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    vals = torch.randint(-2 ** 30, 2 ** 30, (3, n + 1), generator=g,
                         device=cuda, dtype=torch.int32)
    valid = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    if kind == "ends":
        valid[0] = valid[n - 1] = 1
    elif kind == "empty blocks":
        valid[:min(n, 100):7] = 1
        valid[max(0, n - 30):n:11] = 1
    elif kind == "last only":
        valid[n - 1] = 1
    else:
        valid[1:n + 1] = (torch.rand(n, generator=g, device=cuda)
                          < 0.01).to(torch.int32)
    if kind == "offset view":
        vals, valid = vals[:, 1:].contiguous()[:, :n], valid[1:]
    else:
        vals, valid = vals[:, :n].contiguous(), valid[:n]
    got = kernels.fill_forward(vals, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, fill_forward_torch(vals, valid))


def test_fill_forward_kernel_on_the_aligned_layouts_markers(cuda):
    """The markers aligned_markers leaves: empty tiles sharing an aligned
    start, and the long empty tail up to cap_aligned."""
    from envgs_tpu_torch.ops.binning import aligned_markers

    rng = np.random.default_rng(3)
    counts = rng.integers(0, 300, 2000)
    counts[100:700] = 0
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(counts)])
                          .astype(np.int32), device=cuda)
    marks, valid, _ = aligned_markers(bounds, int(bounds[-1]) + 5000, 2000,
                                      64)
    assert int(valid[-20000:].sum()) == 0
    got = kernels.fill_forward(marks, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, fill_forward_torch(marks, valid))

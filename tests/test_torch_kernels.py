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
    blend_tiles,
    blend_tiles_bwd,
    blend_tiles_bwd_torch,
    blend_tiles_torch,
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
    of the kernel's 1024-position blocks, random markers, a marker-free
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

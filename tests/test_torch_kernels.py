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
    out_rows,
    rows,
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
# K1's configuration in a train step (the wet through the hook)
TRAIN_NEEDS = (True, True, False)
TRAIN_KEY = "raster_blend_fwd_aligned_dist_med"


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


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["unaligned", "aligned"])
def test_raster_fwd_switches_strip_only_work(cuda, aligned):
    """K1 in each compiled configuration of a layout on the small scene:
    within ATOL of its plain version, every plane it writes equal to the
    layout's all-on configuration's to the bit, the planes a switch strips
    zero (`last` -1), the wet equal where it is written."""
    ins = bench.train_blend_inputs(*_scene(cuda)) if aligned else None
    args = ins["k1"] if aligned else _inputs(cuda)[0]
    C = args[3]
    full_needs = (True, True, aligned)
    full = blend_tiles(*args, needs=full_needs, aligned=aligned)
    full, full_wet = full if aligned else (full, None)
    r = rows(C)
    for *needs, a in kernels.K1_CONFIGS:
        if a != aligned:
            continue
        got = blend_tiles(*args, needs=needs, aligned=aligned)
        want = blend_tiles_torch(*args, needs=needs, aligned=aligned)
        if needs[2]:
            (got, wet), (want, want_wet) = got, want
            assert torch.equal(wet, full_wet)
            assert float((wet - want_wet).abs().max()) <= ATOL
        assert float((got - want).abs().max()) <= ATOL, needs
        if not (needs[0] or needs[1]):  # the (C + 6)-plane layout
            same = list(range(C + 5))
            assert torch.equal(got[same], full[same]), needs
            assert torch.equal(got[out_rows(C)["trans"]],
                               full[r["trans"]]), needs
            continue
        kept = [k for k in range(C + 11)
                if (k not in (r["dist"], r["d1"], r["d2"], r["last"])
                    or needs[0]) and (k != r["med"] or needs[1])]
        assert torch.equal(got[kept], full[kept]), needs
        if not needs[0]:
            assert not got[[r["dist"], r["d1"], r["d2"]]].any()
            assert bool((got[r["last"]] == -1).all())
        if not needs[1]:
            assert not got[r["med"]].any()
    assert float(full[r["dist"]].max()) > 0 and float(full[r["med"]].max()) > 0


def test_raster_bwd_after_a_forward_without_the_median(cuda):
    """K2 reads D1, D2 and `last`, not the median: on the planes of the
    forward without it (need_med off, what the differentiable blend runs
    for a caller that strips it) it gives the all-on forward's gradients,
    against its plain version per column."""
    args = bench.train_blend_inputs(*_scene(cuda))["k1"]
    out = blend_tiles(*args, needs=(True, False, False), aligned=True)
    full = blend_tiles(*args, needs=TRAIN_NEEDS, aligned=True)
    C = args[3]
    assert not out[rows(C)["med"]].any() and full[rows(C)["med"]].any()
    g_out = _cotangent(out, 5)
    got = blend_tiles_bwd(*args[:3], out, g_out, *args[3:])
    torch.cuda.synchronize()
    cols = list(range(15 + C)) + [WET_COL]
    _close_columns(got[:, cols],
                   blend_tiles_bwd_torch(*args[:3], out, g_out,
                                         *args[3:])[:, cols])
    _close_columns(got[:, cols],
                   blend_tiles_bwd(*args[:3], full, g_out, *args[3:])[:, cols])


def test_median_render_launches_the_med_configuration(cuda):
    """forward_envgs in render mode with depth_ratio > 0 launches K1's
    median-only configuration once and the training one never; its maps
    are the CPU's."""
    from envgs_tpu_torch.models.envgs import forward_envgs

    outs = {}
    for dev in (cuda, torch.device("cpu")):
        base, env, cam, cfg = _scene(dev)
        before = dict(kernels.LAUNCHES)
        outs[dev.type] = forward_envgs(base, env, cam, 10,
                                       cfg._replace(depth_ratio=1.0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _rose(before) == {"raster_blend_fwd_med": 1,
                                     "trace_blend_fwd": 1, "env_cull": 1}
    for k in ("rgb_map", "dpt_map", "surf_norm_map"):
        err = float((getattr(outs["cuda"], k).cpu()
                     - getattr(outs["cpu"], k)).abs().max())
        assert err <= 1e-4, (k, err)


def test_train_raster_kernels_match_plain(cuda):
    """K1 in training mode (aligned layout) and K2 on the same inputs and a
    random cotangent of every plane."""
    args = bench.train_blend_inputs(*_scene(cuda))["k1"]
    out = blend_tiles(*args, needs=TRAIN_NEEDS, aligned=True)
    want = blend_tiles_torch(*args, needs=TRAIN_NEEDS, aligned=True)
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


@pytest.mark.parametrize("A", [0, 1, 2])
def test_trace_geo_and_wet_kernels_on_ragged_tiles(cuda, A):
    """K3's geometry configuration and its training configuration with the
    forward wet on the ragged tiles (an empty tile, a padded chunk, rays
    that take nothing), nearly opaque surfels so that rays saturate and
    blocks stop early: every plane within ATOL of the plain version, the
    per-slot wet too (summed in the same tree: equal here), zeros for the
    padding slots, and each launch counted under its own key."""
    args = _ragged_trace_inputs(cuda, A)
    keys = ("trace_blend_fwd", "trace_blend_fwd_geo", "trace_blend_fwd_wet")
    n = {k: kernels.LAUNCHES[k] for k in keys}
    geo = trace_blend(*args, A=A, geo=True)
    out, wet = trace_blend(*args, train=True, A=A, wet=True)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - n[k] for k in keys} == {
        "trace_blend_fwd": 0, "trace_blend_fwd_geo": 1,
        "trace_blend_fwd_wet": 1}
    want_geo = trace_blend_torch(*args, A=A, geo=True)
    want, want_wet = trace_blend_torch(*args, train=True, A=A, wet=True)
    assert geo.shape == want_geo.shape == (10 + A, 16, 64)
    assert float((geo - want_geo).abs().max()) <= ATOL
    assert not want_geo[8].any()  # no distortion in the geometry planes
    train = trace_blend(*args, train=True, A=A)
    same = [k for k in range(10 + A) if k != 8]  # all but the distortion
    assert float((geo[same] - train[same]).abs().max()) <= ATOL
    assert float((out - want).abs().max()) <= ATOL
    assert float((wet - want_wet).abs().max()) <= ATOL
    padding = args[1].cpu() == args[0].shape[0] - 1
    assert not wet.cpu()[padding].any()
    assert float(want_wet.max()) > 1.0  # slots many rays take


@pytest.mark.parametrize("extra", [dict(use_base_tracing=True),
                                   dict(max_trace_depth=1)])
def test_traced_base_and_bounces_match_cpu(cuda, extra):
    """forward_envgs in render mode with the base pass traced along the
    camera rays (K3 geometry, then K3 render on the reflected rays) or with
    a second bounce (K1, then K3 with the forward wet twice): the kernels
    against the plain versions on the CPU from the same pools, the maps
    and the per-splat wet within ATOL, and only those launches."""
    from envgs_tpu_torch.models.envgs import forward_envgs

    launched = {"use_base_tracing": {"trace_blend_fwd_geo": 1,
                                     "trace_blend_fwd": 1, "env_cull": 2},
                "max_trace_depth": {"raster_blend_fwd": 1,
                                    "trace_blend_fwd_wet": 2,
                                    "env_cull": 2}}[next(iter(extra))]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        base, env, cam, cfg = _scene(dev)
        before = dict(kernels.LAUNCHES)
        outs[dev.type] = forward_envgs(base, env, cam, 10,
                                       cfg._replace(**extra))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            rose = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
            assert rose == launched, rose
    got, want = outs["cuda"], outs["cpu"]
    for k in ("rgb_map", "acc_map", "dpt_map", "norm_map", "env_rgb_map",
              "env_acc_map", "base_wet", "env_wet"):
        err = float((getattr(got, k).cpu() - getattr(want, k)).abs().max())
        assert err <= ATOL * max(1.0, float(getattr(want, k).abs().max())), k
    assert float(want.acc_map.max()) > 0.9
    assert float(want.env_acc_map.max()) > 0.5


def test_trace_kernel_resources(cuda):
    """What K3 and K4 were compiled to: they fit an SM several times over
    and the reductions' rows stay in registers (a row in local memory
    shows as hundreds of bytes of stack)."""
    for train, A, geo, wet in ((False, 0, False, False),
                               (True, 0, False, False),
                               (True, 2, False, False),
                               (False, 2, True, False),
                               (True, 0, False, True),
                               (True, 2, False, True)):
        res = kernels.trace_blend_fwd_resources(train, A, geo, wet)
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
    out, wet = blend_tiles(*args, needs=(True, True, True), mode="gauss3d",
                           aligned=True)
    want, want_wet = blend_tiles_torch(*args, needs=(True, True, True),
                                       mode="gauss3d", aligned=True)
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


@pytest.mark.parametrize("kind", ["row 0", "tile boundaries",
                                  "group boundaries", "chains", "every row"])
def test_segscan_kernel_on_ragged_starts(cuda, kind):
    """K6 on the starts its design tests model (tests/
    test_torch_segscan_design.py): a start at row 0, starts on the 128-row
    tiles' and the 16-row groups' boundaries, tiles with no start chained
    over many tiles (the look-back's carry), every row a start; the same
    bits on every call; within rtol 1e-5 / atol 1e-4 of the plain
    version."""
    N, T, R = 1024 * 48, kernels.SEG_TILE, 16
    rng = np.random.default_rng(7)
    seg = np.zeros(N, np.int32)
    if kind == "row 0":
        seg[0] = 1
        seg[rng.choice(N, N // 50, replace=False)] = 1
    elif kind == "tile boundaries":
        seg[::T] = 1
        seg[T * 7::T * 3] = 0
        seg[0] = 0
    elif kind == "group boundaries":
        seg[R::R * 3] = 1
        seg[T - 1::T * 5] = 1
    elif kind == "chains":
        seg[rng.choice(N, N // 40, replace=False)] = 1
        seg[3 * T + 5:42 * T + 2] = 0  # some 5000 rows, as phase 12's
        seg[-40 * T:] = 0
        seg[0] = 0
    else:
        seg[:] = 1
    rows = torch.tensor(rng.standard_normal((N, 128)).astype(np.float32),
                        device=cuda)
    seg = torch.tensor(seg, device=cuda)
    got = kernels.segscan(rows, seg)
    again = kernels.segscan(rows, seg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = segmented_inclusive_sum_torch(rows, seg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4), float(
        (got - want).abs().max())
    if kind == "every row":
        assert torch.equal(got, rows)


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
    out = blend_tiles(*args, needs=(True, True, mode == "gauss3d"),
                      mode=mode, aligned=True)
    if mode == "gauss3d":  # compiled with the wet alone
        out = out[0]
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


def _ragged_k1_inputs(device, mode, aligned):
    """K1 arguments for 8 tiles (a 32x64 view) of hand-picked pair lists:
    tile 0 empty, tile 1 one pair, tile 2 two opaque splats over the whole
    tile (every pixel saturates in the first window) and 300 more, tile 3
    2000 faint pairs (32 windows), tiles 4-7 100-300 random
    pairs; the unaligned layout (tile starts off the 8-pair grid) or the
    aligned one (64-pair padding)."""
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
    if mode == "gauss3d":
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
    idx, bounds = [], [0]
    for pairs in lists:
        pad = (-len(pairs)) % 64 if aligned else 0
        idx += pairs + [P] * pad
        bounds.append(len(idx))
    idx += [P] * 64  # the sentinel window past the last tile
    return (packed, torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(bounds, dtype=torch.int32, device=device), 3, 4, 2)


# K1's compiled configurations: (needs, mode, aligned)
K1_CONFIGS = {kernels.raster_blend_fwd_key(c[:3], c[3]): (c[:3], "surfel",
                                                          c[3])
              for c in kernels.K1_CONFIGS}
K1_CONFIGS["raster_blend_fwd_gauss3d"] = ((True, True, True), "gauss3d",
                                          True)


@pytest.mark.parametrize("config", sorted(K1_CONFIGS))
def test_raster_fwd_kernel_on_ragged_tiles(cuda, config):
    """K1 in each configuration where tiles are empty, hold one pair,
    saturate in their first window (the block stops early) or walk 32
    windows: every plane (and the wet) against the plain version, the
    launch counted under the configuration's key."""
    needs, mode, aligned = K1_CONFIGS[config]
    args = _ragged_k1_inputs(cuda, mode, aligned)
    bounds = args[2].to(torch.int64)
    assert int(bounds[1] - bounds[0]) == 0
    assert (int(bounds[4] - bounds[3]) + 63) // 64 >= 30
    before = dict(kernels.LAUNCHES)
    got = kernels.raster_blend_fwd(*args, 0, needs, mode, aligned)
    torch.cuda.synchronize()
    assert _rose(before) == {config: 1}
    want = blend_tiles_torch(*args, 0, needs, mode, aligned)
    if needs[2]:
        (got, got_wet), (want, want_wet) = got, want
        assert float((got_wet - want_wet).abs().max()) <= ATOL
        assert float(want_wet.max()) > 1.0
    assert float((got - want).abs().max()) <= ATOL
    C = args[3]
    trans = want[C + 7 if needs[0] or needs[1] else C + 5]
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


# ---------------------------------------------------------------------------
# the other gauss3d families on the card: Spacetime Gaussians (STGS) and
# PointPlanes launch K5, gauss3d K1 and K2 once a step and match the CPU's
# plain versions (their parity with the JAX package: tests/test_torch_stgs.py,
# test_torch_point_planes.py, test_torch_families.py)
# ---------------------------------------------------------------------------

# a step on the card against the CPU: the loss's sums and each gradient
# array's, per array max|d| / max|ref|
FAMILY_LOSS_RTOL = 1e-4
FAMILY_GRAD_RTOL = 5e-4
FAMILY_STEP = {"fill_forward": 1, "raster_blend_fwd_gauss3d": 1,
               "raster_blend_bwd_gauss3d": 1, "project3d_fwd": 1,
               "project3d_bwd": 1}


def _rose(before):
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _stgs_state(device, sh_degree_t):
    """60 Gaussians in 128 slots with numpy-made temporal fields, SH degree
    1 active, on `device`."""
    from envgs_tpu_torch.models import stgs as S

    rng = np.random.default_rng(5)
    P, cap = 60, 128
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.35,
                          rng.normal(size=(P, 1)) * 0.2 + 3.0],
                         -1).astype(np.float32)
    cfg = S.STGSConfig(sh_degree=1, sh_degree_t=sh_degree_t,
                       pair_cap=2 ** 12)
    pool = S.init_stgs_pool(xyz, rng.random(P).astype(np.float32),
                            rng.random((P, 3)).astype(np.float32), cap, cfg,
                            device=device)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    act = np.arange(cap)[:, None] < P
    pool = pool._replace(params=pool.params._replace(
        scaling=t(np.log(rng.uniform(0.02, 0.08, (cap, 3)))),
        features_rest=t(rng.normal(size=pool.params.features_rest.shape)
                        * 0.2),
        scaling_t=t(np.log(rng.uniform(0.2, 0.6, (cap, 1)))),
        motion=t(np.where(act, rng.normal(size=(cap, 3)) * 0.3, 0.0))),
        stats=pool.stats._replace(sh_degree=torch.tensor(
            1, dtype=torch.int32, device=device)))
    return S.init_stgs_state(pool), cfg


@pytest.mark.parametrize("sh_degree_t", [0, 1])
def test_stgs_render_and_step_on_the_card(cuda, sh_degree_t):
    """render_stgs launches K5 and gauss3d K1 once, a step K5, gauss3d K1
    and K2 once; the card's render, loss and every gradient (t, scaling_t,
    motion among them) as the CPU's."""
    from envgs_tpu_torch.models import stgs as S

    K = np.array([[50.0, 0, 20], [0, 50.0, 20], [0, 0, 1]], np.float32)
    target = np.random.default_rng(2).random((40, 40, 3)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        state, cfg = _stgs_state(dev, sh_degree_t)
        cam = make_camera(40, 40, K, np.eye(3, dtype=np.float32),
                          np.array([0.05, -0.03, 0.0], np.float32),
                          device=dev)
        before = dict(kernels.LAUNCHES)
        with torch.no_grad():
            out = S.render_stgs(state.pool, cam, 0.35, cfg)
        rendered = _rose(before)
        before = dict(kernels.LAUNCHES)
        grads = {}
        _, aux = S.make_stgs_train_step(cfg, cam, S.stgs_lr_config())(
            state, cam.K, cam.R, cam.T, 0.35,
            torch.tensor(target, device=dev), 7, grads_out=grads)
        res[str(dev)] = (out, aux, grads["params"], rendered, _rose(before))
    (co, ca, cg, _, _), (go, ga, gg, r_rose, s_rose) = res["cpu"], res["cuda"]
    assert r_rose == {"fill_forward": 1, "raster_blend_fwd_gauss3d": 1,
                      "project3d_fwd": 1}
    assert s_rose == FAMILY_STEP
    np.testing.assert_allclose(go.rgb.cpu().numpy(), co.rgb.numpy(),
                               atol=ATOL)
    assert abs(float(ga["loss"]) / float(ca["loss"]) - 1) <= FAMILY_LOSS_RTOL
    for k in ("xyz", "features_dc", "scaling", "opacity", "t", "scaling_t",
              "motion"):
        assert _rel(getattr(gg, k), getattr(cg, k)) <= FAMILY_GRAD_RTOL, k


def test_point_planes_step_on_the_card(cuda):
    """A PointPlanes step (numpy-seeded weights carried to the card through
    the JAX parameter layout) launches K5, gauss3d K1 and K2 once; its loss
    and every gradient as the CPU's."""
    from envgs_tpu_torch.models import point_planes as PP

    cfg = PP.PointPlanesConfig(n_frames=4, pair_cap=2 ** 14, radius_max=0.05,
                               radius_shift=0.0)
    pts = (np.random.default_rng(0).normal(size=(200, 3)) * 0.12).astype(
        np.float32)
    weights = PP.point_planes_params_to_jax(
        cfg.init(pts, torch.Generator().manual_seed(0)))
    K = np.array([[46.0, 0, 20], [0, 46.0, 20], [0, 0, 1]], np.float32)
    target = np.random.default_rng(1).random((40, 40, 3)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        cam = make_camera(40, 40, K, np.eye(3, dtype=np.float32),
                          np.array([0.0, 0.0, 2.0], np.float32), device=dev)
        model = PP.point_planes_params_from_jax(weights, cfg, dev)
        _, step = PP.make_point_planes_train_step(cfg, cam)
        before = dict(kernels.LAUNCHES)
        grads = {}
        _, aux = step(model, PP.adam_init(model), 1 / 3, cam.K, cam.R, cam.T,
                      torch.tensor(target, device=dev), grads_out=grads)
        res[str(dev)] = (aux, grads["grads"], _rose(before))
    assert res["cuda"][2] == FAMILY_STEP
    assert abs(float(res["cuda"][0]["loss"]) / float(res["cpu"][0]["loss"])
               - 1) <= FAMILY_LOSS_RTOL
    for i, (g, w) in enumerate(zip(res["cuda"][1], res["cpu"][1])):
        if w.abs().max() > 0:
            assert _rel(g, w) <= FAMILY_GRAD_RTOL, i


@pytest.mark.parametrize("config", ["stgs_synthetic", "point_planes_synthetic"])
def test_family_config_on_the_card(cuda, tmp_path, config):
    """`train -c configs/exps/<config>.yaml` cut down (4 views of 16x16, 3
    iterations) on the card: K5, gauss3d K1 and K2 once a step, K5 and
    gauss3d K1 once per held-out render, nothing else."""
    import os

    from envgs_tpu_torch import cli

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = dict(kernels.LAUNCHES)
    _, summary = cli.main([
        "train", "-c", os.path.join(root, "configs", "exps",
                                    f"{config}.yaml"),
        "dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=4",
        f"out_root={tmp_path}", "runner_cfg.ep_iter=3",
        "runner_cfg.record=false"], device="cuda")
    n_eval = len(summary["frames"])
    assert n_eval == 1 and np.isfinite(summary["summary"]["psnr_mean"])
    assert _rose(before) == {"fill_forward": 3 + n_eval,
                             "raster_blend_fwd_gauss3d": 3 + n_eval,
                             "raster_blend_bwd_gauss3d": 3,
                             "project3d_fwd": 3 + n_eval,
                             "project3d_bwd": 3}


def test_served_frame_launches_k1_and_k3_once(cuda, tmp_path):
    """A frame served by RenderServer.handle (an in-process connection: a
    CAM0 message in, the hello, the JPEG and its stats out) on a runner of
    two 64x64 views: K1 and K3 once, nothing else, the JPEG the render's."""
    import asyncio
    import json

    from envgs_tpu_torch import cli
    from envgs_tpu_torch.serve import websocket_server as WS

    cfg = cli.smoke_config()
    cfg["out_root"] = str(tmp_path)
    cfg["dataset_cfg"].update(n_views=2, eval_every=0)
    cfg["runner_cfg"]["record"] = False
    runner = cli.make_runner(cfg, device="cuda")
    cam = runner.views[1]["camera"]

    class Conn:
        def __init__(self, msgs):
            self.sent, self.msgs = [], list(msgs)

        async def send(self, m):
            self.sent.append(m)

        def __aiter__(self):
            return self

        async def __anext__(self):
            if not self.msgs:
                raise StopAsyncIteration
            return self.msgs.pop(0)

    conn = Conn([WS.encode_camera(*(x.cpu().numpy() for x in (
        cam.K, cam.R, cam.T)))])
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    asyncio.run(WS.RenderServer(runner).handle(conn))
    torch.cuda.synchronize()
    assert _rose(before) == {"raster_blend_fwd": 1, "trace_blend_fwd": 1,
                             "env_cull": 1}
    hello, jpeg, stats = conn.sent
    assert json.loads(hello)["H"] == 64 and "stats" in json.loads(stats)
    assert jpeg == WS.encode_jpeg(WS.typed_map(runner.render_view(cam),
                                               "RENDER"))


@pytest.mark.parametrize("family", ["nerf", "neus", "enerf"])
def test_kernel_free_family_step_on_the_card(cuda, family):
    """A small NeRF / NeuS / ENeRF step (bench.family_small_step: the same
    weights, inputs and draws) on the card against the CPU: the loss, each
    gradient leaf (at least 1e-2 of the step's largest: ENeRF's blend
    logits' head has a cancelling gradient; leaves upstream of a ReLU at
    its kink apart), the parameters after the step; no kernel of the repo
    launched."""
    from envgs_tpu_torch import bench

    before = dict(kernels.LAUNCHES)
    got = bench.family_small_step(family, "cuda")
    assert _rose(before) == {}
    want = bench.family_small_step(family, "cpu")
    assert abs(got["loss"] / want["loss"] - 1) <= FAMILY_LOSS_RTOL
    top = max(np.abs(w).max() for w in want["grads"])
    errs = [np.abs(g - w).max() / max(np.abs(w).max(), 1e-2 * top)
            for g, w in zip(got["grads"], want["grads"])]
    # a ReLU at its kink on one device only (the card's sinf and the CPU's
    # sin part in the last bit) moves the leaves upstream of it in its
    # network: at most 6 of them, each within 2e-2 (chip_smoke.py's
    # FAMILY_BRANCH_LEAVES, BRANCH_RTOL)
    branch = [e for e in errs if e > FAMILY_GRAD_RTOL]
    assert len(branch) <= 6 and max(branch, default=0.0) <= 2e-2, errs
    # one Adam step moves a weight by at most about lr, either way
    for p, w in zip(got["params"], want["params"]):
        assert np.isfinite(p).all()
        assert np.abs(p - w).max() <= 2.5 * got["lr"]


def test_raster_kernels_at_a_row_offset_match_plain(cuda):
    """K1 in training mode and K2 on a band's aligned layout (rows 48-79 of
    the 80-row image: row_window (3, 2), row offset 48) against their plain
    versions at the same offset; K1's planes equal the full image's rows,
    and both launches count as row-offset launches."""
    from envgs_tpu_torch.models.envgs import _pool_colors
    from envgs_tpu_torch.ops.binning import bin_splats
    from envgs_tpu_torch.ops.common import ROWCULL_LOWPASS_R, prepare_splats
    from envgs_tpu_torch.ops.raster import _pack_table

    base, _, cam, cfg = _scene(cuda)
    colors = torch.cat([_pool_colors(base, cam.center), base.get_specular,
                        base.get_roughness], dim=-1)
    prep = prepare_splats(base.params.xyz, base.params.rotation,
                          base.get_scaling, base.get_opacity[:, 0], colors,
                          cam, active=base.stats.active)

    def layout(window):
        bins = bin_splats(prep, cam.H, cam.W, 16, cfg.pair_cap, align=64,
                          lowpass_r=ROWCULL_LOWPASS_R, aligned=True,
                          row_window=window)
        return (_pack_table(prep, bins.order), bins.gauss_idx,
                bins.tile_bounds, colors.shape[-1], bins.tiles_x,
                bins.tiles_y)

    args = layout((3, 2))
    n = dict(kernels.ROW_OFF_LAUNCHES)
    out = blend_tiles(*args, 48, TRAIN_NEEDS, aligned=True)
    want = blend_tiles_torch(*args, 48, TRAIN_NEEDS, aligned=True)
    assert float((out - want).abs().max()) <= ATOL
    full = blend_tiles(*layout(None), 0, TRAIN_NEEDS, aligned=True)
    assert torch.equal(out, full[:, 48:80, :out.shape[2]])
    g_out = _cotangent(out, 3)
    got = blend_tiles_bwd(*args[:3], out, g_out, *args[3:], 48)
    torch.cuda.synchronize()
    ref = blend_tiles_bwd_torch(*args[:3], out, g_out, *args[3:], 48)
    cols = list(range(15 + args[3])) + [31]
    _close_columns(got[:, cols], ref[:, cols])
    assert kernels.ROW_OFF_LAUNCHES[TRAIN_KEY] == n[TRAIN_KEY] + 1
    assert kernels.ROW_OFF_LAUNCHES["raster_blend_bwd"] == (
        n["raster_blend_bwd"] + 1)


def test_band_render_equals_the_full_rows_on_the_card(cuda):
    """forward_envgs(band=(16, 80)) in training mode on the card: the base
    pass's maps equal rows 16-47 of the full render to the bit; K1, K3 and
    K5 once."""
    from envgs_tpu_torch.models.envgs import forward_envgs

    base, env, cam, cfg = _scene(cuda)
    cfg = cfg._replace(render_mode=False)
    hooks = (torch.zeros((base.cap, 2), device=cuda),
             torch.zeros((env.cap, 3), device=cuda),
             torch.zeros(base.cap, device=cuda),
             torch.zeros(env.cap, device=cuda))
    with torch.no_grad():
        full = forward_envgs(base, env, cam, 10, cfg, *hooks)
        before = dict(kernels.LAUNCHES)
        band = forward_envgs(base, env, cam._replace(H=32), 10, cfg, *hooks,
                             band=(16, cam.H))
        torch.cuda.synchronize()
    assert _rose(before) == {TRAIN_KEY: 1, "trace_blend_fwd": 1,
                             "fill_forward": 1, "env_cull": 1}
    for k in ("acc_map", "dpt_map", "norm_map", "spec_map", "dist_map",
              "dif_rgb_map"):
        assert torch.equal(getattr(band, k), getattr(full, k)[16:48]), k

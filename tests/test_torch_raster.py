"""Parity of the port's rasterizer (render path) with the JAX package: the
plain version of kernel K1 against the Pallas kernel in interpret mode,
and rasterize + render_decode end to end."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import raster as jraster
from envgs_tpu.ops import raster_pallas as rp
from envgs_tpu.ops.binning import bin_splats
from envgs_tpu.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops import common as tcommon
from envgs_tpu_torch.ops import raster as traster
from envgs_tpu_torch.ops.raster_blend import blend_tiles_torch, out_rows
from envgs_tpu_torch.utils import camera as tcam

H, W = 48, 64  # 3 x 4 tiles; W is not a multiple of 16 in the e2e test
ATOL = 1e-5  # sequential vs the closed-form exclusive product of (1 - a)


def _scene(P=240, C=5, seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                            rng.random((P, 1)) * 3.0 + 1.5],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.2 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, C)).astype(np.float32)
    return means, quats, scales, opac, colors


def _K(h, w):
    f = 0.9 * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def test_blend_tiles_matches_pallas_kernel():
    """Same pair layout and table in; every render output plane equal to
    ATOL (C=5: rgb + specular + roughness as on the EnvGS base pass)."""
    C = 5
    cam = make_camera(H, W, _K(H, W), np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))
    prep = jax.jit(lambda *a: prepare_splats(*a, cam))(*_scene(C=C))
    bins = jax.jit(functools.partial(
        bin_splats, H=H, W=W, tile=16, pair_cap=4096, align=64,
        lowpass_r=ROWCULL_LOWPASS_R, aligned=False))(prep)
    packed = jraster._pack_table(prep, bins.order)
    tx, ty = int(bins.tiles_x), int(bins.tiles_y)

    @jax.jit
    def blend(packed, gauss_idx, bounds):
        pairs = rp.pack_rows(packed)[gauss_idx]
        return rp._blend_fwd_call(pairs, bounds, C, tx, True,
                                  needs=(False, False, False),
                                  aligned=False)[0]

    tiles = np.asarray(blend(packed, bins.gauss_idx, bins.tile_bounds))
    want = (tiles.reshape(ty, tx, -1, 16, 16).transpose(2, 0, 3, 1, 4)
            .reshape(tiles.shape[1], ty * 16, tx * 16))
    got = blend_tiles_torch(torch.tensor(np.asarray(packed)),
                            torch.tensor(np.asarray(bins.gauss_idx)),
                            torch.tensor(np.asarray(bins.tile_bounds)),
                            C, tx, ty).numpy()
    jr, r = rp._rows(C), out_rows(C)
    for name in ("depth", "alpha", "trans"):
        np.testing.assert_allclose(got[r[name]], want[jr[name]], atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[:C], want[:C], atol=ATOL)
    np.testing.assert_allclose(got[r["normal"]:r["normal"] + 3],
                               want[jr["normal"]:jr["normal"] + 3], atol=ATOL)
    assert want[jr["alpha"]].max() > 0.9  # some pixels saturate


def test_rasterize_matches_jax():
    """prepare_splats -> rasterize -> render_decode from the same numpy
    inputs on both sides (W = 56: a partial tile column)."""
    h, w = 48, 56
    K = _K(h, w)
    jc = make_camera(h, w, K, np.eye(3, dtype=np.float32),
                     np.zeros(3, np.float32))
    tc = tcam.make_camera(h, w, K, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    scene = _scene(C=3, seed=1)
    bg = np.array([0.2, 0.4, 0.6], np.float32)

    @jax.jit
    def jfwd(*a):
        prep = prepare_splats(*a, jc)
        out = jraster.rasterize(prep, jc, jnp.asarray(bg),
                                backend="pallas_interp", pair_cap=4096,
                                needs=(False, False, False))
        return out, jraster.render_decode(out, jc)

    jout, jdec = jfwd(*scene)
    tprep = tcommon.prepare_splats(*map(torch.tensor, scene), tc)
    tout = traster.rasterize(tprep, tc, torch.tensor(bg), pair_cap=4096)
    tdec = traster.render_decode(tout, tc)
    for name in ("rgb", "alpha", "depth_expected", "normal", "trans"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=ATOL, err_msg=name)
    assert int(tout.num_pairs) == int(jout.num_pairs)
    for name in ("rgb", "alpha", "normal_world", "depth_expected"):
        np.testing.assert_allclose(getattr(tdec, name).numpy(),
                                   np.asarray(getattr(jdec, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tdec.visibility.numpy(),
                                  np.asarray(jdec.visibility))


def test_rasterize_forward_wet_matches_jax():
    """needs all on and no wet_zero hook: the training outputs and the
    forward per-splat wet (K1's per-pair wet summed per splat) against JAX
    rasterize with needs=(True, True, True), from JAX's own prepared
    splats."""
    K = _K(H, W)
    jc = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                     np.zeros(3, np.float32))
    tc = tcam.make_camera(H, W, K, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    jp = jax.jit(lambda *a: prepare_splats(*a, jc))(*_scene(C=3, seed=2))
    jout = jax.jit(lambda p: jraster.rasterize(
        p, jc, jnp.asarray(bg), backend="pallas_interp", pair_cap=4096,
        needs=(True, True, True)))(jp)
    tp = tcommon.PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tout = traster.rasterize(tp, tc, torch.tensor(bg), pair_cap=4096,
                             needs=(True, True, True))
    for name in ("rgb", "alpha", "depth_expected", "normal", "depth_median",
                 "distortion", "trans", "d1", "d2", "wet"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=ATOL, err_msg=name)
    jwet = np.asarray(jout.wet)
    assert (jwet > 1.0).sum() > 20 and (jwet == 0).any()
    np.testing.assert_array_equal(tout.wet.numpy() == 0, jwet == 0)


@pytest.mark.parametrize("depth_ratio", [0.5, 1.0])
def test_rasterize_median_only_matches_jax(depth_ratio):
    """needs = (False, True, False), what render_mode with depth_ratio > 0
    asks for: the unaligned render layout with the median depth written.
    From JAX's own prepared splats, the median depth, the decoded surface
    depth and normal and rgb within 1e-5 of JAX; distortion and wet zeros."""
    K = _K(H, W)
    jc = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                     np.zeros(3, np.float32))
    tc = tcam.make_camera(H, W, K, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    jp = jax.jit(lambda *a: prepare_splats(*a, jc))(*_scene(C=3, seed=4))

    @jax.jit
    def jfwd(p):
        out = jraster.rasterize(p, jc, jnp.asarray(bg),
                                backend="pallas_interp", pair_cap=4096,
                                needs=(False, True, False))
        return out, jraster.render_decode(out, jc, depth_ratio=depth_ratio)

    jout, jdec = jfwd(jp)
    tp = tcommon.PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tout = traster.rasterize(tp, tc, torch.tensor(bg), pair_cap=4096,
                             needs=(False, True, False))
    tdec = traster.render_decode(tout, tc, depth_ratio=depth_ratio)
    for name in ("rgb", "alpha", "depth_expected", "depth_median", "trans"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=ATOL, err_msg=name)
    for name in ("depth_median", "surf_depth", "surf_normal", "rgb"):
        np.testing.assert_allclose(getattr(tdec, name).numpy(),
                                   np.asarray(getattr(jdec, name)),
                                   atol=ATOL, err_msg=name)
    assert float(tout.depth_median.max()) > 1.5  # the median was written
    assert int(tout.num_pairs) == int(jout.num_pairs)
    assert not tout.distortion.any() and not tout.wet.any()
    assert tout.d1 is None and not tout.depth_median.requires_grad


def test_training_outputs_raise():
    """The training outputs come all together: a partial `needs` raises
    (tests/test_torch_train_raster.py covers the training path)."""
    tc = tcam.make_camera(16, 16, _K(16, 16), np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    prep = tcommon.prepare_splats(*map(torch.tensor, _scene(P=8, C=3)), tc)
    with pytest.raises(NotImplementedError, match="train"):
        traster.rasterize(prep, tc, torch.zeros(3), needs=(True, False, False))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors only; nothing falls back."""
    packed = torch.zeros(5, 32)
    idx = torch.zeros(64, dtype=torch.int32)
    bounds = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.raster_blend_fwd(packed, idx, bounds, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.trace_blend_fwd(packed, idx, torch.zeros(1, 8, 256), bounds,
                                1, 1)
    planes = torch.zeros(14, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.raster_blend_bwd(packed, idx, bounds, planes, planes, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.trace_blend_bwd(packed, idx, torch.zeros(1, 8, 256), bounds,
                                planes[:13], planes[:13], 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fill_forward(torch.zeros(3, 64, dtype=torch.int32), idx)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.raster_blend_fwd(packed, idx, bounds, 3, 1, 1, mode="gauss3d",
                                 wet=True)
    rows = torch.zeros(1024, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.segscan(rows, torch.zeros(1024, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gather_rows(rows, idx)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gather_rows_win8(rows.to(torch.bfloat16), idx)
    assert set(kernels.LAUNCHES) == {
        "raster_blend_fwd", "raster_blend_fwd_gauss3d", "raster_blend_bwd",
        "raster_blend_bwd_gauss3d", "trace_blend_fwd", "trace_blend_bwd",
        "fill_forward", "segscan", "gather_rows", "gather_rows_win8"}
    assert not any(kernels.LAUNCHES.values())

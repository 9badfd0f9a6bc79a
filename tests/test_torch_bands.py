"""Parity of the port's band arguments (the row-crop of the band-parallel
step) with the JAX package, at 64 x 48 in bands of 16 or 32 rows:
get_rays(i0), Camera.crop_rows, depth_to_normal(i0), bin_splats
(row_window), rasterize(row_window) in render and training mode and with the training
outputs on the unaligned layout,
render_decode(i0), forward_envgs(band=(row0, H)) with the rasterized and
the traced base, and ssim_masked with its closed-form backward.

Besides JAX, the port's band is held to its own full render: the base
pass's rows equal the full image's to the bit. The JAX side runs its
Pallas kernels in interpret mode; the port its plain versions, on one
thread (tests/torch_threads.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.ops import binning as jbin
from envgs_tpu.ops import losses as jlosses
from envgs_tpu.ops import raster as jraster
from envgs_tpu.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu.utils import camera as jcam
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.ops import binning as tbin
from envgs_tpu_torch.ops import losses as tlosses
from envgs_tpu_torch.ops import raster as traster
from envgs_tpu_torch.ops.common import PreparedSplats
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_envgs import _inputs
from torch_threads import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

H, W, F = 64, 48, 50.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
R = np.array([[0.96, 0.0, 0.28], [0.0, 1.0, 0.0], [-0.28, 0.0, 0.96]],
             np.float32)
T = np.array([0.1, -0.05, 0.2], np.float32)
# forward maps against JAX: last-bit differences of the same terms
ATOL = 1e-5
# forward_envgs: two blends in a row and the reflected-ray chain between
# them (tests/test_torch_envgs.py's bound): last-bit differences of the
# base pass move the reflected rays
ENV_ATOL = 1e-4
# gradients: per array max|d| / max|ref|, the JAX package's own budget
GRAD_RTOL = 5e-4
BANDS = [(16, 16), (32, 16), (0, 32), (32, 32)]  # (row0, band_h)


def _cams(row0, band_h):
    """(JAX full, JAX band, port full, port band): a band's camera holds
    the full image's K with H the band's height."""
    jf = jcam.make_camera(H, W, K, R, T)
    tf = tcam.make_camera(H, W, K, R, T)
    return jf, jf._replace(H=band_h), tf, tf._replace(H=band_h)


@pytest.mark.parametrize("row0,band_h", BANDS)
def test_rays_and_depth_normal_at_a_row_offset(row0, band_h):
    """get_rays(i0) and depth_to_normal(i0) of a band against JAX's; the
    band's rays are the full image's rows to the bit; crop_rows shifts the
    principal point as JAX's does."""
    jf, jb, tf, tb = _cams(row0, band_h)
    o, d = tcam.get_rays(tb, i0=row0)
    jo, jd = jcam.get_rays(jb, i0=row0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    _, d_full = tcam.get_rays(tf)
    assert torch.equal(d, d_full[row0:row0 + band_h])

    rng = np.random.default_rng(row0 + band_h)
    depth = (rng.random((band_h + 2, W)) * 2 + 2).astype(np.float32)
    got = traster.depth_to_normal(tf._replace(H=band_h + 2),
                                  torch.tensor(depth), i0=row0 - 1.0)
    want = jraster.depth_to_normal(jf._replace(H=band_h + 2),
                                   jnp.asarray(depth), i0=row0 - 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    np.testing.assert_array_equal(tf.crop_rows(row0, band_h).K.numpy(),
                                  np.asarray(jf.crop_rows(row0, band_h).K))
    assert tf.crop_rows(row0, band_h).H == band_h


def _prep(seed=0, P=300):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.7,
                            rng.random((P, 1)) * 3.0 + 1.5],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.25 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, 5)).astype(np.float32)
    active = jnp.asarray(rng.random(P) > 0.1)
    cam = jcam.make_camera(H, W, K, R, T)
    jp = jax.jit(lambda *a: prepare_splats(*a, cam, active=active))(
        means, quats, scales, opac, colors)
    return jp, PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("row0,band_h", BANDS[:3])
def test_bin_splats_row_window_matches_jax(row0, band_h, aligned):
    """A band's layout from the full camera's splats: order, gauss_idx,
    tile_bounds and num_pairs integer-equal to JAX's, tile ids band-local
    (tiles_y the band's); some splats straddle the band's edges."""
    jp, tp = _prep()
    window = (row0 // 16, band_h // 16)
    jb = jax.jit(functools.partial(
        jbin.bin_splats, H=H, W=W, tile=16, pair_cap=4096, align=64,
        interpret=True, lowpass_r=ROWCULL_LOWPASS_R, aligned=aligned,
        row_window=window))(jp)
    tb = tbin.bin_splats(tp, H, W, 16, 4096, align=64,
                         lowpass_r=ROWCULL_LOWPASS_R, aligned=aligned,
                         row_window=window)
    assert int(tb.num_pairs) == int(jb.num_pairs) > 0
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.gauss_idx.numpy(),
                                  np.asarray(jb.gauss_idx))
    np.testing.assert_array_equal(tb.tile_bounds.numpy(),
                                  np.asarray(jb.tile_bounds))
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y) == (
        W // 16, band_h // 16)
    full = tbin.bin_splats(tp, H, W, 16, 4096, align=64,
                           lowpass_r=ROWCULL_LOWPASS_R, aligned=aligned)
    assert int(tb.num_pairs) < int(full.num_pairs)


BG = np.array([0.2, 0.4, 0.6], np.float32)
OUTPUTS = {"render": ("rgb", "depth_expected", "alpha", "normal", "trans"),
           "train": ("rgb", "depth_expected", "alpha", "normal",
                     "depth_median", "distortion", "trans", "d1", "d2")}


@pytest.mark.parametrize("mode", ["render", "train"])
@pytest.mark.parametrize("row0,band_h", BANDS[1:3])
def test_rasterize_row_window_matches_jax(row0, band_h, mode):
    """rasterize(row_window) against JAX's (the blend at the band's row
    offset) within ATOL, and equal to the rows of the port's full render
    to the bit; the training path's forward wet within 1e-5 of its
    largest."""
    jp, tp = _prep(seed=1)
    jf, _, tf, _ = _cams(row0, band_h)
    train = mode == "train"
    needs = (train,) * 3
    jout = jax.jit(lambda p: jraster.rasterize(
        p, jf, jnp.asarray(BG), backend="pallas_interp", pair_cap=4096,
        needs=needs, row_window=(row0, band_h)))(jp)
    tout = traster.rasterize(tp, tf, torch.tensor(BG), pair_cap=4096,
                             needs=needs, row_window=(row0, band_h))
    full = traster.rasterize(tp, tf, torch.tensor(BG), pair_cap=4096,
                             needs=needs)
    rows = slice(row0, row0 + band_h)
    for k in OUTPUTS[mode]:
        got = getattr(tout, k)
        assert got.shape[:2] == (band_h, W), k
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jout, k)),
                                   atol=ATOL, err_msg=k)
        assert torch.equal(got, getattr(full, k)[rows]), k
    assert float(tout.alpha.max()) > 0.5
    if train:
        want = np.asarray(jout.wet)
        np.testing.assert_allclose(tout.wet.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("row0", [0, 16, 48])
def test_rasterize_row_window_unaligned_training_needs(row0):
    """needs = (True, True, False), the training outputs on the unaligned
    layout (JAX's own band case, tests/test_raster_pallas.py): the band's
    maps within ATOL of JAX's band, and within 2e-7 of the rows of the
    port's full render, the bound JAX holds its band to (each tile's
    windows start at its own start % 8 in either run)."""
    jp, tp = _prep(seed=5)
    jf, _, tf, _ = _cams(row0, 16)
    needs = (True, True, False)
    jout = jax.jit(lambda p: jraster.rasterize(
        p, jf, jnp.asarray(BG), backend="pallas_interp", pair_cap=4096,
        needs=needs, row_window=(row0, 16)))(jp)
    tout = traster.rasterize(tp, tf, torch.tensor(BG), pair_cap=4096,
                             needs=needs, row_window=(row0, 16))
    full = traster.rasterize(tp, tf, torch.tensor(BG), pair_cap=4096,
                             needs=needs)
    rows = slice(row0, row0 + 16)
    for k in OUTPUTS["train"]:
        got = getattr(tout, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jout, k)),
                                   atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got.numpy(), getattr(full, k)[rows],
                                   atol=2e-7, err_msg=k)
    assert float(jout.distortion.max()) > 0
    assert float(jout.depth_median.max()) > 1.5
    assert not tout.wet.any()


@pytest.mark.parametrize("row0", [16, 48])
def test_render_decode_at_a_row_offset(row0):
    """render_decode(i0) of a band's raw maps against JAX's: the surface
    normal from the depth with the band's global rows."""
    rng = np.random.default_rng(row0)
    h = 16
    alpha = rng.random((h, W)).astype(np.float32)
    raw = dict(rgb=rng.random((h, W, 5)), depth_expected=alpha * (
        rng.random((h, W)) * 2 + 2), alpha=alpha,
        normal=rng.normal(size=(h, W, 3)), depth_median=rng.random((h, W)),
        distortion=rng.random((h, W)), wet=rng.random(7), radii=rng.random(7),
        trans=1 - alpha)
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    _, jb, _, tb = _cams(row0, h)
    want = jraster.render_decode(
        jraster.RasterOutput(**{k: jnp.asarray(v) for k, v in raw.items()},
                             num_pairs=None),
        jb, specular_channels=1, depth_ratio=0.3, i0=row0)
    got = traster.render_decode(
        traster.RasterOutput(**{k: torch.tensor(v) for k, v in raw.items()}),
        tb, specular_channels=1, depth_ratio=0.3, i0=row0)
    for k in ("surf_depth", "surf_normal", "normal_world", "depth_expected"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=ATOL,
                                   err_msg=k)


BASE_MAPS = ("acc_map", "dpt_map", "norm_map", "spec_map", "rough_map",
             "dist_map", "dif_rgb_map")
MAPS = BASE_MAPS + ("rgb_map", "surf_norm_map", "env_rgb_map", "env_acc_map")


def _pools():
    xyz, col, exyz, ecol = _inputs(seed=3)
    spec = np.linspace(-3, 2, 160, dtype=np.float32)[:, None]
    jb = create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    jb = jb._replace(params=jb.params._replace(specular=jnp.asarray(spec)))
    je = create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    tb = tg.create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    tb = tb._replace(params=tb.params._replace(specular=torch.tensor(spec)))
    te = tg.create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    return (jb, je), (tb, te)


@pytest.mark.parametrize("base", ["raster", "traced"])
def test_forward_envgs_band_matches_jax(base):
    """forward_envgs(band=(row0, H)) in training mode (forward wet, no
    hooks) for rows 16-31 against JAX's with the same 2-tuple band: the
    base pass's maps within ATOL, those past the reflected rays within
    ENV_ATOL, the per-splat base and env wet within 1e-5 of their
    largest. The rasterized base pass's maps are the port's full render's
    rows to the bit (the surface normal's inside the band's edge rows)."""
    (jb, je), (tb, te) = _pools()
    row0, h = 16, 16
    kw = dict(pair_cap=2 ** 14, env_pair_cap=2 ** 13, reflection_start_iter=0,
              use_base_tracing=base == "traced")
    jcfg = jenv.EnvGSConfig(raster_backend="pallas_interp",
                            tracer_backend="tiled_interp", **kw)
    tcfg = tenv.EnvGSConfig(**kw)
    jf, jband, tf, tband = _cams(row0, h)
    want = jax.jit(lambda b, e: jenv.forward_envgs(
        b, e, jband, 10, jcfg, band=(row0, H)))(jb, je)
    got = tenv.forward_envgs(tb, te, tband, 10, tcfg, band=(row0, H))
    for k in MAPS:
        np.testing.assert_allclose(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)),
            atol=ATOL if k in BASE_MAPS else ENV_ATOL, err_msg=k)
    for k in ("base_wet", "env_wet"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)
    assert float(got.env_acc_map.max()) > 0.1
    if base == "raster":
        full = tenv.forward_envgs(tb, te, tf, 10, tcfg)
        rows = slice(row0, row0 + h)
        for k in BASE_MAPS:
            assert torch.equal(getattr(got, k), getattr(full, k)[rows]), k
        assert torch.equal(got.surf_norm_map[1:-1],
                           full.surf_norm_map[row0 + 1:row0 + h - 1])
        assert torch.equal(got.base_radii, full.base_radii)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_ssim_masked_matches_jax(n_bands):
    """Each band's ssim_masked share (its rows and 5-row halos, zeros past
    the image's edges) against JAX's, forward and gradient; the shares sum
    to ssim of the whole image (JAX's and the port's)."""
    rng = np.random.default_rng(n_bands)
    x = rng.random((H, W, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape) * 0.1, 0, 1).astype(np.float32)
    k, h = 5, H // n_bands
    n_g = (H - 2 * k) * (W - 2 * k) * 3
    pad = lambda a: np.concatenate([np.zeros((k, W, 3), np.float32), a,  # noqa: E731
                                    np.zeros((k, W, 3), np.float32)])
    xp, yp = pad(x), pad(y)
    total = 0.0
    g = rng.normal(size=()).astype(np.float32)
    for b in range(n_bands):
        xe, ye = xp[b * h:b * h + h + 2 * k], yp[b * h:b * h + h + 2 * k]
        grow = b * h + np.arange(h)
        mask = ((grow >= k) & (grow <= H - 1 - k)).astype(np.float32)
        mask = mask[:, None, None]
        want, jvjp = jax.vjp(lambda a, c: jlosses.ssim_masked(
            a, c, jnp.asarray(mask), n_g), jnp.asarray(xe), jnp.asarray(ye))
        jgx, jgy = jvjp(jnp.asarray(g))
        tx = torch.tensor(xe, requires_grad=True)
        ty = torch.tensor(ye, requires_grad=True)
        got = tlosses.ssim_masked(tx, ty, torch.tensor(mask), n_g)
        gx, gy = torch.autograd.grad(got, [tx, ty], torch.tensor(g))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5,
                                   atol=1e-7)
        for a, b_ in ((gx, jgx), (gy, jgy)):
            scale = np.abs(np.asarray(b_)).max()
            assert np.abs(a.numpy() - np.asarray(b_)).max() <= (
                GRAD_RTOL * scale)
        total += float(got.detach())
    whole = float(jlosses.ssim(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(total, whole, rtol=1e-5)
    np.testing.assert_allclose(
        total, float(tlosses.ssim(torch.tensor(x), torch.tensor(y))),
        rtol=1e-5)

"""Parity of the port's 3DGS rasterizer with the JAX package: the EWA
projection, the gauss3d tile blend with its forward wet (the plain versions
of K1/K2 against the Pallas kernels in interpret mode), and the gradients
of render_gaussians3d against jax.grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import raster3d as jr3d
from envgs_tpu.ops.binning import bin_splats
from envgs_tpu.ops.raster3d_ref import prepare_splats3d
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.ops import binning as tbinning
from envgs_tpu_torch.ops import raster3d as tr3d
from envgs_tpu_torch.ops import raster3d_ref as tref
from envgs_tpu_torch.utils import camera as tcam

H, W = 48, 56  # 3 x 4 tiles, a partial tile column
P, C = 160, 3
# forward: the sequential blend against the JAX closed form, last bits only
ATOL = 1e-5
# gradients: per array max|d| / max|ref| (the JAX package's gradient budget)
GRAD_RTOL = 5e-4
BG = np.array([0.1, 0.3, 0.5], np.float32)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                            rng.random((P, 1)) * 3.0 + 1.0],
                           axis=1).astype(np.float32)
    means[:4, 2] = -1.0  # behind the camera: culled
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 3)) * 0.08 + 0.01).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, C)).astype(np.float32)
    return means, quats, scales, opac, colors


def _cams():
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T = np.array([0.05, -0.1, 0.2], np.float32)
    return make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)


@pytest.mark.parametrize("mip", [False, True])
def test_prepare_splats3d_matches_jax(mip):
    """Every field within 1e-5 (relative too), valid / radius / ext exactly;
    mip: the 3D smoothing filter and the 2D filter's opacity compensation."""
    scene = _scene()
    jc, tc = _cams()
    active = np.random.default_rng(1).random(P) > 0.1
    filt = (np.random.default_rng(2).random(P) * 0.02).astype(np.float32)
    kw = dict(lowpass2d=0.1, compensate2d=True) if mip else {}
    jp = prepare_splats3d(*scene, jc, active=jnp.asarray(active),
                          filter3d=jnp.asarray(filt) if mip else None, **kw)
    tp = tref.prepare_splats3d(*map(torch.tensor, scene), tc,
                               active=torch.tensor(active),
                               filter3d=torch.tensor(filt) if mip else None,
                               **kw)
    for k in ("valid", "radius", "ext"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert 0 < int(tp.valid.sum()) < P - 10
    for k in ("conic", "center_pix", "depth", "color", "opacity", "rowcull"):
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_rasterize3d_matches_jax():
    """From JAX's own prepared splats: the aligned binning integer-equal,
    rgb / depth / alpha / trans and the per-splat forward wet within ATOL."""
    scene = _scene()
    jc, tc = _cams()
    jp = jax.jit(lambda *a: prepare_splats3d(*a, jc))(*scene)
    jbins, jout = jax.jit(lambda p: (
        bin_splats(p, H, W, 16, 4096, align=64, interpret=True),
        jr3d.rasterize3d(p, jc, jnp.asarray(BG), backend="pallas_interp",
                         pair_cap=4096)))(jp)
    tp = tref.Prepared3DSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tbins = tbinning.bin_splats(tp, H, W, 16, 4096, align=64, aligned=True)
    for k in ("gauss_idx", "tile_bounds", "order", "num_pairs"):
        np.testing.assert_array_equal(getattr(tbins, k).numpy(),
                                      np.asarray(getattr(jbins, k)),
                                      err_msg=k)
    tout = tr3d.rasterize3d(tp, tc, torch.tensor(BG), pair_cap=4096)
    for k in ("rgb", "depth", "alpha", "trans", "wet", "radii"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    assert float(jout.alpha.max()) > 0.9  # some pixels saturate
    jwet = np.asarray(jout.wet)
    assert (jwet > 1.0).sum() > 20 and (jwet == 0).any()
    np.testing.assert_array_equal(tout.wet.numpy() == 0, jwet == 0)


def test_render_gaussians3d_grads_match_jax():
    """Gradients of random cotangent projections of rgb, depth, alpha and
    trans through prepare_splats3d and the gauss3d blend: means, quats,
    scales, opacity, colors and the means2d_zero hook within GRAD_RTOL of
    each array's max."""
    scene = _scene(3)
    jc, tc = _cams()
    rng = np.random.default_rng(4)
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, C)), ("depth", (H, W)), ("alpha", (H, W)),
        ("trans", (H, W)))}

    def loss(means, quats, scales, opac, colors, m2z):
        out = jr3d.render_gaussians3d(
            means, quats, scales, opac, colors, jc, bg_color=jnp.asarray(BG),
            backend="pallas_interp", pair_cap=4096, means2d_zero=m2z)
        return sum(jnp.sum(getattr(out, k) * cots[k]) for k in cots)

    jargs = tuple(map(jnp.asarray, scene)) + (jnp.zeros((P, 2)),)
    jg = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*jargs)

    args = [torch.tensor(x, requires_grad=True) for x in scene]
    m2z = torch.zeros((P, 2), requires_grad=True)
    out = tr3d.render_gaussians3d(*args, tc, bg_color=torch.tensor(BG),
                                  pair_cap=4096, means2d_zero=m2z)
    assert not out.wet.requires_grad
    tloss = sum(torch.sum(getattr(out, k) * torch.tensor(v))
                for k, v in cots.items())
    tg = torch.autograd.grad(tloss, args + [m2z])
    names = ["means", "quats", "scales", "opac", "colors", "means2d_zero"]
    for name, got, want in zip(names, tg, jg):
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got)), name
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_RTOL,
                                   err_msg=name)

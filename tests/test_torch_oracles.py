"""Parity of the port's CPU oracles with the JAX package's: the reference
tracer (`trace_rays_reference`, per-ray exact order, per-splat wet), the
reference rasterizer (`rasterize_reference`) with `splat_response`, the
reference 3DGS rasterizer (`rasterize3d_reference`) with
`compute_filter3d`; their gradients by autograd against jax.grad; the
`ref` dispatch of rasterize / rasterize3d / render_gaussiant; and the
backend names the port refuses.

The rasterizers are fed the JAX package's own prepared splats (the two
packages' screen transforms differ in their last bits, enough to move a
pixel across the alpha floor), so their outputs compare at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussiant as jgt
from envgs_tpu.ops import common as jcommon
from envgs_tpu.ops import raster_ref as jrr
from envgs_tpu.ops import raster3d_ref as jr3
from envgs_tpu.ops import tracer_ref as jtref
from envgs_tpu.ops.raster import _shift_tmat as j_shift_tmat
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussiant as tgt
from envgs_tpu_torch.ops import common as tcommon
from envgs_tpu_torch.ops import raster as traster
from envgs_tpu_torch.ops import raster3d as tr3d
from envgs_tpu_torch.ops import raster3d_ref as tr3
from envgs_tpu_torch.ops import raster_ref as trr
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops import tracer_ref as ttref
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_raster import _K
from tests.test_torch_raster import _scene as raster_scene
from tests.test_torch_raster3d import _scene as gauss_scene

H, W = 40, 56
# forward: the oracles' sums in another order (float32)
ATOL = 1e-5
# gradients: per array max|d| / max|ref|, the JAX package's budget
GRAD_RTOL = 5e-4
BG = np.array([0.2, 0.4, 0.6], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, name, tol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, atol=tol * max(
        1.0, float(np.abs(want).max())), rtol=0, err_msg=name)


def _close_grad(got, want, name):
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy() - want).max()
    assert err <= GRAD_RTOL * max(np.abs(want).max(), 1e-30), (name, err)


def _cams():
    K = _K(H, W)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T = np.array([0.05, -0.1, 0.2], np.float32)
    return make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)


def test_splat_response_matches_jax():
    """G and z of random transforms at random pixels, the low-pass branch
    taken on part of them."""
    rng = np.random.default_rng(0)
    tmat = rng.normal(size=(500, 3, 3)).astype(np.float32)
    tmat[:, 2, 2] += 3.0
    center = (rng.random((500, 2)) * 20).astype(np.float32)
    px, py = (rng.random((2, 500)) * 20).astype(np.float32)
    jG, jz = jcommon.splat_response(*map(jnp.asarray, (tmat, center, px, py)))
    G, z = tcommon.splat_response(*map(torch.tensor, (tmat, center, px, py)))
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-6)
    assert 0.05 < float((G > 0.01).float().mean()) < 0.95


def _raster_prep():
    jc, tc = _cams()
    prep = jax.jit(lambda *a: jcommon.prepare_splats(*a, jc))(
        *raster_scene(P=120, C=5, seed=2))
    return jc, tc, prep


def _to_port_prep(prep):
    return tcommon.PreparedSplats(*(_t(x) for x in prep))


def test_rasterize_reference_matches_jax():
    """Every output from the same prepared splats: within ATOL (of each
    array's largest value); the per-splat wet too; radii the same."""
    jc, tc, prep = _raster_prep()
    want = jrr.rasterize_reference(prep, jc, jnp.asarray(BG))
    got = trr.rasterize_reference(_to_port_prep(prep), tc, torch.tensor(BG))
    for k in ("rgb", "depth_expected", "alpha", "normal", "depth_median",
              "distortion", "wet", "radii", "trans", "d1", "d2"):
        _close(getattr(got, k), getattr(want, k), k)
    assert float(got.alpha.max()) > 0.9 and float(got.wet.max()) > 1.0


def test_rasterize_reference_gradients_match_jax():
    """Autograd through the reference rasterizer against jax.grad: a random
    weighting of rgb, depth, alpha, normal and distortion, differentiated
    with respect to the transforms, centres, opacities, normals and
    colours."""
    jc, tc, prep = _raster_prep()
    rng = np.random.default_rng(4)
    wts = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, 5)), ("depth_expected", (H, W)), ("alpha", (H, W)),
        ("normal", (H, W, 3)), ("distortion", (H, W)))}
    names = ("tmat", "center_pix", "opacity", "normal", "color")

    def jloss(*vals):
        out = jrr.rasterize_reference(prep._replace(**dict(zip(names, vals))),
                                      jc, jnp.asarray(BG))
        return sum(jnp.sum(getattr(out, k) * w) for k, w in wts.items())

    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *(getattr(prep, k) for k in names))
    tprep = _to_port_prep(prep)
    leaves = [getattr(tprep, k).clone().requires_grad_(True) for k in names]
    out = trr.rasterize_reference(tprep._replace(**dict(zip(names, leaves))),
                                  tc, torch.tensor(BG))
    loss = sum(torch.sum(getattr(out, k) * torch.tensor(w))
               for k, w in wts.items())
    for name, g, w in zip(names, torch.autograd.grad(loss, leaves), jg):
        _close_grad(g, w, name)


def test_rasterize_ref_backend_dispatches_to_the_oracle():
    """rasterize(backend="ref") is the reference on the hook-shifted
    splats, whatever `needs` and the wet hook say, with its forward wet."""
    jc, tc, prep = _raster_prep()
    tprep = _to_port_prep(prep)
    m2z = torch.full((120, 2), 0.25)
    got = traster.rasterize(tprep, tc, torch.tensor(BG), means2d_zero=m2z,
                            needs=(True, True, True), wet_zero=torch.zeros(
                                120), backend="ref")
    want = jrr.rasterize_reference(
        j_shift_tmat(prep, jnp.full((120, 2), 0.25)), jc, jnp.asarray(BG))
    for k in ("rgb", "alpha", "wet", "distortion"):
        _close(getattr(got, k), getattr(want, k), k)
    assert got.num_pairs is None and float(got.wet.max()) > 1.0


def _gauss_prep():
    jc, tc = _cams()
    scene = gauss_scene(seed=3)
    prep = jax.jit(lambda *a: jr3.prepare_splats3d(*a, jc))(*scene)
    return jc, tc, prep


def test_rasterize3d_reference_matches_jax():
    jc, tc, prep = _gauss_prep()
    want = jr3.rasterize3d_reference(prep, jc, jnp.asarray(BG))
    got = tr3.rasterize3d_reference(
        tr3.Prepared3DSplats(*(_t(x) for x in prep)), tc, torch.tensor(BG))
    for k in ("rgb", "depth", "alpha", "wet", "radii", "trans"):
        _close(getattr(got, k), getattr(want, k), k)
    assert float(got.alpha.max()) > 0.5


def test_rasterize3d_reference_gradients_match_jax():
    jc, tc, prep = _gauss_prep()
    rng = np.random.default_rng(6)
    wts = {"rgb": rng.normal(size=(H, W, 3)).astype(np.float32),
           "depth": rng.normal(size=(H, W)).astype(np.float32),
           "alpha": rng.normal(size=(H, W)).astype(np.float32)}
    names = ("conic", "center_pix", "depth", "color", "opacity")

    def jloss(*vals):
        out = jr3.rasterize3d_reference(
            prep._replace(**dict(zip(names, vals))), jc, jnp.asarray(BG))
        return sum(jnp.sum(getattr(out, k) * w) for k, w in wts.items())

    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *(getattr(prep, k) for k in names))
    tprep = tr3.Prepared3DSplats(*(_t(x) for x in prep))
    leaves = [getattr(tprep, k).clone().requires_grad_(True) for k in names]
    out = tr3.rasterize3d_reference(
        tprep._replace(**dict(zip(names, leaves))), tc, torch.tensor(BG))
    loss = sum(torch.sum(getattr(out, k) * torch.tensor(w))
               for k, w in wts.items())
    for name, g, w in zip(names, torch.autograd.grad(loss, leaves), jg):
        _close_grad(g, w, name)


def test_compute_filter3d_matches_jax():
    """Two cameras, points in front of, beside and behind them (the last
    take the largest interval seen)."""
    rng = np.random.default_rng(7)
    means = np.concatenate([rng.normal(size=(200, 2)) * 2.0,
                            rng.random((200, 1)) * 6.0 - 1.0],
                           -1).astype(np.float32)
    jc, tc = _cams()
    jc2 = make_camera(H, W, _K(H, W), np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))
    tc2 = tcam.make_camera(H, W, _K(H, W), np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
    want = jr3.compute_filter3d(jnp.asarray(means), [jc, jc2])
    got = tr3.compute_filter3d(torch.tensor(means), [tc, tc2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    want = np.asarray(want)
    assert len(np.unique(want)) > 50  # seen points: their own interval
    assert (want == want.max()).sum() > 5  # unseen: the largest one


def test_render_gaussiant_ref_backend_matches_jax():
    """The 3DGS family with raster_backend="ref": render_gaussiant through
    the reference rasterizer on both sides, from the same pool."""
    rng = np.random.default_rng(8)
    xyz = np.concatenate([rng.normal(size=(80, 2)) * 0.5,
                          rng.random((80, 1)) * 2 + 2.0],
                         -1).astype(np.float32)
    col = rng.random((80, 3)).astype(np.float32)
    jcfg = jgt.GaussianTConfig(raster_backend="ref", pair_cap=2 ** 12)
    tcfg = tgt.GaussianTConfig(raster_backend="ref", pair_cap=2 ** 12)
    jpool = jgt.init_gaussiant_pool(xyz, col, 128, jcfg, init_opacity=0.5)
    tpool = tgt.init_gaussiant_pool(xyz, col, 128, tcfg, init_opacity=0.5)
    jc, tc = _cams()
    want = jgt.render_gaussiant(jpool, jc, jcfg)
    got = tgt.render_gaussiant(tpool, tc, tcfg)
    for k in ("rgb", "depth", "alpha", "wet", "trans"):
        _close(getattr(got, k), getattr(want, k), k, tol=1e-4)
    assert got.num_pairs is None and float(got.alpha.max()) > 0.5
    plain = tr3d.rasterize3d(tgt.prepare_gaussiant(
        tpool, tc, tcfg, tgt.pool_colors(tpool, tc.center)), tc,
        torch.zeros(3), backend="ref")
    _close(plain.rgb, got.rgb.numpy(), "rgb through rasterize3d")


def _trace_inputs(P=120, seed=1):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    arrays = ((dirs * rng.uniform(4, 8, (P, 1))).astype(np.float32),
              rng.normal(size=(P, 4)).astype(np.float32),
              rng.uniform(0.3, 1.0, (P, 2)).astype(np.float32),
              rng.uniform(0.2, 0.95, P).astype(np.float32),
              rng.random((P, 3)).astype(np.float32),
              rng.random((P, 2)).astype(np.float32))
    o = (rng.normal(size=(12, 20, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(12, 20, 3)).astype(np.float32)
    return arrays, o, d


def test_trace_rays_reference_matches_jax():
    """The exact tracer on 240 rays in every direction through a shell of
    120 surfels: every output within ATOL, the per-splat wet too; the rays
    go through in blocks (the block's size forced down to 7 rays)."""
    arrays, o, d = _trace_inputs()
    js = jtref.prepare_trace_scene(*map(jnp.asarray, arrays[:5]),
                                   aux=jnp.asarray(arrays[5]))
    ts = ttref.prepare_trace_scene(*map(torch.tensor, arrays[:5]),
                                   aux=torch.tensor(arrays[5]))
    want = jtref.trace_rays_reference(js, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(BG))
    got = ttref.trace_rays_reference(ts, torch.tensor(o), torch.tensor(d),
                                     torch.tensor(BG))
    saved = ttref._REF_BLOCK_ELEMS
    try:
        ttref._REF_BLOCK_ELEMS = 7 * 120
        blocked = ttref.trace_rays_reference(ts, torch.tensor(o),
                                             torch.tensor(d),
                                             torch.tensor(BG))
    finally:
        ttref._REF_BLOCK_ELEMS = saved
    for k in ("rgb", "dpt", "acc", "norm", "dist", "aux", "wet", "trans"):
        _close(getattr(got, k), getattr(want, k), k)
        if k != "wet":  # the per-ray outputs do not depend on the blocks
            np.testing.assert_array_equal(getattr(blocked, k).numpy(),
                                          getattr(got, k).numpy(), k)
    # the wet, summed block by block, to rounding
    np.testing.assert_allclose(blocked.wet.numpy(), got.wet.numpy(),
                               rtol=1e-6)
    assert float(got.acc.max()) > 0.9 and float(got.wet.max()) > 1.0


def test_trace_rays_reference_gradients_match_jax():
    """Autograd through the exact tracer against jax.grad, with respect to
    the surfels' inputs and the rays."""
    arrays, o, d = _trace_inputs(P=60, seed=2)
    rng = np.random.default_rng(3)
    wts = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (12, 20, 3)), ("dpt", (12, 20)), ("acc", (12, 20)),
        ("norm", (12, 20, 3)), ("dist", (12, 20)), ("aux", (12, 20, 2)))}

    def jloss(*a):
        scene = jtref.prepare_trace_scene(*a[:5], aux=a[5])
        out = jtref.trace_rays_reference(scene, a[6], a[7], jnp.asarray(BG))
        return sum(jnp.sum(getattr(out, k) * w) for k, w in wts.items())

    args = [jnp.asarray(x) for x in (*arrays, o, d)]
    jg = jax.grad(jloss, argnums=tuple(range(8)))(*args)
    leaves = [torch.tensor(x, requires_grad=True) for x in (*arrays, o, d)]
    scene = ttref.prepare_trace_scene(*leaves[:5], aux=leaves[5])
    out = ttref.trace_rays_reference(scene, leaves[6], leaves[7],
                                     torch.tensor(BG))
    loss = sum(torch.sum(getattr(out, k) * torch.tensor(w))
               for k, w in wts.items())
    names = ("means", "quats", "scales", "opacity", "colors", "aux", "ray_o",
             "ray_d")
    for name, g, w in zip(names, torch.autograd.grad(loss, leaves), jg):
        _close_grad(g, w, name)


@pytest.mark.parametrize("call", ["rasterize", "rasterize3d", "multibounce",
                                  "forward_envgs"])
def test_other_backend_names_raise_by_name(call):
    """The JAX package's interpret-mode names (and any other) are refused,
    by name, before any work: the port has its kernels or the oracle."""
    _, tc, prep = _raster_prep()
    with pytest.raises(NotImplementedError, match="_interp"):
        if call == "rasterize":
            traster.rasterize(_to_port_prep(prep), tc, torch.tensor(BG),
                              backend="pallas_interp")
        elif call == "rasterize3d":
            _, _, gp = _gauss_prep()
            tr3d.rasterize3d(tr3.Prepared3DSplats(*(_t(x) for x in gp)), tc,
                             torch.tensor(BG), backend="pallas_interp")
        elif call == "multibounce":
            arrays, o, d = _trace_inputs()
            ts = ttref.prepare_trace_scene(*map(torch.tensor, arrays[:5]))
            ttr.trace_rays_multibounce(ts, torch.tensor(o), torch.tensor(d),
                                       torch.tensor(BG), max_trace_depth=1,
                                       backend="tiled_interp")
        else:
            tenv.forward_envgs(None, None, tc, 0, tenv.EnvGSConfig(
                tracer_backend="tiled_interp"))

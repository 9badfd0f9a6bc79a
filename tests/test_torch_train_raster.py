"""Parity of the port's training rasterizer with the JAX package: the
training-mode outputs of K1's plain version and the gradients of K2's
plain version (through prepare_splats, the screen-space hook and the wet
lane) against the Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from envgs_tpu.ops import raster as jraster
from envgs_tpu.ops.common import prepare_splats
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.ops import common as tcommon
from envgs_tpu_torch.ops import raster as traster
from envgs_tpu_torch.utils import camera as tcam

H, W = 32, 48  # 2 x 3 tiles
P, C = 140, 5  # C = 5: rgb + specular + roughness, as on the EnvGS base pass
# forward: the sequential blend against the JAX closed form (exclusive
# products and prefix sums of the same terms), last-bit differences only
ATOL = 1e-5
# gradients: per array max|d| / max|ref|, the JAX package's own budget
# (tests/test_raster_pallas.py) for two reverse walks that sum the same
# terms in another order
GRAD_RTOL = 5e-4
OUTPUTS = ("rgb", "depth_expected", "alpha", "normal", "distortion", "trans",
           "d1", "d2")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                            rng.random((P, 1)) * 3.0 + 1.5],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.2 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, C)).astype(np.float32)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    # random cotangents of every differentiable output
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, C)), ("depth_expected", (H, W)), ("alpha", (H, W)),
        ("normal", (H, W, 3)), ("distortion", (H, W)), ("trans", (H, W)),
        ("d1", (H, W)), ("d2", (H, W)))}
    return (means, quats, scales, opac, colors), K, cots


def _cam(K):
    return make_camera(H, W, K, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))


def _tcam(K):
    return tcam.make_camera(H, W, K, np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32))


BG = np.array([0.2, 0.4, 0.6], np.float32)


def _jax_rasterize(prep, cam, m2z, wz):
    return jraster.rasterize(prep, cam, jnp.asarray(BG),
                             backend="pallas_interp", pair_cap=4096,
                             means2d_zero=m2z, needs=(True, True, True),
                             wet_zero=wz)


def test_train_rasterize_outputs_match_jax():
    """Training forward outputs from JAX's own prepared splats: colors,
    depth, alpha, normal, median depth, distortion, its moments d1/d2 and
    the final T within ATOL; wet comes back as exact zeros (it is the
    wet_zero gradient)."""
    scene, K, _ = _inputs()
    cam = _cam(K)
    jp = jax.jit(lambda *a: prepare_splats(*a, cam))(*scene)
    jout = jax.jit(lambda p: _jax_rasterize(p, cam, jnp.zeros((P, 2)),
                                            jnp.zeros(P)))(jp)
    tp = tcommon.PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tout = traster.rasterize(tp, _tcam(K), torch.tensor(BG), pair_cap=4096,
                             means2d_zero=torch.zeros((P, 2)),
                             needs=(True, True, True),
                             wet_zero=torch.zeros(P))
    for k in OUTPUTS + ("depth_median",):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    assert float(jout.distortion.max()) > 0  # the distortion rows carry data
    assert float(jout.alpha.max()) > 0.9  # some pixels saturate
    assert int(tout.num_pairs) == int(jout.num_pairs)
    np.testing.assert_array_equal(tout.wet.numpy(), 0.0)


def test_train_rasterize_grads_match_jax():
    """Gradients of random cotangent projections of every output, through
    prepare_splats: means, quats, scales, opacity, colors and the
    means2d_zero hook within GRAD_RTOL of their max; the wet_zero gradient
    (per-splat wet) within the JAX package's wet budget, with zeros exactly
    where JAX's are (visibility is wet > 0)."""
    scene, K, cots = _inputs()
    cam = _cam(K)

    def loss(means, quats, scales, opac, colors, m2z, wz):
        prep = prepare_splats(means, quats, scales, opac, colors, cam)
        out = _jax_rasterize(prep, cam, m2z, wz)
        return sum(jnp.sum(getattr(out, k) * cots[k]) for k in OUTPUTS)

    jargs = tuple(map(jnp.asarray, scene)) + (jnp.zeros((P, 2)),
                                              jnp.zeros((P,)))
    jg = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*jargs)

    tc = _tcam(K)
    args = [torch.tensor(x, requires_grad=True) for x in scene]
    m2z = torch.zeros((P, 2), requires_grad=True)
    wz = torch.zeros(P, requires_grad=True)
    tout = traster.rasterize(tcommon.prepare_splats(*args, tc), tc,
                             torch.tensor(BG), pair_cap=4096,
                             means2d_zero=m2z, needs=(True, True, True),
                             wet_zero=wz)
    assert not tout.depth_median.requires_grad
    tloss = sum(torch.sum(getattr(tout, k) * torch.tensor(cots[k]))
                for k in OUTPUTS)
    tg = torch.autograd.grad(tloss, args + [m2z, wz])
    names = ["means", "quats", "scales", "opac", "colors", "means2d_zero"]
    for name, got, want in zip(names, tg, jg):
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got)), name
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_RTOL,
                                   err_msg=name)
    wet, jwet = tg[6].numpy(), np.asarray(jg[6])
    np.testing.assert_allclose(wet, jwet, rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(wet == 0, jwet == 0)
    assert (jwet > 0).sum() > P // 4 and (jwet == 0).any()

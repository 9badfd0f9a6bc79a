"""Parity of the port's training tracer with the JAX package: the
training-mode outputs of K3's plain version and the gradients of K4's
plain version (scene parameters, ray origins and directions, the wet lane)
against the Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from envgs_tpu.ops import tracer as jtr
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops.tracer_ref import TraceScene
from envgs_tpu_torch.ops.tracer_ref import \
    prepare_trace_scene as t_prepare_trace_scene

H, W = 32, 48  # 2 x 3 ray tiles
P, A = 150, 2  # A = 2 aux channels, the most the blend carries
CAP = 2 ** 13
# forward: sequential blend against the JAX closed form, last bits only
ATOL = 1e-5
# gradients: per array max|d| / max|ref| (the JAX package's budget)
GRAD_RTOL = 5e-4
OUTPUTS = ("rgb", "dpt", "acc", "norm", "dist", "aux", "trans")


def _inputs(seed=0):
    """Environment-like surfels at 4-9 units, tangent to their shell and
    gathered around the ray bundle, and a reflected-ray-like bundle."""
    rng = np.random.default_rng(seed)
    axis0 = np.array([0.3, -0.2, 1.0])
    dirs = axis0 / np.linalg.norm(axis0) + 0.3 * rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    means = (dirs * rng.uniform(4.0, 9.0, size=(P, 1))).astype(np.float32)
    z = np.array([0.0, 0.0, 1.0])
    ax = np.cross(np.broadcast_to(z, dirs.shape), dirs)
    ax /= np.clip(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-6, None)
    ang = np.arccos(np.clip(dirs[:, 2:3], -1, 1))
    quats = np.concatenate([np.cos(ang / 2), ax * np.sin(ang / 2)], -1)
    quats = (quats + 0.03 * rng.normal(size=(P, 4))).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.3 + 0.3).astype(np.float32)
    opac = (rng.random(P) * 0.8 + 0.15).astype(np.float32)
    colors = rng.random((P, 3)).astype(np.float32)
    aux = rng.random((P, A)).astype(np.float32)
    jj, ii = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    d = axis0 + 0.3 * np.stack([jj, ii, 0.2 * jj * ii], -1)
    o = 0.05 * np.stack([jj, ii, np.zeros_like(jj)], -1)
    o = o + 0.01 * rng.normal(size=o.shape)
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, 3)), ("dpt", (H, W)), ("acc", (H, W)),
        ("norm", (H, W, 3)), ("dist", (H, W)), ("aux", (H, W, A)),
        ("trans", (H, W)))}
    return ((means, quats, scales, opac, colors, aux),
            o.astype(np.float32), d.astype(np.float32), cots)


BG = np.array([0.1, 0.2, 0.3], np.float32)


def _jax_trace(scene, o, d, wz):
    return jtr.trace_rays(scene, o, d, jnp.asarray(BG),
                          backend="tiled_interp", total_pair_cap=CAP,
                          needs=(True, True, True), wet_zero=wz)


def _torch_trace(scene, o, d, wz):
    return ttr.trace_rays(scene, o, d, torch.tensor(BG), total_pair_cap=CAP,
                          needs=(True, True, True), wet_zero=wz)


def _jax_scene(means, quats, scales, opac, colors, aux):
    return prepare_trace_scene(means, quats, scales, opac, colors, aux=aux)


def test_train_trace_outputs_match_jax():
    """Training forward outputs from JAX's own scene: rgb, depth, acc, the
    ray-facing normal, distortion, aux and the final T within ATOL; the
    slot count integer-equal; wet exact zeros (it is the wet_zero
    gradient)."""
    arrays, o, d, _ = _inputs()
    js = jax.jit(_jax_scene)(*arrays)
    jout = jax.jit(lambda s: _jax_trace(s, jnp.asarray(o), jnp.asarray(d),
                                        jnp.zeros(P)))(js)
    ts = TraceScene(*(torch.tensor(np.asarray(x)) for x in js))
    tout = _torch_trace(ts, torch.tensor(o), torch.tensor(d), torch.zeros(P))
    for k in OUTPUTS:
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    assert float(jout.acc.max()) > 0.5 and float(jout.dist.max()) > 0
    assert int(tout.num_pairs) == int(jout.num_pairs)
    assert int(tout.dropped_pairs) == int(jout.dropped_pairs) == 0
    np.testing.assert_array_equal(tout.wet.numpy(), 0.0)


def test_train_trace_grads_match_jax():
    """Gradients of random cotangent projections of every output through
    prepare_trace_scene: means, quats, scales, opacity, colors, aux, the ray
    origins and directions within GRAD_RTOL of their max; the wet_zero
    gradient within the JAX package's wet budget, zeros exactly where
    JAX's are."""
    arrays, o, d, cots = _inputs()

    def loss(means, quats, scales, opac, colors, aux, o, d, wz):
        scene = _jax_scene(means, quats, scales, opac, colors, aux)
        out = _jax_trace(scene, o, d, wz)
        return sum(jnp.sum(getattr(out, k) * cots[k]) for k in OUTPUTS)

    jargs = tuple(map(jnp.asarray, arrays + (o, d))) + (jnp.zeros(P),)
    jg = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*jargs)

    targs = [torch.tensor(x, requires_grad=True) for x in arrays + (o, d)]
    wz = torch.zeros(P, requires_grad=True)
    m, q, s, op, c, aux, to, td = targs
    tout = _torch_trace(t_prepare_trace_scene(m, q, s, op, c, aux=aux), to,
                        td, wz)
    tloss = sum(torch.sum(getattr(tout, k) * torch.tensor(cots[k]))
                for k in OUTPUTS)
    tg = torch.autograd.grad(tloss, targs + [wz])
    names = ["means", "quats", "scales", "opac", "colors", "aux", "ray_o",
             "ray_d"]
    for name, got, want in zip(names, tg, jg):
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got)), name
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_RTOL,
                                   err_msg=name)
    wet, jwet = tg[8].numpy(), np.asarray(jg[8])
    np.testing.assert_allclose(wet, jwet, rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(wet == 0, jwet == 0)
    assert (jwet > 0).sum() > 10 and (jwet == 0).any()

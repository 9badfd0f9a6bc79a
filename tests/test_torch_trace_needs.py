"""Parity of the port's trace_rays with the JAX package under every `needs`
the JAX call honours (kernel K3's render, geometry, training and
training-with-wet configurations through their plain versions, against
the Pallas kernel in interpret mode), with and without the wet hook, with
compose_raw and with the cull's direction-space probe off; the per-slot
and per-splat forward wet; and the gradients of the training-with-wet
path that multi-bounce tracing takes.

Inputs: 256 surfels with two aux channels around a 16 x 32 bundle of
reflected-like rays (two ray tiles), seeded numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import tracer as jtr
from envgs_tpu.ops.raster_pallas import pack_rows
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops.trace_blend import _ray_sum, trace_blend_torch
from envgs_tpu_torch.ops.tracer_ref import \
    prepare_trace_scene as t_prepare_trace_scene
from tests.test_torch_tracer import _scene_arrays

H, W = 16, 32
P = 256
# forward: absolute, plus 1e-5 of the array's largest value (dpt holds ray
# parameters of 4 to 9 units; the per-splat wet sums of up to 2)
FWD_TOL = 1e-5
# gradients: per array max|d| / max|ref|, the JAX package's budget
GRAD_RTOL = 5e-4
OUTS = ("rgb", "dpt", "acc", "norm", "dist", "aux", "wet", "trans")


def _rays(seed=1):
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    base = np.array([0.3, -0.2, 1.0])
    d = base + 0.45 * np.stack([jj, ii, 0.2 * jj * ii], -1)
    o = 0.05 * np.stack([jj, ii, np.zeros_like(jj)], -1)
    o = o + 0.01 * rng.normal(size=o.shape)
    return o.astype(np.float32), d.astype(np.float32)


ARRAYS = _scene_arrays(P=P)
AUX = np.random.default_rng(3).random((P, 2)).astype(np.float32)
O, D = _rays()
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _jax(needs, hook=False, compose_raw=False, probe=True):
    means, quats, scales, opac, colors, active = ARRAYS

    @jax.jit
    def run(*a):
        scene = prepare_trace_scene(*a[:5], aux=a[5],
                                    active=jnp.asarray(active))
        return jtr.trace_rays(
            scene, jnp.asarray(O), jnp.asarray(D), jnp.asarray(BG),
            backend="tiled_interp", needs=needs,
            wet_zero=jnp.zeros(P) if hook else None,
            compose_raw=compose_raw, probe=probe)

    return run(means, quats, scales, opac, colors, AUX)


def _scene(requires_grad=False):
    means, quats, scales, opac, colors, active = ARRAYS
    leaves = [torch.tensor(x, requires_grad=requires_grad)
              for x in (means, quats, scales, opac, colors, AUX)]
    scene = t_prepare_trace_scene(*leaves[:5], aux=leaves[5],
                                  active=torch.tensor(active))
    return scene, leaves


def _port(needs, hook=False, compose_raw=False, probe=True):
    scene, _ = _scene()
    return ttr.trace_rays(scene, torch.tensor(O), torch.tensor(D),
                          torch.tensor(BG), needs=needs,
                          wet_zero=torch.zeros(P) if hook else None,
                          compose_raw=compose_raw, probe=probe)


def _close(got, want, name):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    tol = FWD_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def _check(got, want, names=OUTS):
    for k in names:
        _close(getattr(got, k), getattr(want, k), k)
    assert int(got.num_pairs) == int(want.num_pairs)
    assert int(got.dropped_pairs) == int(want.dropped_pairs)


# every combination of (need_dist, need_wet, need_geo), and the two-entry
# form whose need_geo defaults to True
NEEDS = [(d, w, g) for d in (False, True) for w in (False, True)
         for g in (False, True)] + [(False, False), (True, True)]


@pytest.mark.parametrize("needs", NEEDS, ids=str)
def test_trace_rays_needs_match_jax(needs):
    """Each output of trace_rays within FWD_TOL of JAX's; what a strip
    leaves out comes back zero on both sides (depth, normal and aux without
    need_geo, distortion without need_dist, the wet without need_wet)."""
    got = _port(needs)
    _check(got, _jax(needs))
    geo = needs[2] if len(needs) > 2 else True
    assert bool(got.dpt.any()) == geo and bool(got.aux.any()) == geo
    assert bool(got.dist.any()) == needs[0]
    assert bool(got.wet.any()) == needs[1]
    assert float(got.acc.max()) > 0.5


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True)],
                         ids=str)
def test_trace_rays_with_the_wet_hook_match_jax(needs):
    """With the wet hook (no autograd here) the forward wet is stripped:
    exact zeros on both sides, the planes unchanged."""
    got = _port(needs, hook=True)
    _check(got, _jax(needs, hook=True))
    assert not got.wet.any()


@pytest.mark.parametrize("needs", [(True, True, True), (False, False, False),
                                   (False, False, True)], ids=str)
def test_trace_rays_compose_raw_matches_jax(needs):
    """compose_raw: rgb without the background's T term, dpt not divided by
    acc, d1 / d2 filled (zeros without need_dist)."""
    got = _port(needs, compose_raw=True)
    want = _jax(needs, compose_raw=True)
    _check(got, want, OUTS + ("d1", "d2"))
    assert bool(got.d1.any()) == needs[0]
    plain = _port(needs)
    assert float((plain.rgb - got.rgb).abs().max()) > 1e-3  # bg * T


def test_trace_rays_probe_off_matches_jax():
    """probe=False: the cull keeps the candidates the direction-space probe
    would reject (more slots), the blend's result the same."""
    got = _port((True, True, True), probe=False)
    _check(got, _jax((True, True, True), probe=False))
    assert int(got.num_pairs) > int(_port((True, True, True)).num_pairs)


def test_per_slot_forward_wet_matches_the_pallas_kernel():
    """The per-slot wet of K3's plain version (the training configuration
    with need_wet) against the Pallas kernel's wet rows on the same slots,
    table and rays; and its sum over each tile's rays is the order K3 sums
    in (`_ray_sum`), which differs from a plain sum only in rounding."""
    means, quats, scales, opac, colors, active = ARRAYS
    js = prepare_trace_scene(*map(jnp.asarray, (means, quats, scales, opac,
                                                colors)), aux=jnp.asarray(AUX),
                             active=jnp.asarray(active))
    jt = jtr.build_ray_tiles(jnp.asarray(O), jnp.asarray(D))
    gidx, bounds, _ = jtr.cull_and_sort(jt, js, ttr.splat_radius3(
        ttr.TraceScene(*(torch.tensor(np.asarray(x)) for x in js))).numpy(),
                                        per_tile_cap=256)
    packed = jtr._pack_scene_table(js)

    @jax.jit
    def blend(packed, gidx, rays, bounds):
        return jtr._trace_fwd_call(pack_rows(packed)[gidx], rays, bounds, 2,
                                   True, needs=(True, True))

    jtiles, jwet = blend(packed, gidx, jt.rays, bounds)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    planes, wet = trace_blend_torch(t(packed), t(gidx), t(jt.rays),
                                    t(bounds), 2, 1, train=True, A=2,
                                    wet=True)
    n = int(bounds[-1])  # the Pallas kernel writes no slot past the tiles
    _close(wet[:n], np.asarray(jwet)[:n], "wet per slot")
    assert not wet[n:].any()
    assert float(wet.max()) > 1.0
    want = np.asarray(jtiles).reshape(1, 2, -1, 16, 16).transpose(
        2, 0, 3, 1, 4).reshape(jtiles.shape[1], 16, 32)
    _close(planes, want[:planes.shape[0]], "planes")
    x = torch.rand(5, 256, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_ray_sum(x).numpy(), x.sum(1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("needs", [(True, True), (True, False, False)],
                         ids=str)
def test_training_with_wet_gradients_match_jax(needs):
    """Autograd through trace_rays with no hook: with need_wet what
    multi-bounce tracing trains with (K3's training-with-wet configuration,
    its per-slot wet carrying no gradient, then K4); without need_geo the
    depth, normal and aux outputs are zeros whose cotangents still reach
    the backward, as in the JAX custom VJP. The gradients of a random
    weighting of every output with respect to the surfels' inputs and the
    rays within GRAD_RTOL of JAX's; the outputs as without autograd."""
    rng = np.random.default_rng(9)
    weights = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, 3)), ("dpt", (H, W)), ("acc", (H, W)),
        ("norm", (H, W, 3)), ("dist", (H, W)), ("aux", (H, W, 2)))}
    means, quats, scales, opac, colors, active = ARRAYS

    def jloss(m, q, s, op, c, a, o, d):
        scene = prepare_trace_scene(m, q, s, op, c, aux=a,
                                    active=jnp.asarray(active))
        out = jtr.trace_rays(scene, o, d, jnp.asarray(BG),
                             backend="tiled_interp", needs=needs)
        return sum(jnp.sum(getattr(out, k) * w) for k, w in weights.items())

    args = [jnp.asarray(x) for x in (means, quats, scales, opac, colors, AUX,
                                     O, D)]
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(*args)

    scene, leaves = _scene(requires_grad=True)
    o = torch.tensor(O, requires_grad=True)
    d = torch.tensor(D, requires_grad=True)
    out = ttr.trace_rays(scene, o, d, torch.tensor(BG), needs=needs)
    loss = sum(torch.sum(getattr(out, k) * torch.tensor(w))
               for k, w in weights.items())
    grads = torch.autograd.grad(loss, leaves + [o, d])
    names = ("means", "quats", "scales", "opacity", "colors", "aux",
             "ray_o", "ray_d")
    for name, g, want in zip(names, grads, jg):
        want = np.asarray(want, np.float64)
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)
    assert not out.wet.requires_grad
    _check(out, _jax(needs))
    assert bool(out.aux.any()) == (len(needs) == 2)

"""Parity of the port's rasterize with the JAX package's over its whole
switch matrix: every `needs` triple (need_dist, need_med, need_wet), with
and without the `wet_zero` hook, under `torch.no_grad` and under autograd
(JAX: a plain call and `jax.vjp`), at 32 x 32 from JAX's own prepared
splats (numpy inputs from a seed), JAX's Pallas kernels in interpret mode,
the port's plain blends on one thread (tests/torch_threads.py).

What is held: every RasterOutput field within 1e-5 (a stripped output
exactly zero where JAX's is), the forward per-splat wet within 1e-5 of its
largest, the gradients of the prepared splats' fields and of the
screen-space hook within 5e-4 of each array's largest, the per-splat wet
that arrives through the hook within the JAX package's wet budget with its
zeros where JAX's are. JAX refuses autodiff on the unaligned layout (no
per-pair wet, no hook); there the port runs the same forward outside
autograd.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_raster_needs.py
"""
import contextlib
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import raster as jraster
from envgs_tpu.ops.common import prepare_splats
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.ops import common as tcommon
from envgs_tpu_torch.ops import raster as traster
from envgs_tpu_torch.utils import camera as tcam
from torch_threads import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

H = W = 32  # 2 x 2 tiles
P, C = 100, 3
# forward: the sequential blend against the JAX closed form, last bits
ATOL = 1e-5
# gradients: per array max|d| / max|ref|, the JAX package's own budget
GRAD_RTOL = 5e-4
# the per-splat wet through the hook (tests/test_torch_train_raster.py):
# the two backward walks sum a pair's weights in another order
WET_RTOL, WET_ATOL = 1e-2, 1e-4
BG = np.array([0.2, 0.4, 0.6], np.float32)
OUTPUTS = ("rgb", "depth_expected", "alpha", "normal", "depth_median",
           "distortion", "trans", "d1", "d2", "wet")
# the outputs a loss reads (depth_median and wet carry no gradient)
DIFF = ("rgb", "depth_expected", "alpha", "normal", "distortion", "trans",
        "d1", "d2")
LEAVES = ("tmat", "center_pix", "normal", "color", "opacity")
NEEDS = list(itertools.product((False, True), repeat=3))


@functools.lru_cache(maxsize=None)
def _scene():
    """(JAX camera, port camera, JAX's prepared splats, cotangents)."""
    rng = np.random.default_rng(0)
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                            rng.random((P, 1)) * 3.0 + 1.5],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.2 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, C)).astype(np.float32)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R, T = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jc, tc = make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)
    jp = jax.jit(lambda *a: prepare_splats(*a, jc))(means, quats, scales,
                                                    opac, colors)
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (H, W, C)), ("depth_expected", (H, W)), ("alpha", (H, W)),
        ("normal", (H, W, 3)), ("distortion", (H, W)), ("trans", (H, W)),
        ("d1", (H, W)), ("d2", (H, W)))}
    return jc, tc, jp, cots


def _jax_fn(needs, hook):
    """JAX rasterize as a function of the splats' fields and both hooks ->
    the OUTPUTS tuple."""
    jc, _, jp, _ = _scene()

    def f(tmat, center_pix, normal, color, opacity, m2z, wz):
        prep = jp._replace(tmat=tmat, center_pix=center_pix, normal=normal,
                           color=color, opacity=opacity)
        out = jraster.rasterize(prep, jc, jnp.asarray(BG),
                                backend="pallas_interp", pair_cap=4096,
                                means2d_zero=m2z, needs=needs,
                                wet_zero=wz if hook else None)
        return tuple(getattr(out, k) for k in OUTPUTS)
    return f


def _jax_args():
    jp = _scene()[2]
    return tuple(getattr(jp, k) for k in LEAVES) + (
        jnp.zeros((P, 2), jnp.float32), jnp.zeros((P,), jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_plain(needs, hook):
    out = jax.jit(_jax_fn(needs, hook))(*_jax_args())
    return {k: np.asarray(v) for k, v in zip(OUTPUTS, out)}


def _jax_vjp(needs, hook):
    """(outputs, gradients of LEAVES + both hooks) of jax.vjp with the
    random cotangents of DIFF."""
    cots = _scene()[3]

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(_jax_fn(needs, hook), *args)
        ct = tuple(jnp.asarray(cots[k]) if k in cots else jnp.zeros_like(o)
                   for k, o in zip(OUTPUTS, out))
        return out, vjp(ct)

    out, grads = run(*_jax_args())
    return ({k: np.asarray(v) for k, v in zip(OUTPUTS, out)},
            [np.asarray(g) for g in grads])


def _port(needs, hook, grad):
    """The port's rasterize on the same splats, its leaves requiring
    gradients, under autograd or torch.no_grad -> (RasterOutput, leaves)."""
    _, tc, jp, _ = _scene()
    tp = tcommon.PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    leaves = [getattr(tp, k).clone().requires_grad_(True) for k in LEAVES]
    m2z = torch.zeros((P, 2), requires_grad=True)
    wz = torch.zeros(P, requires_grad=True) if hook else None
    tp = tp._replace(**dict(zip(LEAVES, leaves)))
    with contextlib.nullcontext() if grad else torch.no_grad():
        out = traster.rasterize(tp, tc, torch.tensor(BG), pair_cap=4096,
                                means2d_zero=m2z, needs=needs, wet_zero=wz)
    return out, leaves + [m2z] + ([wz] if hook else [])


def _check_outputs(tout, want, needs, hook, grad):
    for k in OUTPUTS:
        got = getattr(tout, k).detach().numpy()
        if k == "wet":
            np.testing.assert_allclose(
                got, want[k], atol=ATOL * max(np.abs(want[k]).max(), 1.0),
                err_msg=k)
        else:
            np.testing.assert_allclose(got, want[k], atol=ATOL, err_msg=k)
        if not want[k].any():  # a stripped output: exact zeros
            assert not got.any(), k
    need_dist, need_med, need_wet = needs
    aligned = need_wet or hook
    # what JAX strips: the distortion without need_dist (an aligned call
    # under autodiff computes it), the median without need_med, the
    # forward wet without need_wet or with the hook
    assert want["distortion"].any() == (need_dist or (grad and aligned))
    assert want["d1"].any() == want["distortion"].any()
    assert want["depth_median"].any() == need_med
    assert want["wet"].any() == (need_wet and not hook)
    assert float(want["alpha"].max()) > 0.9  # some pixels saturate
    assert not tout.depth_median.requires_grad
    assert not tout.wet.requires_grad


@pytest.mark.parametrize("hook", [False, True], ids=["no_hook", "hook"])
@pytest.mark.parametrize("needs", NEEDS,
                         ids=["".join("DMW"[i] if n else "-"
                                      for i, n in enumerate(needs))
                              for needs in NEEDS])
def test_needs_without_grad_match_jax(needs, hook):
    """Under torch.no_grad (JAX: a plain call): the blend runs exactly the
    configuration asked for, on the layout the wet or the hook asks for."""
    tout, _ = _port(needs, hook, grad=False)
    _check_outputs(tout, _jax_plain(needs, hook), needs, hook, grad=False)
    assert not tout.rgb.requires_grad


@pytest.mark.parametrize("hook", [False, True], ids=["no_hook", "hook"])
@pytest.mark.parametrize("needs", NEEDS,
                         ids=["".join("DMW"[i] if n else "-"
                                      for i, n in enumerate(needs))
                              for needs in NEEDS])
def test_needs_under_autograd_match_jax(needs, hook):
    """Under autograd (JAX: jax.vjp). Aligned (the wet or the hook): the
    outputs of the VJP's forward (the distortion on whatever need_dist
    says) and the gradients of every splat field and of both hooks.
    Unaligned: JAX refuses autodiff; the port's forward is the plain
    call's, outside autograd."""
    aligned = needs[2] or hook
    tout, leaves = _port(needs, hook, grad=True)
    if not aligned:
        with pytest.raises(AssertionError, match="aligned"):
            _jax_vjp(needs, hook)
        _check_outputs(tout, _jax_plain(needs, hook), needs, hook,
                       grad=False)
        assert not tout.rgb.requires_grad
        return
    want, jgrads = _jax_vjp(needs, hook)
    _check_outputs(tout, want, needs, hook, grad=True)
    cots = _scene()[3]
    loss = sum(torch.sum(getattr(tout, k) * torch.tensor(cots[k]))
               for k in DIFF)
    grads = torch.autograd.grad(loss, leaves)
    for name, got, jg in zip(LEAVES + ("means2d_zero",), grads, jgrads):
        got = got.numpy()
        scale = np.abs(jg).max()
        assert scale > 0 and np.all(np.isfinite(got)), name
        np.testing.assert_allclose(got / scale, jg / scale, atol=GRAD_RTOL,
                                   err_msg=name)
    if hook:  # the per-splat wet, as the hook's gradient
        wet, jwet = grads[-1].numpy(), jgrads[-1]
        np.testing.assert_allclose(wet, jwet, rtol=WET_RTOL, atol=WET_ATOL)
        np.testing.assert_array_equal(wet == 0, jwet == 0)
        assert (jwet > 0).sum() > P // 4

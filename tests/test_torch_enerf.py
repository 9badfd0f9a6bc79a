"""The port's ENeRF family (models/enerf.py) against the JAX package's,
from JAX's own weights carried across (enerf_params_from_jax, the
convolutions in JAX's HWIO / DHWIO layout): the encoder at even and odd
sizes (XLA's SAME padding of a stride-2 convolution is (0, 1) on an even
size, (1, 1) on an odd one), the bilinear sampler, the variance cost volume
(fewer than two observing views: the constant 10), depth_regression,
_ibr_render, render_enerf at 32 x 48 with n_planes (8, 4), and one step's
loss and gradients with the level-0 supervision. Forward at 1e-5 of each
output's largest (what lies behind the depth softmax: SOFTMAX_RTOL),
gradients at 5e-4 of each leaf's largest."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import enerf as je
from envgs_tpu.utils.camera import Camera as JCamera
from envgs_tpu_torch.models import enerf as te
from envgs_tpu_torch.utils.camera import Camera as TCamera

FWD_RTOL = 1e-5
# behind the depth softmax: the positive cost-head init over the volume
# (the constant 10 where fewer than 2 views see a point) makes logits of
# about 2e3; the 3D convolutions sum them in float32 in another order than
# XLA (6e-4 absolute, 3e-7 of their largest, on this test's inputs; the
# logits themselves are held to FWD_RTOL), and the softmax turns an
# absolute logit difference into a relative move of its weights of the same
# size: depth, its spread and the renders are held to 1e-4 of their largest
SOFTMAX_RTOL = 1e-4
GRAD_RTOL = 5e-4
# the cost regularizers' gradients come back through that softmax: the
# port's own float32 gradients of them differ from its float64 ones by up
# to 1.5e-4 of their largest (the test's inputs), JAX's float32 adds its
# own rounding; they are held to this (the other leaves to GRAD_RTOL)
SOFTMAX_GRAD_RTOL = 2e-3
# a leaf whose exact gradient is a difference across the sources (the blend
# logits' head: the softmax over the sources is blind to a shift, so the
# sources' terms cancel) keeps the rounding of the terms, not of the
# difference: its scale is at least this share of the step's largest
# gradient
GRAD_SCALE_FLOOR = 1e-2
H, W = 32, 48
NEAR, FAR = 1.0, 6.0
SMALL = dict(n_planes=(8, 4), n_samples=3, cost_dim=4, ibr_hidden=8,
             feat_dims=(4, 6))


def _close(got, want, rtol, name, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), floor, 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, (name, err, scale)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jcfg = je.ENeRFConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    je.init_enerf(jcfg, jax.random.PRNGKey(0)))
    tcfg = te.ENeRFConfig(**cfg)
    return jcfg, params, tcfg, te.enerf_params_from_jax(params, tcfg)


def _cam_arrays(x, h=H, w=W):
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    a = 0.15 * x
    R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                  [np.sin(a), 0, np.cos(a)]], np.float32)
    c = np.array([x, 0.05 * x, -3.0], np.float32)  # centre; looks along +z
    return K, R, (-R @ c).astype(np.float32)


def _cams(xs, h=H, w=W):
    arrs = [_cam_arrays(x, h, w) for x in xs]
    return ([JCamera(h, w, *map(jnp.asarray, a)) for a in arrs],
            [TCamera(h, w, *map(_t, a)) for a in arrs], arrs)


def _images(n, seed=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    # smooth images: a few random sinusoids, so the cost volume has a match
    yy, xx = np.mgrid[0:h, 0:w] / 8.0
    out = []
    for _ in range(n):
        f = rng.uniform(0.5, 2.0, (3, 2))
        p = rng.uniform(0, 6, 3)
        out.append(np.stack([0.5 + 0.4 * np.sin(f[c, 0] * xx + f[c, 1] * yy
                                                + p[c]) for c in range(3)],
                            -1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("h,w", [(32, 48), (31, 45), (30, 17)])
def test_feature_net_same_padding(h, w):
    jcfg, params, tcfg, net = _pair()
    imgs = _images(2, h=h, w=w)
    want = je.feature_net(params, jnp.asarray(imgs))
    c = [np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
         for x in want]
    jg = jax.grad(lambda p: sum(jnp.sum(f * ci) for f, ci in zip(
        je.feature_net(p, jnp.asarray(imgs)), c)))(params)
    got = te.feature_net(net, _t(imgs))
    for g, wnt in zip(got, want):
        _close(g.detach().numpy(), wnt, FWD_RTOL, "features")
    sum((g * _t(ci)).sum() for g, ci in zip(got, c)).backward()
    for k in ("fe0", "fe0b", "fe1", "fe1b"):
        for i in range(2):
            _close(net[k][i].grad.numpy(), jg[k][i], GRAD_RTOL, f"{k}[{i}]")


def test_bilinear_outside_and_edges():
    img = np.random.default_rng(3).normal(size=(7, 9, 2)).astype(np.float32)
    x = np.array([-1.5, -0.2, 0.0, 0.3, 4.5, 7.999, 8.0, 8.2, 30.0, -40.0],
                 np.float32)
    y = np.array([0.0, 3.3, 6.0, 5.9, 2.2, 1.0, 6.0, 0.5, 3.0, 3.0],
                 np.float32)
    want = je._bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    got = te._bilinear(_t(img), _t(x), _t(y))
    _close(got.numpy(), want, FWD_RTOL, "samples")


@pytest.mark.parametrize("n_src,xs", [(2, (-0.4, 0.5)), (1, (0.3,))])
def test_cost_volume_and_depth_regression(n_src, xs):
    """Two sources: the masked variance; one source: every hypothesis
    observed by fewer than 2 views costs the constant 10."""
    jcfg, params, tcfg, net = _pair()
    jc, tc, _ = _cams(xs)
    jt, tt, _ = _cams((0.0,))
    feat = np.random.default_rng(4).normal(size=(n_src, H // 4, W // 4, 6)
                                           ).astype(np.float32)
    t = np.linspace(0, 1, 8, dtype=np.float32)
    dh = (1.0 / (1.0 / NEAR * (1 - t) + 1.0 / FAR * t))[:, None, None]
    want = je.cost_volume(jnp.asarray(feat), jc, jt[0], jnp.asarray(dh), 0.25)
    got = te.cost_volume(_t(feat), tc, tt[0], _t(dh), 0.25)
    _close(got.numpy(), want, FWD_RTOL, "volume")
    if n_src == 1:
        assert (got == 10.0).all()
    jl = je._conv3(jax.nn.relu(je._conv3(want[None], params["cr0a"])),
                   params["cr0b"])
    tl = te._conv3(torch.relu(te._conv3(got[None], net["cr0a"])),
                   net["cr0b"])
    _close(tl.detach().numpy(), jl, FWD_RTOL, "logits")
    jd = je.depth_regression(params, ("cr0a", "cr0b"), want, jnp.asarray(dh))
    td = te.depth_regression(net, ("cr0a", "cr0b"), got, _t(dh))
    for g, w, name in zip(td, jd, ("depth", "std")):
        _close(g.detach().numpy(), w, SOFTMAX_RTOL, name)


def test_upsample():
    img = np.arange(5 * 7, dtype=np.float32).reshape(5, 7)
    for Ho, Wo in ((20, 28), (11, 13)):
        np.testing.assert_array_equal(
            te._upsample(_t(img), Ho, Wo).numpy(),
            np.asarray(je._upsample(jnp.asarray(img), Ho, Wo)))


def _scene(seed=5):
    jc, tc, arrs = _cams((-0.5, 0.45, 0.0))
    imgs = _images(3, seed)
    return jc, tc, arrs, imgs


def test_ibr_render():
    jcfg, params, tcfg, net = _pair()
    jc, tc, _, imgs = _scene()
    f0 = np.random.default_rng(6).normal(size=(2, H // 2, W // 2, 4)).astype(
        np.float32)
    rng = np.random.default_rng(7)
    depth = rng.uniform(2.5, 3.5, (H // 2, W // 2)).astype(np.float32)
    std = rng.uniform(0.05, 0.3, (H // 2, W // 2)).astype(np.float32)
    want = je._ibr_render(jcfg, params, jc[2], jnp.asarray(imgs[:2]), jc[:2],
                          jnp.asarray(f0), jnp.asarray(depth),
                          jnp.asarray(std), NEAR, FAR, 0.5)
    got = te._ibr_render(tcfg, net, tc[2], _t(imgs[:2]), tc[:2], _t(f0),
                         _t(depth), _t(std), NEAR, FAR, 0.5)
    for k in ("rgb_map", "dpt_map", "acc_map", "weights"):
        _close(got[k].detach().numpy(), want[k], FWD_RTOL, k)


@pytest.mark.parametrize("coarse", [False, True])
def test_render_enerf(coarse):
    jcfg, params, tcfg, net = _pair()
    jc, tc, _, imgs = _scene()
    want = je.render_enerf(jcfg, params, jc[2], jnp.asarray(imgs[:2]),
                           jc[:2], NEAR, FAR, render_coarse=coarse)
    with torch.no_grad():
        got = te.render_enerf(tcfg, net, tc[2], _t(imgs[:2]), tc[:2], NEAR,
                              FAR, render_coarse=coarse)
    for k in want._fields:
        if getattr(want, k) is None:
            assert getattr(got, k) is None
            continue
        _close(getattr(got, k).numpy(), getattr(want, k), SOFTMAX_RTOL, k)


def test_step_gradients():
    from envgs_tpu_torch.train.families import tree_flatten
    from envgs_tpu_torch.train.optax_adam import adam_init

    jcfg, params, tcfg, net = _pair()
    jc, tc, arrs, imgs = _scene(8)
    target = imgs[2]
    Ks, Rs, Ts = (np.stack([a[i] for a in arrs[:2]]) for i in range(3))

    def loss_fn(p):
        out = je.render_enerf(jcfg, p, jc[2], jnp.asarray(imgs[:2]), jc[:2],
                              NEAR, FAR, render_coarse=True)
        loss = jnp.mean((out.rgb_map - target) ** 2)
        h0, w0 = out.rgb_coarse.shape[:2]
        return loss + 0.5 * jnp.mean(
            (out.rgb_coarse - target[: h0 * 4: 4, : w0 * 4: 4]) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    _, step = te.make_enerf_train_step(tcfg, tc[2], 2, NEAR, FAR, 5e-4)
    out = {}
    _, info = step(net, adam_init(tree_flatten(net.jax_params())),
                   *map(_t, arrs[2]), _t(imgs[:2]), _t(Ks), _t(Rs), _t(Ts),
                   _t(target), grads_out=out)
    np.testing.assert_allclose(float(info["loss"]), float(loss),
                               rtol=FWD_RTOL)
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(grads)[0])
    want = [np.asarray(x) for x in leaves]
    assert len(out["grads"]) == len(want) == 30
    floor = GRAD_SCALE_FLOOR * max(np.abs(w).max() for w in want)
    for path, g, w in zip(paths, out["grads"], want):
        name = jax.tree_util.keystr(path)
        rtol = SOFTMAX_GRAD_RTOL if name.startswith("['cr") else GRAD_RTOL
        _close(g.numpy(), w, rtol, name, floor)

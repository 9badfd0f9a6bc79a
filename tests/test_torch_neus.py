"""The port's NeuS family (models/neus.py) against the JAX package's, from
JAX's own weights carried across (neus_params_from_jax): the SDF and its
autograd normals against `jax.grad`, the section-CDF opacity,
render_rays_neus in evaluation and with JAX's own draw, and one step's
loss and gradients with the eikonal term (a second-order gradient: the
normals are a gradient inside the loss), Adam held apart. Forward at 1e-5
of each output's largest, gradients at 5e-4 of each leaf's largest, Adam
at 1e-6. Sample points stay off the origin (the norm's gradient at 0 is
NaN in JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import neus as jn
from envgs_tpu_torch.models import neus as tn
from envgs_tpu_torch.train.families import tree_flatten

FWD_RTOL = 1e-5
GRAD_RTOL = 5e-4
ADAM_RTOL = 1e-6
P = 20
NEAR, FAR = 0.5, 4.0
SMALL = dict(xyz_freqs=3, dir_freqs=2, width=16, depth=4, feat_dim=6,
             color_width=8, n_samples=10)


def _close(got, want, rtol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, (name, err, scale)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jcfg = jn.NeusConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jcfg.init(jax.random.PRNGKey(0)))
    tcfg = tn.NeusConfig(**cfg)
    return jcfg, params, tcfg, tn.neus_params_from_jax(params, tcfg)


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(P, 3)).astype(np.float32) * 0.1
    o[:, 2] -= 2.0
    d = rng.normal(size=(P, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full((P,), NEAR, np.float32)
    far = np.full((P,), FAR, np.float32)
    return o, d, near, far


def test_sdf_and_grad():
    jcfg, params, tcfg, net = _pair()
    x = (np.random.default_rng(1).uniform(0.2, 1.0, (30, 3)) * np.sign(
        np.random.default_rng(2).normal(size=(30, 3)))).astype(np.float32)
    jsdf, _ = jn.sdf_fn(jcfg, params, jnp.asarray(x))
    jg = jn.sdf_grad(jcfg, params, jnp.asarray(x))
    sdf, _ = tn.sdf_fn(tcfg, net, _t(x))
    _close(sdf.detach().numpy(), jsdf, FWD_RTOL, "sdf")
    g = tn.sdf_grad(tcfg, net, _t(x))
    _close(g.detach().numpy(), jg, FWD_RTOL, "grad")
    # and the gradient of the gradient (the eikonal's path to the weights)
    c = np.random.default_rng(3).normal(size=jg.shape).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jn.sdf_grad(jcfg, p, jnp.asarray(x))
                                      * c))(params)
    (g * _t(c)).sum().backward()
    leaves = tree_flatten(net.jax_params())
    for i, (p, w) in enumerate(zip(leaves, jax.tree_util.tree_leaves(want))):
        gp = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(gp.numpy(), w, GRAD_RTOL, f"leaf {i}")


def test_neus_alpha():
    rng = np.random.default_rng(4)
    sdf = rng.normal(size=(P, 10)).astype(np.float32)
    sdf[:3] = 5.0  # saturated: a difference of exactly 0 at the clip
    inv_s = np.float32(np.exp(3.0))
    c = rng.normal(size=(P, 9)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jn.neus_alpha(s, inv_s), jnp.asarray(sdf))
    gw, = vjp(jnp.asarray(c))
    ts = _t(sdf).requires_grad_()
    got = tn.neus_alpha(ts, torch.tensor(inv_s))
    _close(got.detach().numpy(), want, FWD_RTOL, "alpha")
    (got * _t(c)).sum().backward()
    _close(ts.grad.numpy(), gw, GRAD_RTOL, "d sdf")


@pytest.mark.parametrize("draws", [False, True])
def test_render_rays_neus(draws):
    jcfg, params, tcfg, net = _pair(bg_brightness=0.2)
    o, d, near, far = _rays()
    key = jax.random.PRNGKey(5) if draws else None
    want = jn.render_rays_neus(jcfg, params, *map(jnp.asarray,
                                                  (o, d, near, far)), key)
    u = _t(jax.random.uniform(key, (P, jcfg.n_samples))) if draws else None
    with torch.no_grad():
        got = tn.render_rays_neus(tcfg, net, *map(_t, (o, d, near, far)),
                                  u=u)
    for k in ("rgb_map", "dpt_map", "acc_map", "normal_map", "eikonal",
              "sdf_vals", "inv_s"):
        _close(got[k].numpy(), want[k], FWD_RTOL, k)


def test_step_with_eikonal():
    import optax

    jcfg, params, tcfg, net = _pair(eikonal_weight=0.5)
    o, d, near, far = _rays(1)
    target = np.random.default_rng(6).uniform(0, 1, (P, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    jin = [jnp.asarray(x) for x in (o, d, near, far, target)]

    def loss_fn(p):
        out = jn.render_rays_neus(jcfg, p, *jin[:4], key)
        return (jnp.mean((out["rgb_map"] - jin[4]) ** 2)
                + jcfg.eikonal_weight * out["eikonal"])

    loss, grads = jax.value_and_grad(loss_fn)(params)
    init, jstep = jn.make_neus_train_step(jcfg, 5e-3)
    opt = optax.adam(5e-3)
    _, _, aux = jstep(params, opt.init(params), *jin, key)

    _, step = tn.make_neus_train_step(tcfg, 5e-3)
    from envgs_tpu_torch.train.optax_adam import adam_init

    state = adam_init(tree_flatten(net.jax_params()))
    out = {}
    state, info = step(net, state, *map(_t, (o, d, near, far, target)),
                       u=_t(jax.random.uniform(key, (P, jcfg.n_samples))),
                       grads_out=out)
    np.testing.assert_allclose(float(info["loss"]), float(loss),
                               rtol=FWD_RTOL)
    np.testing.assert_allclose(float(info["eikonal"]), float(aux["eikonal"]),
                               rtol=FWD_RTOL)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
    assert len(out["grads"]) == len(want)
    for i, (g, w) in enumerate(zip(out["grads"], want)):
        _close(g.numpy(), w, GRAD_RTOL, f"grad leaf {i}")
    # the eikonal term's share of the gradient is not negligible: the step
    # without it moves the SDF head's weights differently
    no_eik = jax.grad(lambda p: loss_fn(p) - jcfg.eikonal_weight
                      * jn.render_rays_neus(jcfg, p, *jin[:4], key)[
                          "eikonal"])(params)
    w0 = np.asarray(jax.tree_util.tree_leaves(no_eik)[-2])
    assert np.abs(want[-2] - w0).max() > 1e-2 * np.abs(want[-2]).max()
    # Adam apart: the port's update on JAX's gradients gives optax's
    upd, _ = opt.update(grads, opt.init(params), params)
    jp = optax.apply_updates(params, upd)
    flat = tree_flatten(tn.neus_params_from_jax(params, tcfg).jax_params())
    from envgs_tpu_torch.train.optax_adam import adam_update

    adam_update(flat, [_t(w) for w in want], adam_init(flat), 5e-3)
    for p, w, p0 in zip(flat, jax.tree_util.tree_leaves(jp),
                        jax.tree_util.tree_leaves(params)):
        move = np.abs(np.asarray(w) - np.asarray(p0)).max()
        tol = ADAM_RTOL * move + np.abs(np.asarray(w)).max() * 2 ** -23
        assert np.abs(p.detach().numpy() - np.asarray(w)).max() <= tol

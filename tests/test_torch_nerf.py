"""The port's NeRF family (models/nerf.py) against the JAX package's, from
JAX's own weights carried across (nerf_params_from_jax): the samplers with
and without draws (ties between the draws and the CDF's entries), the
compositing, render_rays_nerf in evaluation and with JAX's own draws (the
key splits of envgs_tpu/models/nerf.py::render_rays_nerf), with
separate_levels and the SH direction encoding, one step's loss and
gradients through the importance samples (not detached: the coarse
network's weights get a gradient through the fine samples' positions), and
optax's Adam held apart. Forward at 1e-5 of each output's largest,
gradients at 5e-4 of each leaf's largest, Adam at 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import nerf as jn
from envgs_tpu_torch.models import nerf as tn
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import AdamState, adam_update

FWD_RTOL = 1e-5
GRAD_RTOL = 5e-4
# a leaf of rounding size in an exact-zero direction: see test_torch_zoo.py
GRAD_SCALE_FLOOR = 1e-3
ADAM_RTOL = 1e-6
P = 24  # rays
NEAR, FAR = 0.5, 4.0
SMALL = dict(xyz_freqs=4, dir_freqs=2, width=16, depth=5, feat_dim=8,
             n_samples=(8, 12))


def _close(got, want, rtol, name, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), floor, 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, (name, err, scale)


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(P, 3)).astype(np.float32) * 0.1
    o[:, 2] -= 2.0
    d = rng.normal(size=(P, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _nf():
    return np.full((P,), NEAR, np.float32), np.full((P,), FAR, np.float32)


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jcfg = jn.NerfConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jcfg.init(jax.random.PRNGKey(0)))
    tcfg = tn.NerfConfig(**cfg)
    return jcfg, params, tcfg, tn.nerf_params_from_jax(params, tcfg)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("draws", [False, True])
@pytest.mark.parametrize("use_disparity", [False, True])
def test_uniform_z_vals(draws, use_disparity):
    near, far = _nf()
    key = jax.random.PRNGKey(3) if draws else None
    want = jn.uniform_z_vals(jnp.asarray(near), jnp.asarray(far), 10, key,
                             use_disparity)
    u = jax.random.uniform(key, (P, 10)) if draws else None
    got = tn.uniform_z_vals(_t(near), _t(far), 10,
                            use_disparity=use_disparity,
                            u=None if u is None else _t(u))
    _close(got.numpy(), want, FWD_RTOL, "z")


def _cdf_jax(w, eps=1e-5):
    """JAX's CDF of importance_z_vals (its own operations)."""
    w = w[..., 1:-1] + eps
    cdf = jnp.cumsum(w, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], -1)
    return cdf / jnp.maximum(cdf[..., -1:], eps)


def _importance_with_draws(z, w, n, u, eps):
    """The body of JAX's importance_z_vals with its draws handed in (the
    function itself draws from a key)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    cdf = _cdf_jax(w, eps)
    idx = jnp.sum((cdf[..., None, :] <= u[..., :, None]).astype(
        jnp.int32), -1) - 1
    idx = jnp.clip(idx, 0, cdf.shape[-1] - 2)
    c0 = jnp.take_along_axis(cdf, idx, -1)
    c1 = jnp.take_along_axis(cdf, idx + 1, -1)
    m0 = jnp.take_along_axis(mids, idx, -1)
    m1 = jnp.take_along_axis(mids, jnp.clip(idx + 1, 0, mids.shape[-1] - 1),
                             -1)
    t = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, eps), 0.5)
    return jnp.sort(m0 + t * (m1 - m0), axis=-1)


@pytest.mark.parametrize("mode", ["eval", "draws", "ties"])
def test_importance_z_vals(mode):
    """Evaluation (an even grid of the CDF), JAX's own draws (its function
    under a key, the port fed that key's uniform draw), and draws that sit
    exactly on CDF entries, flat stretches among them (the bin is the
    count of entries <= u, less 1: searchsorted to the right). A draw on an
    entry meets the entry exactly only if both packages compute the same
    CDF: the ties case takes eps = 0 and interior weights in eighths that
    sum to 1, so that every sum and the normalization are exact."""
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(NEAR, FAR, (P, 9)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (P, 9)).astype(np.float32)
    w[:, 3:5] = 0.0  # near-flat stretches of the CDF
    n = 7
    u = None
    eps = 1e-5
    if mode == "eval":
        def jfn(z, w):
            return jn.importance_z_vals(z, w, n)
    elif mode == "draws":
        key = jax.random.PRNGKey(5)
        u = np.asarray(jax.random.uniform(key, (P, n)))

        def jfn(z, w):
            return jn.importance_z_vals(z, w, n, key)
    else:
        eps = 0.0
        w[:, 1:-1] = rng.multinomial(8, [1 / 7] * 7, size=P) / 8.0
        cdf = np.asarray(_cdf_jax(jnp.asarray(w), eps))
        u = np.stack([cdf[:, k] for k in (0, 1, 3, 4, 5, 6, 7)], -1)
        assert (np.diff(cdf, axis=-1) == 0).any()  # flat stretches

        def jfn(z, w):
            return _importance_with_draws(z, w, n, jnp.asarray(u), eps)

    c = rng.normal(size=(P, n)).astype(np.float32)
    want, vjp = jax.vjp(jfn, jnp.asarray(z), jnp.asarray(w))
    gz, gw = vjp(jnp.asarray(c))
    tz, tw = _t(z).requires_grad_(), _t(w).requires_grad_()
    got = tn.importance_z_vals(tz, tw, n, eps=eps,
                               u=None if u is None else _t(u))
    _close(got.detach().numpy(), want, FWD_RTOL, "z")
    (got * _t(c)).sum().backward()
    _close(tz.grad.numpy(), gz, GRAD_RTOL, "dz")
    if eps:  # (with eps = 0 a flat bin divides by 0: NaN in both packages)
        _close(tw.grad.numpy(), gw, GRAD_RTOL, "dw")
    else:
        assert np.isnan(tw.grad.numpy()).any() and np.isnan(gw).any()


def test_volume_render():
    rng = np.random.default_rng(8)
    rgb = rng.uniform(0, 1, (P, 9, 3)).astype(np.float32)
    sigma = rng.uniform(0, 3, (P, 9)).astype(np.float32)
    z = np.sort(rng.uniform(NEAR, FAR, (P, 9)), -1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (P,)).astype(np.float32)

    def jfn(rgb, sigma, z):
        o = jn.volume_render(rgb, sigma, z, scale, 0.3)
        return jnp.concatenate([o["rgb_map"], o["dpt_map"][:, None],
                                o["acc_map"][:, None], o["weights"]], -1)

    c = rng.normal(size=(P, 14)).astype(np.float32)
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (rgb, sigma, z)))
    grads = vjp(jnp.asarray(c))
    tin = [_t(x).requires_grad_() for x in (rgb, sigma, z)]
    o = tn.volume_render(*tin, _t(scale), 0.3)
    got = torch.cat([o["rgb_map"], o["dpt_map"][:, None],
                     o["acc_map"][:, None], o["weights"]], -1)
    _close(got.detach().numpy(), want, FWD_RTOL, "maps")
    (got * _t(c)).sum().backward()
    for x, g, name in zip(tin, grads, ("rgb", "sigma", "z")):
        _close(x.grad.numpy(), g, GRAD_RTOL, name)


def _jax_draws(cfg, key):
    """The uniform draws of JAX's render_rays_nerf under `key`: one split
    a round, (P, n) each."""
    out = []
    for n in cfg.n_samples:
        key, k = jax.random.split(key)
        out.append(_t(jax.random.uniform(k, (P, n))))
    return out


CONFIGS = [dict(), dict(separate_levels=True),
           dict(dir_encoding="sh", sh_dir_degree=3),
           dict(use_disparity=True, bg_brightness=0.5)]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("draws", [False, True])
def test_render_rays_nerf(kw, draws):
    jcfg, params, tcfg, nets = _pair(**kw)
    o, d = _rays()
    near, far = _nf()
    key = jax.random.PRNGKey(9) if draws else None
    want = jn.render_rays_nerf(jcfg, params, *map(jnp.asarray,
                                                  (o, d, near, far)), key)
    with torch.no_grad():
        got = tn.render_rays_nerf(tcfg, nets, *map(_t, (o, d, near, far)),
                                  draws=_jax_draws(jcfg, key) if draws
                                  else None)
    for r in range(len(jcfg.n_samples)):
        for k in ("rgb_map", "dpt_map", "acc_map", "weights"):
            _close(got[f"round{r}"][k].numpy(), want[f"round{r}"][k],
                   FWD_RTOL, f"round{r} {k}")
    _close(got["rgb_map"].numpy(), want["rgb_map"], FWD_RTOL, "rgb_map")


def _jax_step_parts(jcfg, params, o, d, near, far, target, key, lr):
    def loss_fn(p):
        out = jn.render_rays_nerf(jcfg, p, o, d, near, far, key)
        return sum(jnp.mean((out[f"round{r}"]["rgb_map"] - target) ** 2)
                   for r in range(len(jcfg.n_samples)))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    init, step = jn.make_nerf_train_step(jcfg, lr)
    import optax

    opt_state = optax.adam(lr).init(params)
    new_params, new_state, aux = step(params, opt_state, o, d, near, far,
                                      target, key)
    return loss, grads, opt_state, new_params, new_state, aux


@pytest.mark.parametrize("kw", [dict(), dict(separate_levels=True)])
def test_step_through_importance_samples(kw):
    jcfg, params, tcfg, nets = _pair(**kw)
    o, d = _rays(1)
    near, far = _nf()
    target = np.random.default_rng(10).uniform(0, 1, (P, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    lr = 5e-3
    jin = [jnp.asarray(x) for x in (o, d, near, far, target)]
    loss, grads, _, new_params, new_state, aux = _jax_step_parts(
        jcfg, params, *jin, key, lr)
    init, step = tn.make_nerf_train_step(tcfg, lr)
    _, state = init(device="cpu")
    out = {}
    state, info = step(nets, state, *map(_t, (o, d, near, far, target)),
                       draws=_jax_draws(jcfg, key), grads_out=out)
    np.testing.assert_allclose(float(info["loss"]), float(loss),
                               rtol=FWD_RTOL)
    np.testing.assert_allclose(float(info["psnr"]), float(aux["psnr"]),
                               rtol=FWD_RTOL)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
    assert len(want) == len(out["grads"])
    floor = GRAD_SCALE_FLOOR * max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(out["grads"], want)):
        _close(g.numpy(), w, GRAD_RTOL, f"grad leaf {i}", floor)
    if kw.get("separate_levels"):
        # the coarse network also feeds the fine round through the
        # importance samples' positions: its gradient is not the round-0
        # loss's alone
        def coarse_only(p):
            out0 = jn.render_rays_nerf(
                jcfg._replace(n_samples=jcfg.n_samples[:1]), p[:1], *jin[:4],
                key)
            return jnp.mean((out0["rgb_map"] - jin[4]) ** 2)

        g0 = jax.grad(coarse_only)(params)
        w0 = np.asarray(jax.tree_util.tree_leaves(g0)[0])
        assert np.abs(want[0] - w0).max() > 1e-3 * np.abs(want[0]).max()


def test_adam_apart():
    """optax.adam on JAX's gradients against the port's written-out Adam on
    the same gradients, from JAX's optax state after one update."""
    import optax

    jcfg, params, tcfg, nets = _pair()
    rng = np.random.default_rng(12)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        params)
    opt = optax.adam(5e-4)
    st = opt.init(params)
    upd, st = opt.update(grads, st, params)
    p1 = optax.apply_updates(params, upd)
    upd, st2 = opt.update(grads, st, p1)
    p2 = optax.apply_updates(p1, upd)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]
    n = len(jax.tree_util.tree_leaves(params))
    state = AdamState(_t(leaves[0]), [_t(x) for x in leaves[1:1 + n]],
                      [_t(x) for x in leaves[1 + n:]])
    tn_ = tn.nerf_params_from_jax(jax.tree_util.tree_map(np.asarray, p1),
                                  tcfg)
    flat = tree_flatten(tn_.jax_params())
    state = adam_update(flat, [_t(g) for g in jax.tree_util.tree_leaves(
        grads)], state, 5e-4)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(p2)]
    move = [np.asarray(b) - np.asarray(a) for a, b in zip(
        jax.tree_util.tree_leaves(p1), want)]
    for p, w, m in zip(flat, want, move):
        # one float32 rounding of the values beside the move's size
        tol = ADAM_RTOL * np.abs(m).max() + np.abs(w).max() * 2 ** -23
        assert np.abs(p.detach().numpy() - w).max() <= tol
    wst = [np.asarray(x) for x in jax.tree_util.tree_leaves(st2)]
    got = [state.count.numpy(), *[m.numpy() for m in state.mu],
           *[v.numpy() for v in state.nu]]
    np.testing.assert_array_equal(got[0], wst[0])
    for g, w in zip(got[1:], wst[1:]):
        _close(g, w, ADAM_RTOL, "moment")


def test_chunkify_matches_jax():
    """utils/chunk.py::chunkify against the JAX package's: a render of
    P = 24 rays in chunks of 10 (the last zero-padded, then cropped), its
    dict of maps and a tuple output, as the unchunked render (matmuls of
    another batch size: last bits)."""
    from envgs_tpu.utils.chunk import chunkify as jchunkify
    from envgs_tpu_torch.utils.chunk import chunkify

    jcfg, params, tcfg, nets = _pair()
    o, d = _rays(2)
    rays = np.concatenate([o, d], -1)

    def jfn(r, nf):
        out = jn.render_rays_nerf(jcfg, params, r[:, :3], r[:, 3:],
                                  nf[0] + 0 * r[:, 0], nf[1] + 0 * r[:, 0])
        return dict(rgb=out["rgb_map"], acc=out["acc_map"]), (out["dpt_map"],)

    def tfn(r, nf):
        out = tn.render_rays_nerf(tcfg, nets, r[:, :3], r[:, 3:],
                                  nf[0] + 0 * r[:, 0], nf[1] + 0 * r[:, 0])
        return dict(rgb=out["rgb_map"], acc=out["acc_map"]), (out["dpt_map"],)

    nf = (NEAR, FAR)
    want = jchunkify(10)(jfn)(jnp.asarray(rays), nf)
    with torch.no_grad():
        got = chunkify(10)(tfn)(_t(rays), nf)
        whole = tfn(_t(rays), nf)
    for k in ("rgb", "acc"):
        assert got[0][k].shape[0] == P
        _close(got[0][k].numpy(), want[0][k], FWD_RTOL, k)
        _close(got[0][k].numpy(), whole[0][k].numpy(), FWD_RTOL, k)
    assert isinstance(got[1], tuple)
    _close(got[1][0].numpy(), want[1][0], FWD_RTOL, "dpt")

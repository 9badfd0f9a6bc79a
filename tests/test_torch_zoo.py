"""The port's embedder and regressor zoo (models/embedders.py,
models/regressors.py) against the JAX package's, from JAX's own weights
carried across (`load_jax`): every output at 1e-5 of its largest, and the
gradients of a seeded random projection of it, for every parameter leaf and
every float input, at 5e-4 of each leaf's largest. The hash grid's cells
reach 4096 a side, so its prime products wrap past 2^32. Points stay off
the origin (the norm's gradient at 0 is NaN in JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import embedders as je
from envgs_tpu.models import regressors as jr
from envgs_tpu.utils.camera import make_camera as jcamera
from envgs_tpu_torch.models import embedders as te
from envgs_tpu_torch.models import regressors as tr
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.utils.camera import make_camera as tcamera

FWD_RTOL = 1e-5  # max|d| / max|ref| of an output
GRAD_RTOL = 5e-4  # max|d| / max|ref| of a gradient leaf
# a leaf whose exact gradient is 0 or nearly (the blend logits' bias: the
# softmax over the sources is blind to a shift) holds rounding noise of the
# backward's larger terms: its scale is at least this share of the largest
# gradient of any leaf of the same backward
GRAD_SCALE_FLOOR = 1e-3


def _close(got, want, rtol, name, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), floor, 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, (name, err, scale)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check(jfn, jparams, tfn, tparams, inputs, diff=None, seed=0):
    """jfn(jparams, *inputs) against tfn(*inputs) (its parameters the
    tensors of `tparams`, a tree in JAX's leaf order): the output, and the
    gradients of sum(out * c) (c seeded N(0, 1)) for the parameters and
    the inputs marked in `diff`."""
    diff = diff or [np.issubdtype(np.asarray(x).dtype, np.floating)
                    for x in inputs]
    jin = [jnp.asarray(x) for x in inputs]
    jout = jfn(jparams, *jin)
    c = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(
        np.float32)
    argnums = tuple(i + 1 for i, d in enumerate(diff) if d)
    if jparams is not None:
        argnums = (0,) + argnums
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * c), argnums)(
        jparams, *jin) if argnums else ()

    tin = [torch.tensor(np.asarray(x), requires_grad=bool(d))
           for x, d in zip(inputs, diff)]
    leaves = tree_flatten(tparams) if tparams is not None else []
    for p in leaves:
        p.grad = None
    tout = tfn(*tin)
    _close(tout.detach().numpy(), np.asarray(jout), FWD_RTOL, "forward")
    if not argnums:
        return
    (tout * torch.tensor(c)).sum().backward()
    jg = list(jgrads)
    if jparams is not None:
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg.pop(0))]
        assert len(want) == len(leaves)
        floor = GRAD_SCALE_FLOOR * max(np.abs(w).max() for w in want)
        for i, (p, w) in enumerate(zip(leaves, want)):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            _close(g.numpy(), w, GRAD_RTOL, f"param leaf {i}", floor)
    for x, w in zip([t for t, d in zip(tin, diff) if d], jg):
        _close(x.grad.numpy(), np.asarray(w), GRAD_RTOL, "input")


def _pts(n=64, seed=1, lo=-0.9, hi=0.9):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("n_freqs,include_input,alpha", [
    (4, True, None), (6, False, None), (5, True, 2.3), (3, True, 0.0)])
def test_positional_encoding(n_freqs, include_input, alpha):
    x = _pts()
    check(lambda p, x: je.positional_encoding(x, n_freqs, include_input,
                                              alpha), None,
          lambda x: te.positional_encoding(x, n_freqs, include_input, alpha),
          None, [x])
    assert te.pe_dim(3, n_freqs, include_input) == je.pe_dim(
        3, n_freqs, include_input)


def test_hash_embedder_wraps_like_uint32():
    kw = dict(n_levels=4, n_features=2, log2_hashmap_size=10,
              base_resolution=16, finest_resolution=4096)
    jh = je.HashEmbedder(**kw)
    tables = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (
        4, 1 << 10, 2)))  # larger than the 1e-4 init: visible features
    th = te.HashEmbedder(**kw)
    th.load_jax(tables)
    x = _pts(200, lo=-1.0, hi=1.0)
    assert list(th.resolutions) == list(jh.resolutions)
    # the finest level's cells reach 4096: c * 2654435761 passes 2^32
    assert int(jh.resolutions[-1]) * 2654435761 > 2 ** 32 * 1000
    check(lambda p, x: jh(p, x), jnp.asarray(tables), lambda x: th(x),
          th.jax_params(), [x])


def test_hash_of_a_cell_equals_numpy_uint32():
    """The hashed row of a large cell: the port's int64-and-mask product
    against numpy's wrapping uint32 one."""
    th = te.HashEmbedder(n_levels=1, log2_hashmap_size=19,
                         base_resolution=4000, finest_resolution=4000)
    with torch.no_grad():
        th.tables.copy_(torch.arange(1 << 19, dtype=torch.float32)
                        [None, :, None].expand(1, -1, 2))
    cell = np.array([3999, 3001, 2777], np.uint32)
    want = (cell * np.array([1, 2654435761, 805459861], np.uint32))
    want = int((want[0] ^ want[1] ^ want[2]) % np.uint32(1 << 19))
    x = torch.tensor((cell.astype(np.float32) + 0.0) / 4000 * 2 - 1)
    # at the corner itself the trilinear weight is 1 on cell (0, 0, 0)
    got = th(x[None])[0, 0]
    assert int(got) == want


def test_latent_and_spacetime_codes():
    jl = je.LatentCodeEmbedder(5, 4)
    codes = np.asarray(jl.init(jax.random.PRNGKey(1)))
    tl = te.LatentCodeEmbedder(5, 4)
    tl.load_jax(codes)
    idx = np.array([0, 3, 3, 4], np.int32)
    check(lambda p, i: jl(p, i), jnp.asarray(codes), lambda i: tl(i),
          tl.jax_params(), [idx], diff=[False])
    js = je.SpacetimeEmbedder(n_views=3, n_frames=4, space_dim=2, time_dim=3)
    sp = _np_tree(js.init(jax.random.PRNGKey(2)))
    ts = te.SpacetimeEmbedder(n_views=3, n_frames=4, space_dim=2, time_dim=3)
    ts.load_jax(sp)
    v, t = np.array([0, 2, 1], np.int32), np.array([3, 0, 1], np.int32)
    check(lambda p, v, t: js(p, v, t), sp, lambda v, t: ts(v, t),
          ts.jax_params(), [v, t], diff=[False, False])
    assert ts.out_dim == js.out_dim


def test_composed_xyzt_empty_noop():
    x = _pts(8)
    t = np.random.default_rng(3).normal(size=(1, 4)).astype(np.float32)
    check(lambda p, x, t: je.composed_xyzt(x, t), None,
          lambda x, t: te.composed_xyzt(x, t), None, [x, t])
    assert te.empty_embedder(torch.tensor(x)).shape == (8, 0)
    assert torch.equal(te.noop_embedder(torch.tensor(x)), torch.tensor(x))
    assert te.empty_embedder(torch.tensor(x)).dtype == torch.float32


def test_deformation_embedder():
    jd = je.DeformationEmbedder(xyz_freqs=3, t_freqs=2, width=16, depth=2)
    p = _np_tree(jd.init(jax.random.PRNGKey(4)))
    # the head starts at zero (the identity warp): give it values
    p[-1] = (np.random.default_rng(5).normal(size=p[-1][0].shape).astype(
        np.float32) * 0.1, p[-1][1])
    td = te.DeformationEmbedder(xyz_freqs=3, t_freqs=2, width=16, depth=2)
    td.load_jax(p)
    t = np.random.default_rng(6).uniform(0, 1, (64,)).astype(np.float32)
    check(lambda p, x, t: jd(p, x, t), p, lambda x, t: td(x, t),
          td.jax_params(), [_pts(), t])


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_dir_encoding(degree):
    d = _pts(32, seed=7)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # degree 1 is the constant basis function: no gradient to take
    check(lambda p, d: je.sh_dir_encoding(d, degree), None,
          lambda d: te.sh_dir_encoding(d, degree), None, [d],
          diff=[degree > 1])


@pytest.mark.parametrize("normalize", [False, True])
def test_depth_embedder(normalize):
    rng = np.random.default_rng(8)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    T = rng.normal(size=3).astype(np.float32)
    K = np.eye(3, dtype=np.float32)
    xyz = _pts(40, seed=9).reshape(2, 20, 3)
    check(lambda p, x: je.depth_embedder(x, K, jnp.asarray(R),
                                         jnp.asarray(T), normalize), None,
          lambda x: te.depth_embedder(x, torch.tensor(K), torch.tensor(R),
                                      torch.tensor(T), normalize), None,
          [xyz])


def _two_cams(H=24, W=32):
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    out = []
    for x in (-0.3, 0.4):
        T = np.array([x, 0.1, 3.0], np.float32)
        out.append((K, np.eye(3, dtype=np.float32), T))
    return H, W, out


@pytest.mark.parametrize("agg", ["meanvar", "stack"])
def test_ibr_embedder(agg):
    H, W, cams = _two_cams()
    jc = [jcamera(H, W, *c) for c in cams]
    tc = [tcamera(H, W, *c) for c in cams]
    feats = np.random.default_rng(10).normal(size=(2, H, W, 5)).astype(
        np.float32)
    xyz = _pts(50, seed=11, lo=-1.2, hi=1.2)  # some outside a view
    check(lambda p, x, f: je.ibr_embedder(x, f, jc, agg), None,
          lambda x, f: te.ibr_embedder(x, f, tc, agg), None, [xyz, feats])


def _mlp_cfg(module, jcls, **kw):
    jm = jcls(**kw)
    p = _np_tree(jm.init(jax.random.PRNGKey(12)))
    tm = module(**kw)
    tm.load_jax(p)
    return jm, p, tm


def test_split_regressor():
    jm, p, tm = _mlp_cfg(tr.SplitRegressor, jr.SplitRegressor, xyz_dim=9,
                         dir_dim=5, width=16, depth=6, feat_dim=7,
                         color_width=8, color_depth=2)
    rng = np.random.default_rng(13)
    xf = rng.normal(size=(30, 9)).astype(np.float32)
    df = rng.normal(size=(30, 5)).astype(np.float32)
    check(lambda p, a, b: jnp.concatenate(
        [jm(p, a, b)[0], jm(p, a, b)[1][..., None]], -1), p,
        lambda a, b: torch.cat([tm(a, b)[0], tm(a, b)[1][..., None]], -1),
        tm.jax_params(), [xf, df])


def test_spherical_harmonics_apply_and_contract():
    rng = np.random.default_rng(14)
    sh = rng.normal(size=(20, 3, 9)).astype(np.float32) * 0.5
    d = rng.normal(size=(20, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    check(lambda p, s, d: jr.spherical_harmonics_apply(s, d, 2), None,
          lambda s, d: tr.spherical_harmonics_apply(s, d, 2), None, [sh, d])
    x = rng.normal(size=(40, 3)).astype(np.float32) * 1.5  # in and out
    check(lambda p, x: jr.contract(x, 1.2), None,
          lambda x: tr.contract(x, 1.2), None, [x])


def test_trivial_regressors():
    f = torch.ones((4, 6))
    assert tr.empty_regressor(f).shape == (4, 0)
    assert tr.noop_regressor(f) is f
    z = tr.zero_regressor(f, 5)
    assert z.shape == (4, 5) and not z.any()
    np.testing.assert_array_equal(
        np.asarray(jr.zero_regressor(jnp.ones((4, 6)), 5)), z.numpy())


@pytest.mark.parametrize("zero_canonical,t", [(False, None), (True, 0.0),
                                              (True, 0.5)])
def test_displacement_regressor(zero_canonical, t):
    jm, p, tm = _mlp_cfg(tr.DisplacementRegressor, jr.DisplacementRegressor,
                         in_dim=6, width=12, depth=3,
                         zero_canonical=zero_canonical)
    f = np.random.default_rng(15).normal(size=(25, 6)).astype(np.float32)
    check(lambda p, f: jm(p, f, t), p, lambda f: tm(f, t), tm.jax_params(),
          [f])


def test_residual_regressor():
    jm, p, tm = _mlp_cfg(tr.ResidualRegressor, jr.ResidualRegressor,
                         in_dim=6, width=12)
    f = np.random.default_rng(16).normal(size=(25, 6)).astype(np.float32)
    check(lambda p, f: jm(p, f), p, lambda f: tm(f), tm.jax_params(), [f])


@pytest.mark.parametrize("kind", ["identity", "rotation", "translation",
                                  "general"])
def test_se3_exp_rt(kind):
    rng = np.random.default_rng(17)
    s = rng.normal(size=(10, 6)).astype(np.float32) * 0.7
    if kind == "identity":
        s[:] = 0.0
    elif kind == "rotation":
        s[:, :3] = 0.0
    elif kind == "translation":
        s[:, 3:] = 0.0
    check(lambda p, s: jr.se3_exp_rt(s), None, lambda s: tr.se3_exp_rt(s),
          None, [s])
    out = tr.se3_exp_rt(torch.tensor(s)).numpy()
    if kind == "identity":
        assert not out.any()
    if kind == "translation":  # V(0) = I: the translation is v itself
        np.testing.assert_array_equal(out[:, 3:], s[:, :3])


def test_se3_regressor():
    jm, p, tm = _mlp_cfg(tr.SE3Regressor, jr.SE3Regressor, in_dim=6,
                         width=12, depth=3)
    f = np.random.default_rng(18).normal(size=(25, 6)).astype(np.float32)
    check(lambda p, f: jm(p, f), p, lambda f: tm(f), tm.jax_params(), [f])


def test_image_based_regressors():
    rng = np.random.default_rng(19)
    g = rng.normal(size=(7, 5, 4)).astype(np.float32)
    src = rng.uniform(0, 1, (3, 7, 5, 6)).astype(np.float32)
    d = rng.normal(size=(7, 5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jm, p, tm = _mlp_cfg(tr.ImageBasedRegressor, jr.ImageBasedRegressor,
                         geo_dim=4, src_dim=6, width=8)
    check(lambda p, g, s: jm(p, g, s), p, lambda g, s: tm(g, s),
          tm.jax_params(), [g, src])
    jm, p, tm = _mlp_cfg(tr.ImageBasedSphericalHarmonics,
                         jr.ImageBasedSphericalHarmonics, xyz_dim=4,
                         src_dim=6, width=8, resd_limit=0.4)
    check(lambda p, g, s, d: jm(p, g, s, d), p, lambda g, s, d: tm(g, s, d),
          tm.jax_params(), [g, src, d])

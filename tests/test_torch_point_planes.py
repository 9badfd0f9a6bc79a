"""Parity of the port's PointPlanes family (models/point_planes.py, with
models/embedders.py::KPlanesEmbedder and models/regressors.py::MLP) with
the JAX package, from JAX's own weights carried across
(point_planes_params_from_jax): the K-Planes features and their gradients,
the MLP, point_planes_forward, and one train step (the loss, every
gradient, and Adam held apart: the port's written-out optax Adam on JAX's
gradients gives JAX's parameters and moments). JAX runs its kernels in
interpret mode (pallas_interp), jitted once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import embedders as je
from envgs_tpu.models import point_planes as jpp
from envgs_tpu.models import regressors as jr
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import embedders as te
from envgs_tpu_torch.models import point_planes as tpp
from envgs_tpu_torch.models import regressors as tr
from envgs_tpu_torch.utils import camera as tcam
from torch_threads import one_thread  # noqa: F401

H = W = 40
N = 80
F = 46.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
T_CAM = np.array([0.0, 0.0, 2.0], np.float32)  # at z = -2, facing +z
TT = 1.0 / 3.0  # the frame rendered and stepped
LR = 5e-3
CFG = dict(n_frames=4, pair_cap=2 ** 12, radius_max=0.05, radius_shift=0.0,
           resd_scale=0.3, sh_deg=1)
# forward maps: the sequential blend against the JAX closed form
ATOL = 1e-5
# the loss: float32 sums over the image in another order
LOSS_RTOL = 1e-5
# gradients: per array max|d| / max|ref| (the plain backward blend and
# autograd against JAX's kernel and autodiff: sums in another order)
GRAD_RTOL = 5e-4
# Adam apart, on JAX's own gradients
ADAM_ATOL = 1e-7
ADAM_RTOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_thread")


def _cams():
    R = np.eye(3, dtype=np.float32)
    return (make_camera(H, W, K, R, T_CAM),
            tcam.make_camera(H, W, K, R, T_CAM))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params():
    """JAX's PointPlanes weights from PRNGKey(0) on a ball of N points, the
    zero displacement head replaced by small seeded values (so that every
    layer of it has a gradient)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(N, 3)) * 0.12).astype(np.float32)
    cfg = jpp.PointPlanesConfig(raster_backend="pallas_interp", **CFG)
    params = cfg.init(jax.random.PRNGKey(0), pts)
    w, b = params["resd"][-1]
    params["resd"][-1] = (jnp.asarray(rng.normal(size=w.shape) * 0.05,
                                      jnp.float32), b)
    return cfg, params


@pytest.fixture(scope="module")
def jax_run():
    """JAX's side in one jitted function: the forward at TT, the loss and
    its gradients (jax.value_and_grad of the step's loss) and one
    make_point_planes_train_step from JAX's fresh optax state."""
    jc, _ = _cams()
    cfg, params = _jax_params()
    init, step = jpp.make_point_planes_train_step(cfg, jc, lr=LR)
    _, opt = init(jax.random.PRNGKey(0), params["points"])
    target = np.random.default_rng(1).random((H, W, 3)).astype(np.float32)

    def run(p, o, gt):
        t = jnp.asarray(TT, jnp.float32)
        out = jpp.point_planes_forward(cfg, p, t, jc)

        def loss_fn(q):
            return jnp.mean((jpp.point_planes_forward(cfg, q, t, jc).rgb
                             - gt) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return out, loss, grads, step(p, o, t, jc.K, jc.R, jc.T, gt)

    out, loss, grads, (new_p, new_o, aux) = jax.jit(run)(
        params, opt, jnp.asarray(target))
    return (_np_tree(params), _np_tree(opt), target, out, float(loss),
            _np_tree(grads), _np_tree(new_p), _np_tree(new_o), aux)


def _close(got, want, rtol=GRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        name, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("n_frames", [1, 5])
def test_kplanes_matches_jax(n_frames):
    """Features of points in and out of the bounds at a scalar and at a
    per-point time, within 1e-6; the gradients of a weighted sum with
    respect to the points and to every plane within GRAD_RTOL."""
    jemb = je.KPlanesEmbedder(n_features=4, resolutions=(8, 16),
                              n_frames=n_frames, time_resolution=5,
                              bounds=((-1.0, -0.5, -1.0), (1.0, 1.0, 0.5)))
    planes = jemb.init(jax.random.PRNGKey(n_frames))
    temb = te.KPlanesEmbedder(n_features=4, resolutions=(8, 16),
                              n_frames=n_frames, time_resolution=5,
                              bounds=jemb.bounds)
    assert set(temb.planes) == set(planes)
    with torch.no_grad():
        for k, v in planes.items():
            assert tuple(temb.planes[k].shape) == v.shape
            temb.planes[k].copy_(torch.tensor(np.asarray(v)))
    assert temb.out_dim == jemb.out_dim == 8
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, (60, 3)).astype(np.float32)
    wgt = rng.normal(size=(60, 8)).astype(np.float32)
    for t in (0.4, rng.random(60).astype(np.float32)):
        jf, jg = jax.value_and_grad(
            lambda p, xx: jnp.sum(jemb(p, xx, t) * wgt), argnums=(0, 1))(
            planes, jnp.asarray(x))
        np.testing.assert_allclose(
            temb(torch.tensor(x), torch.tensor(t)).detach().numpy(),
            np.asarray(jemb(planes, jnp.asarray(x), t)), atol=1e-6)
        xt = torch.tensor(x, requires_grad=True)
        tf = torch.sum(temb(xt, torch.tensor(t)) * torch.tensor(wgt))
        np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
        names = sorted(temb.planes)
        got = torch.autograd.grad(tf, [temb.planes[k] for k in names] + [xt])
        for k, g in zip(names, got):
            _close(g.numpy(), jg[0][k], name=k)
        _close(got[-1].numpy(), jg[1], name="x")


@pytest.mark.parametrize("out_actvn,skips", [("none", ()), ("sigmoid", (2,)),
                                             ("softplus", ()),
                                             ("tanh", (1, 2))])
def test_mlp_matches_jax(out_actvn, skips):
    jm = jr.MLP(7, width=16, depth=3, out_dim=5, skips=skips,
                out_actvn=out_actvn)
    params = jm.init(jax.random.PRNGKey(1))
    tm = tr.MLP(7, width=16, depth=3, out_dim=5, skips=skips,
                out_actvn=out_actvn)
    assert [tuple(w.shape) for w, _ in tm.jax_params()] == [
        w.shape for w, _ in params]
    tm.load_jax(params)
    x = np.random.default_rng(2).normal(size=(33, 7)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm(params, jnp.asarray(x))),
                               atol=1e-5)


def test_params_cross_both_ways():
    """The JAX parameter dict into the port's module and back, unchanged;
    the default configuration's widths (feat_width 64, 8 features at 16 and
    32, SH degree 2) as JAX's."""
    _, params = _jax_params()
    p = _np_tree(params)
    cfg = tpp.PointPlanesConfig(**CFG)
    back = tpp.point_planes_params_to_jax(
        tpp.point_planes_params_from_jax(p, cfg))
    flat, tdef = jax.tree_util.tree_flatten(p)
    bflat, btdef = jax.tree_util.tree_flatten(back)
    assert tdef == btdef
    for a, b in zip(flat, bflat):
        np.testing.assert_array_equal(a, b)
    jdef = jpp.PointPlanesConfig().init(jax.random.PRNGKey(0),
                                        jnp.zeros((5, 3)))
    tdef_model = tpp.PointPlanesConfig().init(np.zeros((5, 3), np.float32))
    want = [x.shape for x in jax.tree_util.tree_leaves(jdef)]
    assert [tuple(x.shape) for x in tpp.flat_params(tdef_model)] == want
    assert not tdef_model.resd.weights[-1].detach().any()


def test_forward_matches_jax(jax_run):
    """point_planes_forward from JAX's weights: rgb, depth, alpha, trans
    within ATOL, radii equal."""
    params, _, _, jout, *_ = jax_run
    _, tc = _cams()
    cfg = tpp.PointPlanesConfig(**CFG)
    model = tpp.point_planes_params_from_jax(params, cfg)
    with torch.no_grad():
        tout = tpp.point_planes_forward(cfg, model, TT, tc)
    for k in ("rgb", "depth", "alpha", "trans"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tout.radii.numpy(), np.asarray(jout.radii),
                               atol=1e-4)
    assert float(jout.alpha.max()) > 0.5 and float(jout.rgb.std()) > 0.02


def test_train_step_matches_jax(jax_run):
    """One make_point_planes_train_step from JAX's weights: loss and psnr
    within LOSS_RTOL of JAX's step, every gradient (in JAX's leaf order)
    within GRAD_RTOL of its largest; Adam apart: the port's adam_update
    from JAX's fresh optax state on JAX's gradients gives the parameters
    and moments of JAX's step."""
    params, opt, target, _, jloss, jgrads, new_p, new_o, jaux = jax_run
    _, tc = _cams()
    cfg = tpp.PointPlanesConfig(**CFG)
    model = tpp.point_planes_params_from_jax(params, cfg)
    _, step = tpp.make_point_planes_train_step(cfg, tc, LR)
    grads = {}
    state, aux = step(model, tpp.adam_init(model), TT, tc.K, tc.R, tc.T,
                      torch.tensor(target), grads_out=grads)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"]), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                               rtol=LOSS_RTOL)
    assert int(aux["pair_overflow"]) == 0
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads["grads"]) == len(want) == 31
    for i, (g, w) in enumerate(zip(grads["grads"], want)):
        if np.abs(w).max() == 0:
            assert not g.any(), i
            continue
        _close(g.numpy(), w, name=f"grad leaf {i}")
    # Adam apart: JAX's gradients, JAX's fresh state
    fresh = tpp.point_planes_params_from_jax(params, cfg)
    leaves = tpp.flat_params(fresh)
    olv = jax.tree_util.tree_leaves(opt)
    n = len(leaves)
    st = tpp.AdamState(torch.tensor(olv[0]),
                       [torch.tensor(x) for x in olv[1:1 + n]],
                       [torch.tensor(x) for x in olv[1 + n:]])
    st = tpp.adam_update(leaves, [torch.tensor(w) for w in want], st, LR)
    wp = jax.tree_util.tree_leaves(new_p)
    wo = jax.tree_util.tree_leaves(new_o)
    assert int(st.count) == int(wo[0]) == 1
    for got, w in zip([*leaves, *st.mu, *st.nu], [*wp, *wo[1:]]):
        np.testing.assert_allclose(got.detach().numpy(), w, atol=ADAM_ATOL,
                                   rtol=ADAM_RTOL)

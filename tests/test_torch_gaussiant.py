"""Parity of the port's GaussianT (plain 3DGS) family with the JAX package:
render_gaussiant, one make_gaussiant_train_step from a state carried
across, and gaussiant_maintenance at a densify iteration (and at one that
also ramps the SH degree and resets opacity). The train_gaussiant loop's
test is tests/test_torch_gaussiant_loop.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussians as jg
from envgs_tpu.models import gaussiant as jgt
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.models import gaussiant as tgt
from envgs_tpu_torch.utils import camera as tcam

H = W = 48  # 3 x 3 tiles
P, CAP = 150, 256
F = 60.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
# forward maps: the sequential blend against the JAX closed form
ATOL = 1e-5
# per-splat wet, relative: sums over many pixels in another order
WET_RTOL = 1e-5
# the loss: float32 sums over the image in another order
LOSS_RTOL = 1e-5
# arrays derived from gradients: per array max|d| / max|ref|
GRAD_RTOL = 5e-4
CFG = dict(sh_degree=1, pair_cap=2 ** 12)


def _points(seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                          rng.normal(size=(P, 1)) * 0.3 + 3.0],
                         -1).astype(np.float32)
    return xyz, rng.random((P, 3)).astype(np.float32)


def _pose(deg):
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return R, np.array([0.02 * deg, 0.0, 0.0], np.float32)


def _cams(deg=0.0):
    R, T = _pose(deg)
    return make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)


def _arrays(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def _jax_state_to_numpy(state) -> dict:
    """A JAX GaussianTState as the port's weight-bridge dict."""
    pool, opt = state.pool, state.opt
    return dict(params=_arrays(pool.params), stats=_arrays(pool.stats),
                mu=_arrays(opt.mu), nu=_arrays(opt.nu), step=int(opt.step),
                max_sh_degree=pool.max_sh_degree)


def _jax_state(seed=0, mid_run=True, sh_degree=1):
    """A JAX GaussianTState of the points at opacity 0.5; mid_run: random
    SH coefficients and anisotropic scales, Adam moments at step 10 (smooth
    updates), active SH degree `sh_degree` and some statistics (all from
    seeded numpy)."""
    xyz, rgb = _points(seed)
    cfg = jgt.GaussianTConfig(raster_backend="pallas_interp", **CFG)
    state = jgt.init_gaussiant_state(jgt.init_gaussiant_pool(
        xyz, rgb, CAP, cfg, init_opacity=0.5))
    if not mid_run:
        return state
    rng = np.random.default_rng(seed + 100)
    pool = state.pool
    like = lambda s: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(s(p.shape).astype(np.float32)), pool.params)
    params = pool.params._replace(
        features_rest=jnp.asarray(rng.normal(
            size=pool.params.features_rest.shape).astype(np.float32) * 0.2),
        # anisotropic, so that the rotations have gradients of their own
        scaling=jnp.asarray(np.log(rng.uniform(0.01, 0.06, (CAP, 3)))
                            .astype(np.float32)))
    act = np.asarray(pool.stats.active)
    denom = np.where(act, rng.integers(0, 4, CAP), 0).astype(np.float32)
    stats = pool.stats._replace(
        sh_degree=jnp.asarray(sh_degree, jnp.int32),
        denom=jnp.asarray(denom),
        grad_accum=jnp.asarray((rng.random(CAP) * 6e-4 * denom)
                               .astype(np.float32)),
        weight_accum=jnp.asarray((rng.random(CAP) * denom)
                                 .astype(np.float32)),
        max_radii2d=jnp.asarray((rng.random(CAP) * 30).astype(np.float32)))
    opt = jopt.AdamState(like(lambda s: rng.normal(size=s) * 1e-3),
                         like(lambda s: rng.random(s) * 1e-5 + 1e-6),
                         jnp.asarray(10, jnp.int32))
    return jgt.GaussianTState(pool._replace(params=params, stats=stats), opt)


def _close(got, want, rtol=GRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        name, np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side of the render and step tests in one jitted function
    (one compile): render_gaussiant of a mid-run state (SH degree 1 active)
    and one make_gaussiant_train_step from it. -> (state, camera pair,
    target, render output, new state, aux)."""
    state = _jax_state(seed=1)
    jc, tc = _cams(-2.0)
    target = np.random.default_rng(2).random((H, W, 3)).astype(np.float32)
    jcfg = jgt.GaussianTConfig(raster_backend="pallas_interp", **CFG)
    jstep = jgt.make_gaussiant_train_step(jcfg, jc)
    out, (new, aux) = jax.jit(lambda s, t: (
        jgt.render_gaussiant(s.pool, jc, jcfg),
        jstep(s, jc.K, jc.R, jc.T, t)))(state, jnp.asarray(target))
    return state, tc, target, out, new, aux


def test_render_gaussiant_matches_jax(jax_run):
    """rgb, depth, alpha, trans within ATOL, the per-splat forward wet
    within WET_RTOL, radii exactly, from one state on both sides."""
    state, tc, _, jout, _, _ = jax_run
    tstate = tgt.gaussiant_state_from_numpy(_jax_state_to_numpy(state))
    tout = tgt.render_gaussiant(tstate.pool, tc, tgt.GaussianTConfig(**CFG))
    for k in ("rgb", "depth", "alpha", "trans"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    # wet: a splat's sum over up to thousands of pixels, in another order
    np.testing.assert_allclose(tout.wet.numpy(), np.asarray(jout.wet),
                               atol=ATOL, rtol=WET_RTOL)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert float(jout.alpha.max()) > 0.9 and float(jout.rgb.std()) > 0.05
    assert int(tout.num_pairs) <= CFG["pair_cap"]


def test_train_step_matches_jax(jax_run):
    """One make_gaussiant_train_step from the same mid-run state: loss and
    psnr within LOSS_RTOL, the point count equal; the change of every param
    and Adam moment, and the densification gradient accumulator, within
    GRAD_RTOL of each array's max; visit counts, radii and the blend-weight
    accumulator (forward wet) as JAX's."""
    state, tc, target, _, jnew, jaux = jax_run
    start = _jax_state_to_numpy(state)
    tstep = tgt.make_gaussiant_train_step(tgt.GaussianTConfig(**CFG), tc)
    tnew, taux = tstep(tgt.gaussiant_state_from_numpy(start), tc.K, tc.R,
                       tc.T, torch.tensor(target))
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(taux["n_pts"]) == int(jaux["n_pts"]) == P
    assert int(taux["pair_overflow"]) == 0
    got, want = tgt.gaussiant_state_to_numpy(tnew), _jax_state_to_numpy(jnew)
    assert got["step"] == want["step"] == 11
    for grp in ("params", "mu", "nu"):
        for k, w in want[grp].items():
            _close(got[grp][k] - start[grp][k], w - start[grp][k],
                   name=f"{grp} {k}")
    gs, ws = got["stats"], want["stats"]
    for k in ("active", "denom", "max_radii2d", "sh_degree"):
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    _close(gs["grad_accum"], ws["grad_accum"], name="grad_accum")
    np.testing.assert_allclose(gs["weight_accum"], ws["weight_accum"],
                               atol=ATOL, rtol=WET_RTOL)
    assert (ws["denom"] > start["stats"]["denom"]).sum() > P // 2
    # params the backward kernel alone reaches moved
    assert np.abs(got["params"]["rotation"]
                  - start["params"]["rotation"]).max() > 0


def _jax_eps(key, dcfg, cap):
    """The split draws of envgs_tpu's densify_and_prune, in its order."""
    eps = []
    for _ in range(dcfg.split_n + dcfg.weight_split_n):
        key, sub = jax.random.split(key)
        eps.append(torch.tensor(np.asarray(jax.random.normal(sub, (cap, 3)))))
    return eps


@pytest.mark.parametrize("it", [600, 3000])
def test_maintenance_matches_jax(it):
    """gaussiant_maintenance at a densify iteration (600) and at one that
    also ramps the SH degree and resets opacity (3000), fed JAX's own split
    draws: active, stats and sh_degree exactly, params and Adam moments
    within 1e-6."""
    state = _jax_state(seed=3, sh_degree=0)
    kw = dict(spatial_scale=0.3, min_weight_threshold=0.3)
    key = jax.random.PRNGKey(it)
    jcfg = jgt.GaussianTConfig(raster_backend="pallas_interp", **CFG)
    jnew = jgt.gaussiant_maintenance(state, it, jcfg,
                                     jg.DensifyConfig(**kw), key)
    tnew = tgt.gaussiant_maintenance(
        tgt.gaussiant_state_from_numpy(_jax_state_to_numpy(state)), it,
        tgt.GaussianTConfig(**CFG), tg.DensifyConfig(**kw),
        eps=_jax_eps(key, jg.DensifyConfig(**kw), CAP))
    got, want = tgt.gaussiant_state_to_numpy(tnew), _jax_state_to_numpy(jnew)
    for k, w in want["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], w, err_msg=k)
    before = np.asarray(state.pool.stats.active)
    born = want["stats"]["active"] & ~before
    assert born.sum() > 5 and (before & ~want["stats"]["active"]).sum() > 5
    assert int(want["stats"]["sh_degree"]) == (1 if it == 3000 else 0)
    for grp in ("params", "mu", "nu"):
        for k, w in want[grp].items():
            np.testing.assert_allclose(got[grp][k], w, atol=1e-6, rtol=1e-6,
                                       err_msg=f"{grp} {k}")
    if it == 3000:  # the opacity reset: at most 0.01, moments zeroed
        assert tg.sigmoid(torch.tensor(got["params"]["opacity"])).max() <= (
            0.01 + 1e-6)
        assert not got["mu"]["opacity"].any()

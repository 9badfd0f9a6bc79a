"""Parity of the port's Spacetime Gaussians (models/stgs.py) with the JAX
package: splats_at_time, eval_sh_4d, render_stgs with the static SH and
the 4D SH, one make_stgs_train_step (every gradient, the eleven parameter
fields, the statistics; Adam held apart on JAX's gradients),
stgs_maintenance fed JAX's split draws, reset_t, the STGS learning rates
and named schedulers, and the 4D ply crossing both ways. JAX runs its
kernels in interpret mode (pallas_interp), jitted once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussians as jg
from envgs_tpu.models import stgs as js
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.utils import sh as jsh
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.models import stgs as ts
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.utils import camera as tcam
from envgs_tpu_torch.utils import sh as tsh
from torch_threads import one_thread  # noqa: F401

H = W = 40
P, CAP = 40, 64
F = 50.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
CFG = dict(sh_degree=1, pair_cap=2 ** 11)
TT = 0.35  # the query time
IT = 7  # the step's iteration
# forward maps: the sequential blend against the JAX closed form
ATOL = 1e-5
# per-splat wet, relative: sums over many pixels in another order
WET_RTOL = 1e-5
# the loss: float32 sums over the image in another order
LOSS_RTOL = 1e-5
# gradients and arrays derived from them: per array max|d| / max|ref|
GRAD_RTOL = 5e-4
# Adam on JAX's gradients (read back from its first moment to 1 ulp)
ADAM_ATOL = 1e-7
ADAM_RTOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_thread")


def _cams():
    # off the origin, where a pool's inactive slots sit (a splat at the
    # camera's center has no projection)
    R = np.eye(3, dtype=np.float32)
    T = np.array([0.05, -0.03, 0.0], np.float32)
    return make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)


def _arrays(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def _to_numpy(state) -> dict:
    """A JAX STGSState as the port's weight-bridge dict."""
    return dict(params=_arrays(state.pool.params),
                stats=_arrays(state.pool.stats), mu=_arrays(state.opt.mu),
                nu=_arrays(state.opt.nu), step=int(state.opt.step),
                max_sh_degree=state.pool.max_sh_degree)


def _jcfg(sh_degree_t=0):
    return js.STGSConfig(raster_backend="pallas_interp",
                         sh_degree_t=sh_degree_t, **CFG)


def _jax_state(seed=0, sh_degree_t=0):
    """A JAX STGSState of P Gaussians about z = 3 in a pool of CAP (all from
    seeded numpy): anisotropic scales, random SH (also the temporal
    blocks), temporal centers in [0, 1], temporal scales 0.2-0.6, motions
    of ~0.3, SH degree 1 active, fresh Adam moments."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.35,
                          rng.normal(size=(P, 1)) * 0.2 + 3.0],
                         -1).astype(np.float32)
    cfg = _jcfg(sh_degree_t)
    pool = js.init_stgs_pool(xyz, rng.random(P).astype(np.float32),
                             rng.random((P, 3)).astype(np.float32), CAP,
                             cfg)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    act = np.asarray(pool.stats.active)[:, None]
    params = pool.params._replace(
        scaling=f32(np.log(rng.uniform(0.02, 0.08, (CAP, 3)))),
        features_rest=f32(rng.normal(
            size=pool.params.features_rest.shape) * 0.2),
        opacity=f32(rng.normal(size=(CAP, 1)) + 1.0),
        scaling_t=f32(np.log(rng.uniform(0.2, 0.6, (CAP, 1)))),
        motion=f32(np.where(act, rng.normal(size=(CAP, 3)) * 0.3, 0.0)))
    stats = pool.stats._replace(sh_degree=jnp.asarray(1, jnp.int32))
    return js.init_stgs_state(pool._replace(params=params, stats=stats))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's side in one jitted function: render_stgs at TT with the static
    SH and with sh_degree_t = 1, and one train step (sh_degree_t = 1) at
    iteration IT. -> (states, target, renders, new state, aux)."""
    jc, _ = _cams()
    states = [_jax_state(1, 0), _jax_state(1, 1)]
    target = np.random.default_rng(2).random((H, W, 3)).astype(np.float32)
    jstep = js.make_stgs_train_step(_jcfg(1), jc, js.stgs_lr_config(),
                                    donate=False)

    def run(s0, s1, gt):
        tt = jnp.asarray(TT, jnp.float32)
        outs = [js.render_stgs(s.pool, jc, tt, _jcfg(d))
                for d, s in ((0, s0), (1, s1))]
        return outs, jstep(s1, jc.K, jc.R, jc.T, tt, gt, jnp.asarray(IT))

    outs, (new, aux) = jax.jit(run)(*states, jnp.asarray(target))
    return states, target, outs, new, aux


def _close(got, want, rtol=GRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        name, np.abs(got - want).max(), scale)


def test_splats_at_time_matches_jax():
    state = _jax_state(3)
    pool = ts.stgs_state_from_numpy(_to_numpy(state)).pool
    for tt in (0.0, 0.35, 1.3):
        jx, jo = js.splats_at_time(state.pool, jnp.asarray(tt, jnp.float32))
        tx, to = ts.splats_at_time(pool, tt)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    assert float(jo.max()) > 0.1 and float(jo.min()) < 0.2


@pytest.mark.parametrize("deg,deg_t", [(0, 1), (1, 2), (3, 1)])
def test_eval_sh_4d_matches_jax(deg, deg_t):
    rng = np.random.default_rng(deg * 10 + deg_t)
    n, C = 50, 3
    Kc = jsh.num_sh_coeffs_4d(deg, deg_t)
    assert tsh.num_sh_coeffs_4d(deg, deg_t) == Kc
    sh = rng.normal(size=(n, C, Kc)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dt = rng.uniform(-1, 1, n).astype(np.float32)
    for t in (dt, dt[:, None]):  # (n,) and (n, 1) time offsets
        want = jsh.eval_sh_4d(deg, deg_t, jnp.asarray(sh), jnp.asarray(dirs),
                              jnp.asarray(t), l=0.8)
        got = tsh.eval_sh_4d(deg, deg_t, torch.tensor(sh),
                             torch.tensor(dirs), torch.tensor(t), l=0.8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tsh.sh02rgb(torch.tensor(sh)).numpy(),
                               np.asarray(jsh.sh02rgb(jnp.asarray(sh))),
                               atol=1e-6)


@pytest.mark.parametrize("sh_degree_t", [0, 1])
def test_render_stgs_matches_jax(jax_run, sh_degree_t):
    """rgb, depth, alpha, trans within ATOL, the per-splat wet within
    WET_RTOL, radii exactly, from one state on both sides."""
    states, _, outs, _, _ = jax_run
    jout = outs[sh_degree_t]
    _, tc = _cams()
    pool = ts.stgs_state_from_numpy(_to_numpy(states[sh_degree_t])).pool
    tout = ts.render_stgs(pool, tc, TT, ts.STGSConfig(
        sh_degree_t=sh_degree_t, **CFG))
    for k in ("rgb", "depth", "alpha", "trans"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tout.wet.numpy(), np.asarray(jout.wet),
                               atol=ATOL, rtol=WET_RTOL)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert float(jout.alpha.max()) > 0.5 and float(jout.rgb.std()) > 0.05
    assert int(tout.num_pairs) <= CFG["pair_cap"]


def test_4d_sh_render_differs_from_static(jax_run):
    """The temporal SH block changes the colors (the 4D branch is live)."""
    _, _, outs, _, _ = jax_run
    assert float(jnp.abs(outs[0].rgb - outs[1].rgb).max()) > 1e-2


def test_train_step_matches_jax(jax_run):
    """One make_stgs_train_step (sh_degree_t = 1) from the same state: loss
    within LOSS_RTOL; the gradient of each of the eleven parameter fields
    (JAX's read back from its first moment, the step starting from zero
    moments) within GRAD_RTOL of its largest, t / scaling_t / motion among
    them and non-zero; visit counts and radii equal, grad_accum and
    weight_accum within bounds; Adam held apart: the port's sparse Adam on
    JAX's gradients gives JAX's params and moments."""
    states, target, _, jnew, jaux = jax_run
    start = _to_numpy(states[1])
    _, tc = _cams()
    lr = topt.LRConfig(**js.stgs_lr_config()._asdict())
    tstep = ts.make_stgs_train_step(ts.STGSConfig(sh_degree_t=1, **CFG), tc,
                                    lr)
    grads = {}
    tnew, taux = tstep(ts.stgs_state_from_numpy(start), tc.K, tc.R, tc.T, TT,
                       torch.tensor(target), IT, grads_out=grads)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=LOSS_RTOL)
    assert int(taux["n_active"]) == int(jaux["n_active"]) == P
    assert int(taux["pair_overflow"]) == 0
    want = _to_numpy(jnew)
    b1 = np.float32(1 - 0.9)
    jgrads = {k: v / b1 for k, v in want["mu"].items()}
    assert len(jgrads) == 11 == len(tg.present(grads["params"]))
    for k, w in jgrads.items():
        g = getattr(grads["params"], k).numpy()
        if k in ("specular", "roughness"):  # not on the STGS path
            assert not g.any() and not w.any(), k
            continue
        assert np.abs(w).max() > 0, k
        _close(g, w, name=f"grad {k}")
    gs, ws = tg.pool_to_numpy(tnew.pool)[1], want["stats"]
    for k in ("active", "denom", "max_radii2d", "sh_degree"):
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    _close(gs["grad_accum"], ws["grad_accum"], name="grad_accum")
    np.testing.assert_allclose(gs["weight_accum"], ws["weight_accum"],
                               atol=ATOL, rtol=WET_RTOL)
    # Adam apart, on JAX's gradients
    s0 = ts.stgs_state_from_numpy(start)
    g = tg.GaussianParams(**{k: torch.tensor(v) for k, v in jgrads.items()})
    new_p, new_opt = topt.sparse_adam_update(
        s0.pool.params, g, s0.opt, topt.lr_tree_for(IT, lr))
    assert int(new_opt.step) == int(want["step"]) == 1
    for grp, tree in (("params", new_p), ("mu", new_opt.mu),
                      ("nu", new_opt.nu)):
        for k, w in want[grp].items():
            np.testing.assert_allclose(getattr(tree, k).numpy(), w,
                                       atol=ADAM_ATOL, rtol=ADAM_RTOL,
                                       err_msg=f"{grp} {k}")


def _jax_eps(key, dcfg):
    """The split draws of envgs_tpu's densify_and_prune, in its order."""
    eps = []
    for _ in range(dcfg.split_n + dcfg.weight_split_n):
        key, sub = jax.random.split(key)
        eps.append(torch.tensor(np.asarray(jax.random.normal(sub, (CAP, 3)))))
    return eps


def test_maintenance_matches_jax():
    """stgs_maintenance with statistics that clone, split (both recipes)
    and prune, fed JAX's split draws: masks and statistics exactly, every
    parameter (the children's temporal fields copied from their parents)
    and moment within 1e-6."""
    state = _jax_state(4)
    rng = np.random.default_rng(5)
    act = np.asarray(state.pool.stats.active)
    denom = np.where(act, rng.integers(1, 4, CAP), 0).astype(np.float32)
    pool = state.pool._replace(stats=state.pool.stats._replace(
        denom=jnp.asarray(denom),
        grad_accum=jnp.asarray((rng.random(CAP) * 6e-4 * denom)
                               .astype(np.float32)),
        weight_accum=jnp.asarray((rng.random(CAP) * denom)
                                 .astype(np.float32))))
    like = lambda s: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(s(p.shape).astype(np.float32)), pool.params)
    state = js.STGSState(pool, jopt.AdamState(
        like(lambda s: rng.normal(size=s) * 1e-3),
        like(lambda s: rng.random(s) * 1e-5), jnp.asarray(10, jnp.int32)))
    kw = dict(spatial_scale=0.5, min_weight_threshold=0.3,
              densify_size_threshold=0.1, max_scene_threshold=0.12)
    key = jax.random.PRNGKey(3)
    jnew = js.stgs_maintenance(state, jg.DensifyConfig(**kw), key)
    tnew = ts.stgs_maintenance(ts.stgs_state_from_numpy(_to_numpy(state)),
                               tg.DensifyConfig(**kw),
                               eps=_jax_eps(key, jg.DensifyConfig(**kw)))
    got, want = ts.stgs_state_to_numpy(tnew), _to_numpy(jnew)
    for k, w in want["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], w, err_msg=k)
    born = want["stats"]["active"] & ~act
    assert born.sum() > 5 and (act & ~want["stats"]["active"]).sum() > 5
    for grp in ("params", "mu", "nu"):
        assert set(got[grp]) == set(want[grp]) and "motion" in want[grp]
        for k, w in want[grp].items():
            np.testing.assert_allclose(got[grp][k], w, atol=1e-6, rtol=1e-6,
                                       err_msg=f"{grp} {k}")
    assert np.abs(want["params"]["motion"][born]).max() > 0


def test_reset_t_matches_jax():
    state = _jax_state(6)
    t = np.asarray(state.pool.params.t).copy()
    t[0], t[1] = 7.0, -2.0
    rng = np.random.default_rng(7)
    opt = state.opt._replace(mu=state.opt.mu._replace(
        t=jnp.asarray(rng.random((CAP, 1)), jnp.float32),
        xyz=jnp.ones((CAP, 3))))
    state = js.STGSState(state.pool._replace(params=state.pool.params._replace(
        t=jnp.asarray(t))), opt)
    jp, jo = js.reset_t(state.pool, state.opt, 0.0, 0.8)
    s = ts.stgs_state_from_numpy(_to_numpy(state))
    tp, to = ts.reset_t(s.pool, s.opt, 0.0, 0.8)
    got, want = (ts.stgs_state_to_numpy(ts.STGSState(tp, to)),
                 _to_numpy(js.STGSState(jp, jo)))
    for grp in ("params", "mu", "nu"):
        for k, w in want[grp].items():
            np.testing.assert_array_equal(got[grp][k], w, err_msg=k)
    assert got["params"]["t"].max() == 0.8 and not got["mu"]["t"].any()
    assert got["mu"]["xyz"].all()


def test_lr_config_and_schedulers_match_jax():
    """stgs_lr_config's table (t at half the duration, no pulse) through
    lr_tree_for, and the three named schedulers in SCHEDULERS."""
    from envgs_tpu.engine import SCHEDULERS as JS
    from envgs_tpu_torch.engine import SCHEDULERS as TS

    jl = js.stgs_lr_config(spatial_scale=2.5, duration=3.0)
    tl = ts.stgs_lr_config(spatial_scale=2.5, duration=3.0)
    assert tl._asdict() == jl._asdict()
    for it in (0, 3100, 4150, 29000):
        want = jopt.lr_tree_for(it, jl)
        got = topt.lr_tree_for(it, tl)
        for k, w in want._asdict().items():
            assert np.float32(getattr(got, k)) == np.float32(w), (it, k)
    assert topt.lr_tree_for(0, topt.LRConfig()).t is None
    names = ("NoopLR", "ExponentialLR", "WarmupExponentialLR")
    assert set(names) <= set(TS._modules)
    for name in names:
        for step in (0, 250, 800, 45000):
            kw = dict(gamma=0.2, decay_iter=1000, min_lr=1e-5)
            if name == "WarmupExponentialLR":
                kw["warmup_iter"] = 400
            want = JS.get(name)(jnp.asarray(step, jnp.float32), 5e-3, **kw)
            got = TS.get(name)(step, 5e-3, **kw)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{name} {step}")


def test_4d_ply_crosses_between_packages(tmp_path):
    """A JAX 4D ply loads into the port and a port 4D ply into JAX: the
    active splats' fields equal."""
    state = _jax_state(8)
    fields = ("xyz", "t", "scaling_t", "motion", "opacity", "scaling",
              "rotation", "features_dc")
    act = np.asarray(state.pool.stats.active)
    js.save_stgs_ply(state.pool, str(tmp_path / "jax.ply"))
    tpool = ts.load_stgs_ply(str(tmp_path / "jax.ply"), 96,
                             ts.STGSConfig(**CFG))
    tact = tpool.stats.active.numpy()
    assert tpool.cap == 96 and tact.sum() == act.sum()
    for k in fields:
        np.testing.assert_array_equal(
            getattr(tpool.params, k).numpy()[tact],
            np.asarray(getattr(state.pool.params, k))[act], err_msg=k)
    port = ts.stgs_state_from_numpy(_to_numpy(state)).pool
    ts.save_stgs_ply(port, str(tmp_path / "port.ply"))
    jpool = js.load_stgs_ply(str(tmp_path / "port.ply"), 80, _jcfg())
    jact = np.asarray(jpool.stats.active)
    for k in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jpool.params, k))[jact],
            np.asarray(getattr(state.pool.params, k))[act], err_msg=k)

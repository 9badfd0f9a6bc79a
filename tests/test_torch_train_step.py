"""Parity of the port's train step with the JAX package: the losses (SSIM
included) and their gradients, sparse Adam and the LR schedules, one whole
make_train_step from the same numpy state, the train-state weight bridge,
and the detach_reflection switch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import GaussianParams as JParams
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.ops import losses as jlosses
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.ops import losses as tlosses
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam

H, W, f = 32, 48, 50.0
K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
EYE, ZERO = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
# scalar losses: float32 sums over the image in another order (and, for
# the whole step, two blends and the reflected-ray chain between them)
LOSS_RTOL = 1e-4
# arrays derived from gradients (the gradients themselves, Adam moments and
# updates): per array max|d| / max|ref|, the JAX package's gradient budget
GRAD_RTOL = 5e-4
# every loss term on, so each is checked
LOSS_CFG = dict(perc_loss_weight=0.0, gs_dist_loss_weight=0.01,
                gs_dist_loss_start_iter=0, env_opacity_loss_weight=0.01,
                msk_loss_weight=0.1, msk_loss_start_iter=0)


def _close(got, want, rtol=GRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        name, np.abs(got - want).max(), scale)


def test_losses_match_jax():
    """ssim and compute_losses (every term on) against the JAX package:
    values within LOSS_RTOL, gradients with respect to every map the loss
    reads within GRAD_RTOL."""
    rng = np.random.default_rng(0)
    maps = dict(
        rgb_map=rng.random((H, W, 3)), norm_map=rng.normal(size=(H, W, 3)),
        surf_norm_map=rng.normal(size=(H, W, 3)),
        acc_map=rng.random((H, W, 1)), dist_map=rng.random((H, W, 1)) * 1e-2,
        env_opacity=rng.random((40, 1)))
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    dpt = (rng.random((H, W, 1)) * 3 + 1).astype(np.float32)
    gt = rng.random((H, W, 3)).astype(np.float32)
    msk = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    nrm = rng.random((H, W, 3)).astype(np.float32)
    R = np.array([[0.8, 0.6, 0], [-0.6, 0.8, 0], [0, 0, 1]], np.float32)
    names = list(maps)

    def jloss(*vals):
        fields = {k: jnp.zeros(()) for k in jenv.EnvGSOutput._fields}
        fields.update(zip(names, vals), dpt_map=jnp.asarray(dpt))
        return jsup.compute_losses(
            jenv.EnvGSOutput(**fields), jnp.asarray(gt), jnp.asarray(msk),
            jnp.asarray(nrm), jnp.asarray(R), 100,
            jsup.LossConfig(**LOSS_CFG), bg_brightness=0.3)

    jargs = [jnp.asarray(maps[k]) for k in names]
    (jl, jstats), jg = jax.value_and_grad(jloss, argnums=tuple(
        range(len(names))), has_aux=True)(*jargs)

    targs = [torch.tensor(maps[k], requires_grad=True) for k in names]
    fields = {k: None for k in tenv.EnvGSOutput._fields}
    fields.update(zip(names, targs), dpt_map=torch.tensor(dpt))
    tl, tstats = tsup.compute_losses(
        tenv.EnvGSOutput(**fields), torch.tensor(gt), torch.tensor(msk),
        torch.tensor(nrm), torch.tensor(R), 100,
        tsup.LossConfig(**LOSS_CFG), bg_brightness=0.3)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for name, got, want in zip(names, torch.autograd.grad(tl, targs), jg):
        _close(got.numpy(), want, name=name)

    x = torch.tensor(maps["rgb_map"], requires_grad=True)
    s = tlosses.ssim(x, torch.tensor(gt))
    js, jgx = jax.value_and_grad(jlosses.ssim)(jnp.asarray(maps["rgb_map"]),
                                                jnp.asarray(gt))
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=LOSS_RTOL)
    _close(torch.autograd.grad(s, x)[0].numpy(), jgx, name="ssim")


def _jparams(rng, shapes, scale):
    return JParams(**{k: jnp.asarray((rng.normal(size=s) * scale)
                                     .astype(np.float32))
                      for k, s in shapes.items()})


def test_sparse_adam_and_lr_tree_match_jax():
    """Two masked Adam steps (a third of the gradient entries exactly zero:
    their elements keep params and moments) and the LR table at iterations
    around the reflection start, the opacity pulse and its windows."""
    rng = np.random.default_rng(1)
    shapes = dict(xyz=(20, 3), features_dc=(20, 1, 3),
                  features_rest=(20, 15, 3), scaling=(20, 2),
                  rotation=(20, 4), opacity=(20, 1), specular=(20, 1),
                  roughness=(20, 1))
    fields = tg.GaussianParams._fields  # the JAX tuple adds temporal Nones
    to_t = lambda jt: tg.GaussianParams(*(  # noqa: E731
        torch.tensor(np.asarray(getattr(jt, k))) for k in fields))
    jp = _jparams(rng, shapes, 1.0)
    tp = to_t(jp)
    js, ts = jopt.init_adam(jp), topt.init_adam(tp)
    for it in (3100, 4100):
        g = _jparams(rng, shapes, 1e-2)
        g = jax.tree_util.tree_map(
            lambda a: jnp.where(jnp.asarray(rng.random(a.shape)) < 1 / 3,
                                0.0, a), g)
        jp, js = jopt.sparse_adam_update(jp, g, js, jopt.lr_tree_for(
            it, jopt.LRConfig()))
        tp, ts = topt.sparse_adam_update(
            tp, to_t(g), ts, topt.lr_tree_for(it, topt.LRConfig()))
    assert int(ts.step) == int(js.step) == 2
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for k in fields:
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6, atol=1e-12, err_msg=k)
    for it in (0, 2999, 3000, 3001, 3999, 4000, 4150, 4200, 6000, 6100,
               17999, 18000, 18100, 25000, 40000):
        want = jopt.lr_tree_for(it, jopt.LRConfig())
        got = topt.lr_tree_for(it, topt.LRConfig())
        for k in tg.GaussianParams._fields:
            np.testing.assert_allclose(getattr(got, k),
                                       float(getattr(want, k)), rtol=1e-6,
                                       err_msg=f"{k} at {it}")
    assert topt.lr_tree_for(4100, topt.LRConfig()).opacity == 0.0


def _scene(seed=0, P=150, Pe=200):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    col = rng.random((P, 3)).astype(np.float32)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    base = create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=256,
                      sh_degree=3, init_opacity=0.6)
    state = jtrain.init_train_state(base, env, jax.random.PRNGKey(0))

    def moments(pool):  # a mid-run optimizer state: smooth Adam updates
        like = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda p: jnp.asarray(s(p.shape).astype(np.float32)), pool.params)
        return jopt.AdamState(like(lambda s: rng.normal(size=s) * 1e-3),
                              like(lambda s: rng.random(s) * 1e-5 + 1e-6),
                              jnp.asarray(10, jnp.int32))

    state = state._replace(opt_base=moments(base), opt_env=moments(env))
    batch = (rng.random((H, W, 3)).astype(np.float32),
             (rng.random((H, W, 1)) > 0.1).astype(np.float32),
             rng.random((H, W, 3)).astype(np.float32))
    return state, batch


def _jax_state_to_numpy(state) -> dict:
    """A JAX TrainState as the port's weight-bridge dict."""
    def pool(p, opt):
        arrays = lambda t: {k: np.asarray(v)  # noqa: E731
                            for k, v in t._asdict().items() if v is not None}
        return dict(params=arrays(p.params), stats=arrays(p.stats),
                    mu=arrays(opt.mu), nu=arrays(opt.nu), step=int(opt.step),
                    max_sh_degree=p.max_sh_degree)
    return {"base": pool(state.base, state.opt_base),
            "env": pool(state.env, state.opt_env)}


def test_train_step_matches_jax():
    """One make_train_step (sedan bench configuration at 32x48: both passes,
    every loss term, it=25000) from the same numpy state on both sides.

    Loss and loss stats within LOSS_RTOL; the capacity counters and point
    counts equal. New params, Adam moments (their change from the start
    state) and the densification gradient accumulator within GRAD_RTOL;
    visit counts and max radii equal; the blend-weight accumulator within
    the JAX package's wet budget. The env pass sees the base pass only
    through the reflected rays, whose last bits differ: an env splat
    touching a ray only at the 1/255 alpha floor can flip between visible
    and not. At most two such splats are allowed, each with an accumulated
    weight below 1e-3 on both sides; they are left out of the elementwise
    env comparisons."""
    state, (rgb, msk, nrm) = _scene()
    kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0)
    jcam = make_camera(H, W, K, EYE, ZERO)
    jstep = jtrain.make_train_step(
        jcam, jenv.EnvGSConfig(raster_backend="pallas_interp",
                               tracer_backend="tiled_interp", **kw),
        jsup.LossConfig(**LOSS_CFG), jopt.LRConfig(), jopt.LRConfig(),
        donate=False, has_norm=True)
    jnew, jstats = jstep(state, jtrain.Batch(*map(jnp.asarray, (rgb, msk, nrm))),
                         jcam.K, jcam.R, jcam.T, jnp.asarray(25000))

    start = _jax_state_to_numpy(state)
    tcam_ = tcam.make_camera(H, W, K, EYE, ZERO)
    tstep = ttrain.make_train_step(
        tcam_, tenv.EnvGSConfig(**kw), tsup.LossConfig(**LOSS_CFG),
        topt.LRConfig(), topt.LRConfig(), has_norm=True)
    tnew, tstats = tstep(ttrain.state_from_numpy(start),
                         ttrain.Batch(*map(torch.tensor, (rgb, msk, nrm))),
                         tcam_.K, tcam_.R, tcam_.T, 25000)

    assert set(tstats) == set(jstats)
    for k in ("num_pts", "env_num_pts", "pair_overflow", "trace_dropped"):
        assert int(tstats[k]) == int(jstats[k]), k
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got, want = ttrain.state_to_numpy(tnew), _jax_state_to_numpy(jnew)
    for name in ("base", "env"):
        g, w, s0 = got[name], want[name], start[name]
        assert g["step"] == w["step"] == 11
        flip = g["stats"]["denom"] != w["stats"]["denom"]
        if name == "base":
            assert not flip.any()
        assert flip.sum() <= 2, flip.sum()
        assert (g["stats"]["weight_accum"][flip] < 1e-3).all()
        assert (w["stats"]["weight_accum"][flip] < 1e-3).all()
        keep = ~flip
        for grp in ("params", "mu", "nu"):
            for k, wv in w[grp].items():
                _close((g[grp][k] - s0[grp][k])[keep],
                       (wv - s0[grp][k])[keep], name=f"{name} {grp} {k}")
        gs, ws = g["stats"], w["stats"]
        for k in ("denom", "max_radii2d", "active", "sh_degree"):
            np.testing.assert_array_equal(gs[k][keep] if gs[k].ndim else gs[k],
                                          ws[k][keep] if ws[k].ndim else ws[k],
                                          err_msg=k)
        _close(gs["grad_accum"][keep], ws["grad_accum"][keep],
               name=f"{name} grad_accum")
        np.testing.assert_allclose(gs["weight_accum"], ws["weight_accum"],
                                   rtol=1e-2, atol=1e-3)
        assert ws["denom"].sum() > 0.3 * len(ws["denom"])  # many are visible
    # the step moved params that only the backward kernels reach
    assert np.abs(got["env"]["params"]["xyz"]
                  - start["env"]["params"]["xyz"]).max() > 0
    assert np.abs(got["base"]["params"]["rotation"]
                  - start["base"]["params"]["rotation"]).max() > 0


def test_train_state_round_trip():
    """state_from_numpy(state_to_numpy(s)) is s, field by field (params,
    stats, Adam moments and step of both pools), from a JAX train state."""
    state, _ = _scene(seed=2, P=20, Pe=30)
    d = _jax_state_to_numpy(state)
    ts = ttrain.state_from_numpy(d)
    back = ttrain.state_to_numpy(ts)
    for name in ("base", "env"):
        assert back[name]["step"] == d[name]["step"] == 10
        assert back[name]["max_sh_degree"] == d[name]["max_sh_degree"]
        for grp in ("params", "stats", "mu", "nu"):
            assert set(back[name][grp]) == set(d[name][grp])
            for k, v in d[name][grp].items():
                np.testing.assert_array_equal(back[name][grp][k], v,
                                              err_msg=f"{name} {grp} {k}")
    assert ts.opt_base.step.dtype == torch.int32
    assert ts.base.stats.active.dtype == torch.bool


@pytest.mark.parametrize("detach", [False, True])
def test_detach_reflection(detach):
    """A loss on the env render alone reaches the base pool only through
    the reflected rays: with detach_reflection those gradients are exactly
    zero (or absent), without it they are not; the env pool's are not zero
    either way."""
    state, _ = _scene(seed=3, P=60, Pe=80)
    ts = ttrain.state_from_numpy(_jax_state_to_numpy(state))
    cfg = tenv.EnvGSConfig(pair_cap=2 ** 12, env_pair_cap=2 ** 13,
                           reflection_start_iter=0, detach_reflection=detach)
    bparams = tg.GaussianParams(*(p.clone().requires_grad_(True)
                                  for p in ts.base.params))
    exyz = ts.env.params.xyz.clone().requires_grad_(True)
    env = ts.env._replace(params=ts.env.params._replace(xyz=exyz))
    cam = tcam.make_camera(H, W, K, EYE, ZERO)
    out = tenv.forward_envgs(
        ts.base._replace(params=bparams), env, cam, 10, cfg,
        torch.zeros((ts.base.cap, 2)), torch.zeros((ts.env.cap, 3)),
        torch.zeros(ts.base.cap), torch.zeros(ts.env.cap))
    assert float(out.env_acc_map.detach().max()) > 0.5
    rng = np.random.default_rng(4)
    loss = torch.sum(out.env_rgb_map * torch.tensor(
        rng.normal(size=(H, W, 3)).astype(np.float32)))
    grads = torch.autograd.grad(loss, [exyz, bparams.xyz, bparams.rotation,
                                       bparams.scaling], allow_unused=True)
    assert float(grads[0].abs().sum()) > 0
    total = sum(float(g.abs().sum()) for g in grads[1:] if g is not None)
    assert (total == 0.0) == detach, total

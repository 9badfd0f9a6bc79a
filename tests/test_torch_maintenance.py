"""Parity of the port's EnvGS maintenance with the JAX package: the four
3DGS-DR resets, and `maintain` over a compressed schedule (every event of
the schedule, in order, from the same numpy states and the same draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussians as jg
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import trainer as jtrain
from envgs_tpu_torch import bench
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.train import trainer as ttrain

FIELDS = tg.STATIC_FIELDS  # the temporal fields are None in these pools


def _pool_arrays(rng, P, cap, seed):
    """A mid-training surfel pool as numpy dicts (params, stats, mu, nu)."""
    xyz = rng.normal(size=(P, 3)).astype(np.float32)
    jp = jg.create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=cap,
                        sh_degree=2, seed=seed)
    params = {k: np.asarray(v) for k, v in jp.params._asdict().items()
              if v is not None}
    scales = rng.uniform(0.002, 0.06, (cap, 2))
    scales[: cap // 3] *= 0.1  # small enough to clone
    params["scaling"] = np.log(scales).astype(np.float32)
    params["opacity"] = rng.normal(size=(cap, 1)).astype(np.float32) * 2
    params["specular"] = (rng.normal(size=(cap, 1)) * 3 - 2).astype(np.float32)
    stats = {k: np.asarray(v) for k, v in jp.stats._asdict().items()}
    mu, nu = ({k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in params.items()} for _ in range(2))
    return dict(params=params, stats=stats, mu=mu, nu=nu, step=7,
                max_sh_degree=2)


def _fresh_stats(rng, stats):
    """Densification statistics as a few training steps would leave them."""
    act, cap = stats["active"], stats["active"].shape[0]
    denom = np.where(act, rng.integers(0, 4, cap), 0).astype(np.float32)
    return dict(stats,
                max_radii2d=(rng.random(cap) * 30).astype(np.float32),
                grad_accum=(rng.random(cap) * 6e-4 * denom).astype(np.float32),
                weight_accum=(rng.random(cap) * denom).astype(np.float32),
                denom=denom)


def _jax_state(d, key):
    def pool(s):
        tree = lambda g: jg.GaussianParams(  # noqa: E731
            **{k: jnp.asarray(v) for k, v in s[g].items()})
        return (jg.GaussianPool(
            tree("params"),
            jg.GaussianStats(**{k: jnp.asarray(v)
                                for k, v in s["stats"].items()}),
            s["max_sh_degree"]),
            jopt.AdamState(tree("mu"), tree("nu"),
                           jnp.asarray(s["step"], jnp.int32)))
    (b, ob), (e, oe) = pool(d["base"]), pool(d["env"])
    return jtrain.TrainState(b, e, ob, oe, key)


def _jax_to_numpy(state):
    def pool(p, opt):
        arrays = lambda t: {k: np.asarray(v)  # noqa: E731
                            for k, v in t._asdict().items() if v is not None}
        return dict(params=arrays(p.params), stats=arrays(p.stats),
                    mu=arrays(opt.mu), nu=arrays(opt.nu), step=int(opt.step),
                    max_sh_degree=p.max_sh_degree)
    return {"base": pool(state.base, state.opt_base),
            "env": pool(state.env, state.opt_env)}


def _assert_states(got, want, it, rtol=0.0):
    for name in ("base", "env"):
        g, w = got[name], want[name]
        assert g["step"] == w["step"]
        for k, v in w["stats"].items():
            np.testing.assert_array_equal(g["stats"][k], v,
                                          err_msg=f"it {it} {name} stats {k}")
        for grp in ("params", "mu", "nu"):
            for k, v in w[grp].items():
                np.testing.assert_allclose(
                    g[grp][k], v, rtol=rtol, atol=rtol,
                    err_msg=f"it {it} {name} {grp} {k}")


@pytest.fixture
def pools():
    rng = np.random.default_rng(11)
    d = {"base": _pool_arrays(rng, 70, 200, 0),
         "env": _pool_arrays(rng, 50, 128, 1)}
    return rng, d


@pytest.mark.parametrize("event", [
    "reset_specular", "reset_specular_all", "enlarge_opacity",
    "enlarge_scaling", "distort_color"])
def test_resets_match_jax(pools, event):
    """Each reset of the 3DGS-DR schedule on one mid-training pool: the
    new parameters equal the JAX package's (distort_color on JAX's own
    uniform draw), the moments of the touched field zeroed, the others
    kept."""
    _, d = pools
    js = _jax_state(d, jax.random.PRNGKey(0))
    ts = ttrain.state_from_numpy(d)
    jadam = (js.opt_base.mu, js.opt_base.nu)
    tadam = (ts.opt_base.mu, ts.opt_base.nu)
    key = jax.random.PRNGKey(5)
    field = dict(reset_specular="specular", reset_specular_all="specular",
                 enlarge_opacity="opacity", enlarge_scaling="scaling",
                 distort_color="features_dc")[event]
    if event.startswith("reset_specular"):
        kw = dict(value=0.02, reset_all=event.endswith("all"))
        jp, ja = jg.reset_specular(js.base, jadam, **kw)
        tp, ta = tg.reset_specular(ts.base, tadam, **kw)
    elif event == "distort_color":
        jp, ja = jg.distort_color(js.base, jadam, key)
        u = np.asarray(jax.random.uniform(key, js.base.params.features_dc.shape))
        tp, ta = tg.distort_color(ts.base, tadam, uniform=torch.tensor(u))
    else:
        jp, ja = getattr(jg, event)(js.base, jadam)
        tp, ta = getattr(tg, event)(ts.base, tadam)
    changed = 0
    for k in FIELDS:
        want = np.asarray(getattr(jp.params, k))
        np.testing.assert_array_equal(getattr(tp.params, k).numpy(), want,
                                      err_msg=k)
        changed += int((want != d["base"]["params"][k]).sum()) * (k == field)
        for m in (0, 1):
            np.testing.assert_array_equal(getattr(ta[m], k).numpy(),
                                          np.asarray(getattr(ja[m], k)),
                                          err_msg=f"moment {m} {k}")
            assert (k == field) == (not getattr(ta[m], k).any())
    assert changed > 10  # the event did move its field


def test_distort_color_draws_from_the_generator(pools):
    """Without handed-in draws the noise comes from the generator: the same
    seed gives the same pool, within +-rng_range, low-specular splats only."""
    _, d = pools
    ts = ttrain.state_from_numpy(d)
    outs = [tg.distort_color(ts.base, None,
                             torch.Generator().manual_seed(3))[0]
            for _ in range(2)]
    a, b = (o.params.features_dc for o in outs)
    assert torch.equal(a, b)
    delta = (a - ts.base.params.features_dc).abs().amax((1, 2))
    low = torch.sigmoid(ts.base.params.specular).amax(-1) <= 0.05
    assert float(delta.max()) <= 0.4 and (delta[~low] == 0).all()
    assert (delta[low] > 0).all()


def _draws(key, it, sched, cap_b, cap_e, n_eps):
    """The draws JAX's maintain makes at iteration `it` from `key`, in its
    order: a key split per random event, then densify's split per child."""
    draws = {}
    for name in ttrain.due_events(sched, it):
        if name in ("densify_base", "densify_env"):
            key, k1 = jax.random.split(key)
            cap = cap_b if name == "densify_base" else cap_e
            eps = []
            for _ in range(n_eps):
                k1, sub = jax.random.split(k1)
                eps.append(torch.tensor(np.asarray(
                    jax.random.normal(sub, (cap, 3)))))
            draws[name] = eps
        elif name == "color_sabotage":
            key, k1 = jax.random.split(key)
            draws[name] = torch.tensor(np.asarray(
                jax.random.uniform(k1, (cap_b, 1, 3))))
    return draws


def test_maintain_matches_jax_over_compressed_schedule(pools, monkeypatch):
    """Every iteration of the compressed 30-iteration schedule: the port
    fires the events JAX fires, in JAX's order (JAX's logged by wrapping its
    pool functions, run unjitted), and both states stay equal: `active`,
    statistics and SH degrees exactly, parameters and moments within 1e-6
    (densify's exp/log of the child scales). Fresh statistics are written
    into both states before every iteration, so every densify has work."""
    rng, d = pools
    sched_kw = bench.compressed_schedule()._asdict()
    jsched, tsched = (cls(**sched_kw) for cls in (jtrain.ScheduleConfig,
                                                  ttrain.ScheduleConfig))
    dkw = dict(spatial_scale=0.4)
    caps = {d["base"]["params"]["xyz"].shape[0]: "base",
            d["env"]["params"]["xyz"].shape[0]: "env"}
    jlog = []

    def logged(fn, name, per_pool=True):
        def wrapper(pool, *a, **k):
            jlog.append(f"{name}_{caps[pool.cap]}" if per_pool else name)
            return fn(pool, *a, **k)
        return wrapper

    for fn, name, per_pool in (
            ("oneup_sh_degree", "oneup", True),
            ("densify_and_prune", "densify", True),
            ("reset_opacity", "reset_opacity", True),
            ("reset_specular", "reset_specular", False),
            ("distort_color", "color_sabotage", False),
            ("enlarge_opacity", "normal_prop", False)):
        monkeypatch.setattr(jg, fn, logged(getattr(jg, fn), name, per_pool))
    jmaintain = jtrain.make_maintenance(jsched, jg.DensifyConfig(**dkw),
                                        jg.DensifyConfig(**dkw))
    tmaintain = ttrain.make_maintenance(tsched, tg.DensifyConfig(**dkw),
                                        tg.DensifyConfig(**dkw))
    n_eps = tg.DensifyConfig().split_n + tg.DensifyConfig().weight_split_n
    key = jax.random.PRNGKey(1234)
    tlog, fired = [], set()
    with jax.disable_jit():
        for it in range(tsched.total_iters):
            for name in ("base", "env"):
                d[name]["stats"] = _fresh_stats(rng, d[name]["stats"])
            key, mkey = jax.random.split(key)
            jlog.clear()
            jstate = jmaintain(_jax_state(d, key), it, mkey)
            tlog.clear()
            tstate = tmaintain(
                ttrain.state_from_numpy(d), it, log=tlog,
                draws=_draws(mkey, it, tsched, 200, 128, n_eps))
            assert [e for _, e in tlog] == jlog, it
            assert all(i == it for i, _ in tlog)
            fired.update(jlog)
            want = _jax_to_numpy(jstate)
            _assert_states(ttrain.state_to_numpy(tstate), want, it, rtol=1e-6)
            d = want
    assert fired == set(ttrain.EVENTS)
    # an opacity reset suppresses the two tricks due at the same iteration
    assert ttrain.due_events(tsched, 18) == ["reset_opacity_base",
                                             "reset_specular"]
    assert "color_sabotage" in ttrain.due_events(tsched, 12)
    assert int(d["base"]["stats"]["active"].sum()) != 70


def test_maintain_draws_from_the_state_generator(pools):
    """Without handed-in draws, densify and color sabotage draw from the
    state's generator: two runs from one seed agree, and the generator
    survives the numpy bridge mid-run."""
    rng, d = pools
    d["base"]["stats"] = _fresh_stats(rng, d["base"]["stats"])
    sched = bench.compressed_schedule()
    maintain = ttrain.make_maintenance(sched, tg.DensifyConfig(spatial_scale=0.4),
                                       tg.DensifyConfig(spatial_scale=0.4))

    def run(bridge):
        st = ttrain.state_from_numpy(d)._replace(
            gen=torch.Generator().manual_seed(9))
        st = maintain(st, 3)  # densify_base
        if bridge:
            st = ttrain.state_from_numpy(ttrain.state_to_numpy(st))
        return maintain(st, 12)  # color sabotage (+ SH one-ups)

    a, b = run(False), run(True)
    for x, y in zip(tg.present(a.base.params), tg.present(b.base.params)):
        assert torch.equal(x, y)
    assert int(a.base.stats.active.sum()) > 70
    assert not torch.equal(a.base.params.features_dc,
                           ttrain.state_from_numpy(d).base.params.features_dc)

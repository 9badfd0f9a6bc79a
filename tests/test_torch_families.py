"""The port's family loops (train/families.py) against the JAX package's:
FamilyLoop's save / restore and latest.npz crossing both ways (the STGS
state, and PointPlanes' weights with their optax state), `train -c
configs/exps/stgs_synthetic.yaml` and `point_planes_synthetic.yaml` cut
down (16x16 views, 3 iterations, densification off) through the port's
command line against JAX's loops, a kill and resume, and the modes the
families refuse.

The whole loops are held to JAX's exact oracle (`ref`, which JAX's loops
pick on a CPU): the loss of each iteration within LOSS_ATOL and the final
arrays as below. PointPlanes' weights come from `jax.random`, which torch
cannot replay: the port's run resumes from a latest.npz that JAX's
FamilyLoop wrote at iteration 0.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.engine import TRAINERS as JTRAINERS
from envgs_tpu.engine import load_config as jload
from envgs_tpu.models import point_planes as jpp
from envgs_tpu.models import stgs as js
from envgs_tpu.train import families as jfam
from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import TRAINERS, Config
from envgs_tpu_torch.models import point_planes as tpp
from envgs_tpu_torch.models import stgs as ts
from envgs_tpu_torch.train import families as tfam
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STGS_YAML = os.path.join(ROOT, "configs", "exps", "stgs_synthetic.yaml")
PP_YAML = os.path.join(ROOT, "configs", "exps", "point_planes_synthetic.yaml")
NERF_YAML = os.path.join(ROOT, "configs", "exps", "nerf_synthetic.yaml")
NEUS_YAML = os.path.join(ROOT, "configs", "exps", "neus_synthetic.yaml")
ENERF_YAML = os.path.join(ROOT, "configs", "exps", "enerf_synthetic.yaml")
# whole loops: the loss of each iteration (the port's plain blends against
# JAX's oracle, the synthetic views as each package renders them)
LOSS_ATOL = 1e-4
# the final arrays of a loop: positions absolute, the rest per array
# max|d| / max|ref| (Adam's quotient turns gradients of rounding size into
# moves of a fraction of the learning rate: rotations, isotropic at start,
# are left out, as in tests/test_torch_gaussiant_loop.py)
POS_ATOL = 1e-5
GRAD_RTOL = 5e-4

pytestmark = pytest.mark.usefixtures("one_thread")


def _cut(out_root, *extra):
    """The overrides that cut a shipped family config down: 4 views of
    16x16, 3 iterations logged each, densification off, no recorder."""
    return ["dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=4",
            f"out_root={out_root}", "runner_cfg.ep_iter=3",
            "runner_cfg.log_interval=1", "runner_cfg.record=false",
            *extra]


def _stgs_state(seed=0, cap=64):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    pool = js.init_stgs_pool(xyz, rng.random(40).astype(np.float32),
                             rng.random((40, 3)).astype(np.float32), cap,
                             js.STGSConfig(sh_degree=1))
    state = js.init_stgs_state(pool)
    # moments and a step that are not zero, so that every leaf is checked
    return state._replace(opt=jax.tree_util.tree_map(
        lambda x: x + 0.5 if x.dtype == jnp.float32 else x + 3, state.opt))


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _loop_cfg(out_root, exp, **rcfg):
    return Config.wrap({"exp_name": exp, "out_root": str(out_root),
                        "runner_cfg": {"record": False, **rcfg}})


def test_family_loop_save_and_restore(tmp_path):
    """FamilyLoop: a checkpoint every save_latest_every iterations and at
    the end; restore gives the saved leaves and iteration, the trees as
    given on another layout or with resume off."""
    jstate = _stgs_state()
    state = ts.stgs_state_from_numpy(dict(
        params={k: np.asarray(v) for k, v in jstate.pool.params._asdict()
                .items() if v is not None},
        stats={k: np.asarray(v) for k, v in
               jstate.pool.stats._asdict().items()},
        mu={k: np.asarray(v) for k, v in jstate.opt.mu._asdict().items()
            if v is not None},
        nu={k: np.asarray(v) for k, v in jstate.opt.nu._asdict().items()
            if v is not None},
        step=int(jstate.opt.step), max_sh_degree=1))
    loop = tfam.FamilyLoop(_loop_cfg(tmp_path, "a", save_latest_every=2,
                                     ep_iter=5), "stgs")
    loop.step_done(0, {"loss": torch.tensor(0.5)}, state, ())
    assert not os.path.exists(loop.latest)
    loop.step_done(1, {"loss": torch.tensor(0.5)}, state, ())
    assert int(np.load(loop.latest)["iter"]) == 2
    loop.finish(state, ())
    assert int(np.load(loop.latest)["iter"]) == 5
    fresh = ts.init_stgs_state(ts.init_stgs_pool(
        np.zeros((3, 3), np.float32), np.zeros(3, np.float32), None, 64,
        ts.STGSConfig(sh_degree=1), device="cpu"))
    back, opt, start = tfam.FamilyLoop(_loop_cfg(tmp_path, "a"),
                                       "stgs").restore(fresh, ())
    assert start == 5 and opt == () and back.pool.max_sh_degree == 1
    got, want = tfam.tree_flatten(back), tfam.tree_flatten(state)
    assert len(got) == len(want) == 40
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = ts.init_stgs_state(ts.init_stgs_pool(
        np.zeros((3, 3), np.float32), np.zeros(3, np.float32), None, 32,
        ts.STGSConfig(sh_degree=1), device="cpu"))
    assert tfam.FamilyLoop(_loop_cfg(tmp_path, "a"), "stgs").restore(
        other, ())[2] == 0
    assert tfam.FamilyLoop(_loop_cfg(tmp_path, "a", resume=False),
                           "stgs").restore(fresh, ())[2] == 0


def _pp_pair():
    """JAX PointPlanes weights and an optax state with non-zero moments
    after one update, and the port's module and AdamState from them."""
    import optax

    cfg = jpp.PointPlanesConfig(n_frames=4)
    params = cfg.init(jax.random.PRNGKey(0),
                      jnp.asarray(np.random.default_rng(0).uniform(
                          -1, 1, (30, 3)), jnp.float32))
    opt = optax.adam(5e-3)
    ostate = opt.init(params)
    grads = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 0.1, params)
    _, ostate = opt.update(grads, ostate, params)
    tcfg = tpp.PointPlanesConfig(n_frames=4)
    model = tpp.point_planes_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    olv = _jax_leaves(ostate)
    n = len(tpp.flat_params(model))
    tstate = tpp.AdamState(torch.tensor(olv[0]),
                           [torch.tensor(x) for x in olv[1:1 + n]],
                           [torch.tensor(x) for x in olv[1 + n:]])
    return (params, ostate), (model, tstate), tcfg


@pytest.mark.parametrize("family", ["stgs", "point_planes"])
def test_latest_npz_crosses_both_ways(tmp_path, family):
    """A latest.npz of JAX's FamilyLoop resumes in the port's and the
    reverse, leaf for leaf (JAX's tree_flatten order: NamedTuples by field,
    dicts by sorted key, None and a pool's max_sh_degree no leaves)."""
    if family == "stgs":
        jstate = _stgs_state(1)
        jtrees = (jstate, ())
        tstate = ts.init_stgs_state(ts.init_stgs_pool(
            np.zeros((3, 3), np.float32), np.zeros(3, np.float32), None, 64,
            ts.STGSConfig(sh_degree=1), device="cpu"))
        ttrees = (tstate, ())
    else:
        jtrees, (model, tstate), tcfg = _pp_pair()
        fresh = tcfg.init(np.zeros((30, 3), np.float32))
        ttrees = (fresh.jax_tree(), tpp.adam_init(fresh))
    want = [_jax_leaves(t) for t in jtrees]
    jcfg = _loop_cfg(tmp_path / "j2t", family)
    jfam.FamilyLoop(jcfg, family).save(7, *jtrees)
    p, o, start = tfam.FamilyLoop(_loop_cfg(tmp_path / "j2t", family),
                                  family).restore(*ttrees)
    assert start == 7
    for tree, w in zip((p, o), want):
        got = tfam.tree_flatten(tree)
        assert len(got) == len(w)
        for a, b in zip(got, w):
            np.testing.assert_array_equal(a.numpy(), b)
    # the reverse: the port's trees into JAX's loop
    if family == "stgs":
        src = (p, o)
        blank = (js.init_stgs_state(js.init_stgs_pool(
            np.zeros((3, 3), np.float32), np.zeros(3, np.float32), None, 64,
            js.STGSConfig(sh_degree=1))), ())
    else:
        src = (model.jax_tree(), tstate)
        blank = jax.tree_util.tree_map(jnp.zeros_like, jtrees)
    tfam.FamilyLoop(_loop_cfg(tmp_path / "t2j", family), family).save(9, *src)
    jp, jo, jstart = jfam.FamilyLoop(_loop_cfg(tmp_path / "t2j", family),
                                     family).restore(*blank)
    assert jstart == 9
    for tree, w in zip((jp, jo), want):
        got = _jax_leaves(tree)
        assert len(got) == len(w)
        for a, b in zip(got, w):
            np.testing.assert_array_equal(a, b)


def _recording(monkeypatch, module, name, losses, key, loss_at):
    make = getattr(module, name)

    def make_step(*args, **kw):
        out = make(*args, **kw)
        step = out[1] if isinstance(out, tuple) else out

        def recorded(*a, **k):
            res = step(*a, **k)
            losses[key].append(float(res[loss_at]["loss"]))
            return res
        return (out[0], recorded) if isinstance(out, tuple) else recorded
    monkeypatch.setattr(module, name, make_step)


def _close(got, want, rtol=GRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        name, np.abs(got - want).max(), scale)


def test_stgs_config_entry_point_matches_jax(tmp_path, monkeypatch):
    """`train -c configs/exps/stgs_synthetic.yaml` cut down, through the
    port's command line (TRAINERS: STGSModel) and JAX's train_stgs: the
    loss of each iteration within LOSS_ATOL; the final pool's positions
    within POS_ATOL, its other arrays (the temporal ones among them) but
    rotations within GRAD_RTOL of each array's largest; point_cloud.ply,
    latest.npz and metrics.json (PSNR within 1e-4 of JAX's)."""
    losses = {"jax": [], "port": []}
    _recording(monkeypatch, js, "make_stgs_train_step", losses, "jax", 1)
    _recording(monkeypatch, ts, "make_stgs_train_step", losses, "port", 1)
    over = ["model_cfg.sampler_cfg.n_points=128",
            "model_cfg.sampler_cfg.pool_cap=256",
            "model_cfg.sampler_cfg.densification_interval=1000000"]
    jstate = JTRAINERS.get("STGSModel")(jload(
        STGS_YAML, overrides=_cut(tmp_path / "jax", *over), root=ROOT))
    jsum = json.load(open(tmp_path / "jax" / "result" / "stgs_synthetic"
                          / "metrics.json"))["summary"]
    assert isinstance(jsum, dict)
    tstate, summary = cli.main(["train", "-c", STGS_YAML,
                                *_cut(tmp_path / "port", *over)],
                               device="cpu")
    assert TRAINERS.get("STGSModel") is tfam.train_stgs
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=LOSS_ATOL)
    del jstate  # JAX returns its metrics dict
    model_dir = tmp_path / "port" / "trained_model" / "stgs_synthetic"
    assert (model_dir / "point_cloud.ply").exists()
    assert int(np.load(model_dir / "latest.npz")["iter"]) == 3
    jz = np.load(tmp_path / "jax" / "trained_model" / "stgs_synthetic"
                 / "latest.npz")
    names = [f for f, v in tstate.pool.params._asdict().items()
             if v is not None]
    for i, name in enumerate(names):
        got, want = getattr(tstate.pool.params, name).numpy(), jz[f"p{i}"]
        if name == "xyz":
            np.testing.assert_allclose(got, want, atol=POS_ATOL, rtol=0)
        elif name not in ("rotation", "specular", "roughness"):
            _close(got, want, name=name)
    s = summary["summary"]
    assert np.isfinite(s["psnr_mean"])
    np.testing.assert_allclose(s["psnr_mean"], jsum["psnr_mean"], rtol=1e-4)


def test_point_planes_config_entry_point_matches_jax(tmp_path, monkeypatch):
    """`train -c configs/exps/point_planes_synthetic.yaml` cut down, the
    port resuming JAX's initial weights from a latest.npz JAX's FamilyLoop
    wrote at iteration 0: the loss of each iteration within LOSS_ATOL, the
    final weights of every leaf within GRAD_RTOL of the leaf's largest,
    metrics.json (PSNR within 1e-4 of JAX's). With the config's opaque
    points JAX's oracle and its kernel give other gradients (the port
    follows the kernel: tests/test_torch_point_planes.py); the points here
    are half transparent (alpha_shift 0), where the two agree."""
    losses = {"jax": [], "port": []}
    _recording(monkeypatch, jpp, "make_point_planes_train_step", losses,
               "jax", 2)
    _recording(monkeypatch, tpp, "make_point_planes_train_step", losses,
               "port", 1)
    # alpha_shift 0: the config's opaque points (alpha at the blend's 0.99
    # clamp) part JAX's kernel and its oracle (ROADMAP Queue 3)
    over = ["model_cfg.sampler_cfg.n_points=256",
            "model_cfg.sampler_cfg.alpha_shift=0.0"]
    jcfg = jload(PP_YAML, overrides=_cut(tmp_path / "jax", *over),
                 root=ROOT)
    JTRAINERS.get("PointPlanesSampler")(jcfg)
    # JAX's initial weights (its loop's draws) as a latest.npz at 0
    pcfg = jpp.PointPlanesConfig(n_frames=4, raster_backend="ref",
                                 pair_cap=16384)
    pts = np.random.default_rng(0).uniform(-1, 1, (256, 3)).astype(
        np.float32)
    import optax

    params = pcfg.init(jax.random.PRNGKey(0), jnp.asarray(pts))
    tcfg = jload(PP_YAML, overrides=_cut(tmp_path / "port", *over),
                 root=ROOT)
    jfam.FamilyLoop(tcfg, "point_planes").save(
        0, params, optax.adam(5e-3).init(params))
    model, summary = cli.main(["train", "-c", PP_YAML,
                               *_cut(tmp_path / "port", *over)],
                              device="cpu")
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=LOSS_ATOL)
    jz = np.load(tmp_path / "jax" / "trained_model" /
                 "point_planes_synthetic" / "latest.npz")
    got = tpp.flat_params(model)
    assert int(jz["iter"]) == 3 and len(got) == 31
    for i, g in enumerate(got):
        _close(g.detach().numpy(), jz[f"p{i}"], name=f"leaf {i}")
    jsum = json.load(open(tmp_path / "jax" / "result" /
                          "point_planes_synthetic" / "metrics.json"))
    np.testing.assert_allclose(summary["summary"]["psnr_mean"],
                               jsum["summary"]["psnr_mean"], rtol=1e-4)


def test_resume_after_kill(tmp_path, capsys):
    """A run that ends at iteration 4 with a checkpoint every 2, then the
    same config at 6 iterations: it resumes at 4 and runs 2 more."""
    over = ["model_cfg.sampler_cfg.n_points=64",
            "model_cfg.sampler_cfg.pool_cap=128",
            "model_cfg.sampler_cfg.densification_interval=1000000",
            "runner_cfg.save_latest_every=2", "dataset_cfg.n_views=2",
            "dataset_cfg.eval_every=0"]
    state, summary = cli.main(["train", "-c", STGS_YAML,
                               *_cut(tmp_path, *over),
                               "runner_cfg.ep_iter=4"], device="cpu")
    assert summary is None
    out = capsys.readouterr().out
    assert "[resume]" not in out and "iter 3/4" in out
    again, _ = cli.main(["train", "-c", STGS_YAML, *_cut(tmp_path, *over),
                         "runner_cfg.ep_iter=6"], device="cpu")
    out = capsys.readouterr().out
    assert "@ iter 4" in out and "iter 3/6" not in out and "iter 5/6" in out
    z = np.load(tmp_path / "trained_model" / "stgs_synthetic" / "latest.npz")
    assert int(z["iter"]) == 6
    assert again.opt.step == state.opt.step + 2


@pytest.mark.parametrize("mode", ["test", "render"])
def test_other_modes_refuse_the_families(tmp_path, mode):
    """The JAX package has only `train` for the families: the port's other
    modes refuse each by its name."""
    for path, name in ((STGS_YAML, "STGSModel"),
                       (PP_YAML, "PointPlanesSampler"),
                       (NERF_YAML, "VolumetricVideoNetwork"),
                       (NEUS_YAML, "NeusNetwork"),
                       (ENERF_YAML, "CostVolumeSampler")):
        with pytest.raises(NotImplementedError, match=name):
            cli.main([mode, "-c", path, f"out_root={tmp_path}"],
                     device="cpu")

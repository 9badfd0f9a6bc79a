"""The port's training run: three Runner iterations (a densify and an
opacity reset among them) against the JAX package's maintain + step on the
same views, the `smoke` entry point end to end on the CPU, and the rules
of the package (no JAX import, the card by default, unported modes
raise)."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envgs_tpu_torch
from envgs_tpu.models import envgs as jenv
from envgs_tpu.models import gaussians as jg
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch import cli
from envgs_tpu_torch.data import synthetic
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.ops.raster_blend import CHUNK
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.train.runner import Runner
from envgs_tpu_torch.utils.timer import read_spans
from torch_threads import one_thread  # noqa: F401

H = W = 32
# the gradient bound of test_torch_train_step.py, per array as max|d| /
# max|ref|, here over three steps; and the two packages' Adam on the same
# gradients, per array against its largest change
GRAD_RTOL = 5e-4
ADAM_RTOL = 1e-6
SCHED = dict(epochs=1, ep_iter=3, densify_from_iter=0, densify_until_iter=100,
             init_densification_interval=1, norm_densification_interval=1,
             opacity_reset_interval=2, reflection_start_iter=0)
DENS = dict(spatial_scale=2.5, densify_grad_threshold=5e-5)
MODEL = dict(pair_cap=2 ** 13, env_pair_cap=2 ** 13, reflection_start_iter=0)
LOSS = dict(perc_loss_weight=0.0)


pytestmark = pytest.mark.usefixtures("one_thread")


def _start_state(rng, scene):
    """A mid-run JAX train state over the scene's ground-truth geometry
    (perturbed), with smooth Adam moments."""
    act = scene.gt_base.stats.active.numpy()
    xyz = scene.gt_base.params.xyz.numpy()[act]
    xyz = xyz + rng.normal(scale=0.03, size=xyz.shape).astype(np.float32)
    base = jg.create_pool(xyz, rng.random(xyz.shape).astype(np.float32),
                          cap=1280, sh_degree=1, init_opacity=0.5)
    base = base._replace(params=base.params._replace(
        specular=jnp.full((1280, 1), float(jg.logit(jnp.asarray(0.3))))))
    genv = scene.gt_env  # the dome's geometry, random colors
    env = jg.create_pool(genv.params.xyz.numpy(),
                         rng.random((genv.cap, 3)).astype(np.float32),
                         cap=genv.cap, sh_degree=1, init_opacity=0.5)
    env = env._replace(params=env.params._replace(
        rotation=jnp.asarray(genv.params.rotation.numpy()),
        scaling=jnp.asarray(genv.params.scaling.numpy())))
    state = jtrain.init_train_state(base, env, jax.random.PRNGKey(0))

    def moments(pool):
        like = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda p: jnp.asarray(s(p.shape).astype(np.float32)), pool.params)
        return jopt.AdamState(like(lambda s: rng.normal(size=s) * 1e-3),
                              like(lambda s: rng.random(s) * 1e-5 + 1e-6),
                              jnp.asarray(10, jnp.int32))

    return state._replace(opt_base=moments(base), opt_env=moments(env))


def _to_numpy(state):
    def pool(p, opt):
        arrays = lambda t: {k: np.asarray(v)  # noqa: E731
                            for k, v in t._asdict().items() if v is not None}
        return dict(params=arrays(p.params), stats=arrays(p.stats),
                    mu=arrays(opt.mu), nu=arrays(opt.nu), step=int(opt.step),
                    max_sh_degree=p.max_sh_degree)
    return {"base": pool(state.base, state.opt_base),
            "env": pool(state.env, state.opt_env)}


def _draws(key, it, sched, cap_b, n_eps):
    """The split draws JAX's maintain makes at `it` from `key` (only the
    base densify draws in this schedule)."""
    draws = {}
    for name in ttrain.due_events(sched, it):
        if name == "densify_base":
            key, k1 = jax.random.split(key)
            eps = []
            for _ in range(n_eps):
                k1, sub = jax.random.split(k1)
                eps.append(torch.tensor(np.asarray(
                    jax.random.normal(sub, (cap_b, 3)))))
            draws[name] = eps
    return draws


def _assert_step(got, grads, s0, want, j0, it, what):
    """One step of the port (state `got` from state `s0` with gradients
    `grads`) against JAX's (state `want` from its state `j0` after the
    same maintenance): visit counts equal but for the step test's flip
    allowance, every gradient within GRAD_RTOL of its array's largest, and
    the JAX package's Adam on the port's gradients giving the port's
    parameters and moments."""
    b1 = 0.9
    for name in ("base", "env"):
        g, w, z = got[name], want[name], s0[name]
        assert g["step"] == w["step"]
        np.testing.assert_array_equal(g["stats"]["active"],
                                      w["stats"]["active"])
        # a splat that meets its pixels or rays only at the 1/255 alpha
        # floor can be seen by one package and not the other
        flip = g["stats"]["denom"] != w["stats"]["denom"]
        assert flip.sum() <= 2, (what, name, flip.sum())
        assert (g["stats"]["weight_accum"][flip] < 1e-3).all()
        for k, gp in grads[name].items():
            # JAX's gradient, read back from its first moment (mu' = b1 mu
            # + (1 - b1) g where g != 0, else mu): exact to two float32
            # roundings of the moment
            mu0, mu1 = (d[name]["mu"][k].astype(np.float64)
                        for d in (j0, want))
            gj = np.where(mu1 != mu0, (mu1 - b1 * mu0) / (1 - b1), 0.0)
            atol = 2 * np.spacing(np.float32(np.abs(mu0).max())) / (1 - b1)
            err = np.abs(gp - gj)[~flip].max()
            assert err <= GRAD_RTOL * np.abs(gj[~flip]).max() + atol, (
                what, name, k, err, np.abs(gj).max())
        # the optimizer: JAX's Adam from the port's state after maintenance
        # on the port's gradients against what the port stored. (Parameters
        # are not compared across the two packages' gradients: Adam's
        # quotient turns a gradient of rounding noise into a move of the
        # size of the learning rate wherever the second moment is as
        # small, whatever the gradient's size.)
        tree = lambda d: jg.GaussianParams(  # noqa: E731
            *(jnp.asarray(d[f]) if f in d else None
              for f in jg.GaussianParams._fields))
        new_p, new_opt = jopt.sparse_adam_update(
            tree(z["params"]), tree(grads[name]),
            jopt.AdamState(tree(z["mu"]), tree(z["nu"]),
                           jnp.asarray(z["step"], jnp.int32)),
            jopt.lr_tree_for(jnp.asarray(it), jopt.LRConfig()))
        for grp, ref in (("params", new_p), ("mu", new_opt.mu),
                         ("nu", new_opt.nu)):
            for k in z[grp]:
                d_want = np.asarray(getattr(ref, k)) - z[grp][k]
                # at iterations 0-2 the xyz learning rate is in its warm-up
                # and a step moves a position by tens of float32 ulps of
                # the position itself: allow the stored value two of them
                ulps = 2 * np.spacing(np.abs(z[grp][k]).max()) \
                    if grp == "params" else 0.0
                err = np.abs(g[grp][k] - z[grp][k] - d_want).max()
                assert err <= ADAM_RTOL * np.abs(d_want).max() + ulps, (
                    what, name, grp, k, err, np.abs(d_want).max())


def test_runner_iterations_match_jax(tmp_path):
    """Three Runner iterations on three views in the runner's order, with
    maintenance before each step (densify at 1 and 2, the opacity reset at
    2) and JAX's split draws handed to the port, against the JAX package's
    maintain + step. Each iteration starts from JAX's state of that
    iteration (written into the runner as its maintenance is called), so a
    densify decision at a threshold cannot send the two runs down different
    slot assignments: per iteration, the state after maintenance equal
    (masks and slots exactly, arrays within 1e-6), the step's gradients
    within the step test's bound on every splat, and the JAX package's
    Adam on the port's gradients giving the port's state; the event log
    and the runner's files and resume checked at the end."""
    rng = np.random.default_rng(4)
    scene = synthetic.make_scene(n_views=3, H=H, W=W, device="cpu")
    state = _start_state(rng, scene)
    start = _to_numpy(state)
    views = [dict(rgb=scene.images[i], msk=scene.masks[i],
                  norm=scene.normals[i], camera=scene.cams[i])
             for i in range(3)]
    order = np.random.default_rng(0).permutation(3)

    # ---- the JAX package: maintain + step, as its runner calls them ----
    jsched = jtrain.ScheduleConfig(**SCHED)
    jmaintain = jtrain.make_maintenance(jsched, jg.DensifyConfig(**DENS),
                                        jg.DensifyConfig(**DENS))
    c0 = scene.cams[0]
    jcam = make_camera(H, W, c0.K.numpy(), c0.R.numpy(), c0.T.numpy(),
                       c0.znear, c0.zfar)
    jstep = jtrain.make_train_step(
        jcam, jenv.EnvGSConfig(raster_backend="pallas_interp",
                               tracer_backend="tiled_interp", **MODEL),
        jsup.LossConfig(**LOSS), jopt.LRConfig(), jopt.LRConfig(),
        donate=False, has_norm=True)
    key = jax.random.PRNGKey(1234)
    mkeys, jmaint, jpost = [], [], []
    for it in range(3):
        key, mkey = jax.random.split(key)
        mkeys.append(mkey)
        state = jmaintain(state, it, mkey)
        jmaint.append(_to_numpy(state))
        v = views[int(order[it])]
        cam = v["camera"]
        state, jstats = jstep(
            state, jtrain.Batch(*(jnp.asarray(v[k])
                                  for k in ("rgb", "msk", "norm"))),
            jnp.asarray(cam.K.numpy()), jnp.asarray(cam.R.numpy()),
            jnp.asarray(cam.T.numpy()), jnp.asarray(it))
        jpost.append(_to_numpy(state))

    # ---- the port: the Runner, JAX's draws handed to its maintenance ----
    ts = ttrain.state_from_numpy(start)
    make = lambda **kw: Runner(  # noqa: E731
        views, ts.base, ts.env, tenv.EnvGSConfig(**MODEL),
        tsup.LossConfig(**LOSS), ttrain.ScheduleConfig(**SCHED),
        tg.DensifyConfig(**DENS), tg.DensifyConfig(**DENS), topt.LRConfig(),
        topt.LRConfig(), exp_name="three", out_root=str(tmp_path),
        log_every=1, **kw)
    runner = make(resume=False)
    runner.state = ts._replace(gen=runner.state.gen)
    maintain, tmaint, tpost = runner.maintain, [], []
    n_eps = tg.DensifyConfig().split_n + tg.DensifyConfig().weight_split_n

    def with_jax_draws(st, it, log=None):
        if it > 0:
            tpost.append(ttrain.state_to_numpy(st))
            st = ttrain.state_from_numpy(jpost[it - 1])._replace(gen=st.gen)
        st = maintain(st, it, log=log, draws=_draws(
            mkeys[it], it, runner.sched, 1280, n_eps))
        tmaint.append(ttrain.state_to_numpy(st))
        return st

    runner.maintain = with_jax_draws
    step_for, tgrads = runner._step_fn, []

    def recording(cam):
        step = step_for(cam)

        def with_grads(*args):
            out = {}
            res = step(*args, grads_out=out)
            tgrads.append({name: {k: v.numpy() for k, v in
                                  out[name]._asdict().items()
                                  if v is not None}
                           for name in ("base", "env")})
            return res

        return with_grads

    runner._step_fn = recording
    final = runner.train()
    tpost.append(ttrain.state_to_numpy(final))

    assert runner.events == [(1, "densify_base"), (2, "densify_base"),
                             (2, "reset_opacity_base")]
    for it in range(3):
        for name in ("base", "env"):
            g, w = tmaint[it][name], jmaint[it][name]
            for k, v in w["stats"].items():
                np.testing.assert_array_equal(g["stats"][k], v,
                                              err_msg=f"{it} {name} {k}")
            for grp in ("params", "mu", "nu"):
                for k, v in w[grp].items():
                    np.testing.assert_allclose(g[grp][k], v, rtol=1e-6,
                                               atol=1e-6, err_msg=f"{it} {k}")
        assert jmaint[it]["base"]["step"] == tmaint[it]["base"]["step"]
        _assert_step(tpost[it], tgrads[it], tmaint[it], jpost[it],
                     jmaint[it], it, f"step {it}")
    n_active = [int(m["base"]["stats"]["active"].sum()) for m in jmaint]
    assert n_active[1] != n_active[0] and n_active[2] != n_active[1]
    assert float(torch.sigmoid(final.base.params.opacity).max()) < 0.02
    model_dir = tmp_path / "trained_model" / "three"
    assert sorted(p.name for p in model_dir.iterdir()) == [
        "3.npz", "base.ply", "env.ply", "latest.npz"]
    assert not (tmp_path / "result").exists()  # train() evaluates nothing
    # a new runner resumes from the file: the same state, nothing to train
    again = make()
    assert again.start_iter == 3
    act = final.base.stats.active
    for a, b in zip(tg.present(again.state.base.params),
                    tg.present(final.base.params)):
        assert torch.equal(a[: int(act.sum())], b[act])
    for a, b in zip(tg.present(again.state.opt_env.nu),
                    tg.present(final.opt_env.nu)):
        eact = final.env.stats.active
        assert torch.equal(a[: int(eact.sum())], b[eact])


def test_smoke_entry_point_on_cpu(tmp_path, monkeypatch, capsys):
    """`python -m envgs_tpu_torch smoke`, cut down (4 views of 32x32, 8
    iterations, the reflection pass from iteration 4) and on the CPU:
    trains, saves the checkpoint and both plys, evaluates in exact order
    and writes metrics.json with finite PSNR/SSIM, NaN LPIPS and the
    per-stage render times."""
    monkeypatch.chdir(tmp_path)
    summary = cli.main(
        ["smoke", "dataset_cfg.H=32", "dataset_cfg.W=32",
         "dataset_cfg.n_views=4", "runner_cfg.ep_iter=8",
         "model_cfg.sampler_cfg.reflection_start_iter=4",
         "runner_cfg.log_interval=4"], device="cpu")
    with open(tmp_path / "data" / "result" / "smoke" / "metrics.json") as f:
        on_disk = json.load(f)
    s = on_disk["summary"]
    assert s == json.loads(json.dumps(summary["summary"]))
    assert np.isfinite(s["psnr_mean"]) and s["psnr_mean"] > 10
    assert np.isfinite(s["ssim_mean"]) and np.isnan(s["lpips_mean"])
    assert s["tracer_order"] == "exact"
    assert {"render.bin", "env.cull", "env.blend"} <= set(s["stage_ms"])
    assert len(on_disk["frames"]) == 1  # view 0 of 4 is held out
    model_dir = tmp_path / "data" / "trained_model" / "smoke"
    assert {"latest.npz", "8.npz", "base.ply", "env.ply"} <= {
        p.name for p in model_dir.iterdir()}
    assert (tmp_path / "data" / "result" / "smoke" / "RENDER"
            / "frame0000_camera0000.png").exists()
    assert "iter 7/8" in capsys.readouterr().out


def test_stage_ms_follows_the_served_render(tmp_path):
    """metrics.json's stage_ms is read from the spans of one radial-order
    render_view of the first view, the render the runner serves: at an
    env_per_tile_cap of one chunk the env cull of that render cuts chunks
    (env.cut > 0 in the root stage_ms was read from), and the times are
    keyed by span name."""
    scene = synthetic.make_scene(n_views=1, H=H, W=W, device="cpu")
    views = [dict(rgb=scene.images[0], msk=scene.masks[0],
                  norm=scene.normals[0], camera=scene.cams[0])]
    runner = Runner(
        views, scene.gt_base, scene.gt_env,
        tenv.EnvGSConfig(env_per_tile_cap=CHUNK, **MODEL),
        tsup.LossConfig(**LOSS), ttrain.ScheduleConfig(**SCHED),
        tg.DensifyConfig(**DENS), tg.DensifyConfig(**DENS), topt.LRConfig(),
        topt.LRConfig(), exp_name="cap", out_root=str(tmp_path),
        resume=False, record=False)
    stage_ms = runner.test(save_images=False)["summary"]["stage_ms"]
    root = read_spans()[-1]
    assert root["name"] == "render"
    assert stage_ms == (root["device_ms"] or root["host_ms"])
    assert {"render.bin", "env.cull", "env.blend"} <= set(stage_ms)
    assert root["counts"]["env.cut"] > 0


def test_unported_modes_and_options_raise(tmp_path, monkeypatch):
    """No mode is left unported: `ws` reaches the websocket server with
    the config and the JAX package's host and port (its frames:
    tests/test_torch_serve.py). Another model family dispatches `train` to
    its trainer (NeRF: train_nerf) and refuses the other modes by name, as
    do backends the port lacks; supervisor_cfg.aux_cfg, from a config
    dict or as an override of a config file, builds the AuxLossConfig the
    runner trains with (the scenes cut to two 16x16 views: nothing
    trains). (The real-data source, the moderators, patch training and
    `mesh` run since they were ported: tests/test_torch_data.py,
    test_torch_moderators.py, test_torch_real_configs.py and
    test_torch_cli_modes.py.)"""
    from envgs_tpu.train.aux_supervisors import AuxLossConfig as JAux
    from envgs_tpu_torch.engine import load_config
    from envgs_tpu_torch.train.aux_supervisors import AuxLossConfig

    from envgs_tpu_torch.engine import TRAINERS
    from envgs_tpu_torch.serve import websocket_server
    from envgs_tpu_torch.train import families

    assert cli.UNPORTED_MODES == ()
    tiny = ["dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=2"]
    cfg = cli.smoke_config()
    cfg["out_root"] = str(tmp_path)  # the runner's records go there
    cfg["dataset_cfg"].update(H=16, W=16, n_views=2)
    cfg["model_cfg"]["supervisor_cfg"] = {"aux_cfg": {"dpt_loss_weight": 1}}
    want = AuxLossConfig(dpt_loss_weight=1)
    assert cli.make_runner(cfg, device="cpu").aux_cfg == want
    assert tuple(want) == tuple(JAux(dpt_loss_weight=1))
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        envgs_tpu_torch.__file__)))
    path = os.path.join(root, "configs", "exps", "envgs_synthetic.yaml")
    served = []
    monkeypatch.setattr(websocket_server, "serve_config",
                        lambda *a, **kw: served.append((a, kw)))
    cli.main(["ws", "-c", path], device="cpu")
    assert served == [((path, []), dict(host="127.0.0.1", port=1024,
                                         device="cpu"))]
    # the config names the ref tracer, which the port has; a backend it
    # lacks (the JAX package's interpret mode) raises by name
    with pytest.raises(NotImplementedError, match="tiled_interp"):
        cli.main(["train", "-c", path,
                  "model_cfg.sampler_cfg.tracer_backend=tiled_interp"],
                 device="cpu")  # overrides after -c are read
    runner = cli.make_runner(load_config(path, overrides=[
        "model_cfg.supervisor_cfg.aux_cfg.dpt_loss_weight=1",
        "model_cfg.supervisor_cfg.aux_cfg.dpt_loss_kind=ssimse",
        "model_cfg.sampler_cfg.tracer_backend=tiled", f"out_root={tmp_path}",
        *tiny], root=root),
        device="cpu")
    assert runner.aux_cfg == AuxLossConfig(dpt_loss_weight=1,
                                           dpt_loss_kind="ssimse")
    assert runner.start_iter == 0
    # another model family: `train` dispatches to its trainer, `test`
    # refuses it by name
    assert TRAINERS.get("VolumetricVideoNetwork") is families.train_nerf
    trained = []
    monkeypatch.setitem(TRAINERS._modules, "VolumetricVideoNetwork",
                        lambda cfg, device: trained.append(device))
    cli.main(["train", "-c", path,
              "model_cfg.network_cfg.type=VolumetricVideoNetwork"],
             device="cpu")
    assert trained == ["cpu"]
    with pytest.raises(NotImplementedError, match="VolumetricVideoNetwork"):
        cli.main(["test", "-c", path,
                  "model_cfg.network_cfg.type=VolumetricVideoNetwork"],
                 device="cpu")
    for key, name in (("raster_backend", "pallas_interp"),
                      ("tracer_backend", "tiled_interp")):
        cfg = cli.smoke_config()
        cfg["model_cfg"]["sampler_cfg"][key] = name
        with pytest.raises(NotImplementedError, match=name):
            cli.make_runner(cfg, device="cpu")


def test_config_copy_matches_jax():
    """The port's own copy of the config system loads the repository's
    EnvGS config chain, with dotted overrides, to the dict the JAX
    package's loads; `call_filtered` drops and reports unknown keys."""
    from envgs_tpu.engine import load_config as jload
    from envgs_tpu_torch.engine import call_filtered, load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        envgs_tpu_torch.__file__)))
    path = os.path.join(root, "configs", "exps", "envgs_synthetic.yaml")
    ov = ["runner_cfg.epochs=2", "model_cfg.sampler_cfg.pool_cap=4096"]
    got = load_config(path, overrides=ov, root=root)
    assert got.to_dict() == jload(path, overrides=ov, root=root).to_dict()
    assert got.exp_name == "envgs_synthetic" and got.runner_cfg.epochs == 2
    with pytest.warns(UserWarning, match="unused"):
        assert call_filtered(lambda a, b=2: a + b, dict(a=1, c=3)) == 3


def test_entry_points_default_to_the_card():
    """Without a card the entry points raise instead of running on the
    CPU (the tests pass device="cpu" explicitly)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["smoke"])
    with pytest.raises((RuntimeError, AssertionError)):
        synthetic.make_scene(n_views=1, H=16, W=16)


def test_the_port_imports_no_jax():
    """No source file of the package, nor chip_smoke.py, imports jax or
    anything of the JAX package."""
    root = os.path.dirname(os.path.abspath(envgs_tpu_torch.__file__))
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(root), "chip_smoke.py"))
    assert len(files) > 40
    pat = re.compile(r"^\s*(from|import)\s+(jax|envgs_tpu)(\.|\s|$)", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad

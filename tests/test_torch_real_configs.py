"""The shipped scene configs and the whole slice on a capture on disk,
against the JAX package: every configs/exps/envgs/*/*.yaml resolves in the
port (sampler_cfg.bounds accepted, a misspelt key still raising) to config
tuples equal to JAX's field by field; the moderator and patch wiring of
make_runner; three Runner iterations from both packages' make_runner on a
capture in tmp_path; the config-driven 3DGS entry point against JAX's
train_gaussiant; and the entry point's train / test / render on a capture.

    python -m pytest tests/test_torch_real_configs.py
"""
import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envgs_tpu_torch
from envgs_tpu import cli as jcli
from envgs_tpu.engine import load_config as jload
from envgs_tpu.models import gaussians as jg
from envgs_tpu.models import gaussiant as jgt
from envgs_tpu.ops.losses import ssim as jssim
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.utils.camera import Camera as JCamera
from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import TRAINERS, load_config
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.models import gaussiant as tgt
from envgs_tpu_torch.ops.losses import ssim as tssim
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils.ply import load_gaussian_ply
from test_torch_data import write_capture
from test_torch_gaussiant import _close
from test_torch_runner import ADAM_RTOL, GRAD_RTOL, LOSS, MODEL, SCHED, \
    _draws, _to_numpy
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    envgs_tpu_torch.__file__)))
SCENES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "exps", "envgs", "*", "*.yaml")))
# the 3DGS entry point against JAX's: loss per iteration, the ply's
# positions (the other arrays as test_torch_gaussiant_loop.py holds its
# final pool: Adam's quotient turns a gradient difference of rounding size
# into a move of a fraction of the learning rate; after 3 steps on the
# 32x32 capture f_dc moves 2.5e-5 on one element of 2700, scaling 7.2e-4
# on 570 of 2700, rotations 4.8e-3: their gradients are rounding noise on
# a pool that starts isotropic)
LOSS_ATOL = 1e-4
PLY_ATOL = 1e-5
# the first step's gradients against JAX's exact oracle, of each array's
# largest: the port's come within 1.2e-5 (positions), JAX's kernel's within
# 3.6e-6
FIRST_GRAD_RTOL = 2e-5


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """6 views of 24x32 (normals, a binary COLMAP model, envs ply)."""
    root = str(tmp_path_factory.mktemp("capture"))
    write_capture(root, n_views=6, H=24, W=32)
    return root


def _scene_overrides(root):
    """A scene config pointed at the capture: its data_root, all views,
    pools of a few thousand slots (the caps max_gs / env_max_gs stay)."""
    return [f"dataset_cfg.data_root={root}", "dataset_cfg.view_sample=null",
            f"val_dataset_cfg.data_root={root}",
            "val_dataset_cfg.view_sample=null",
            "model_cfg.sampler_cfg.pool_cap=2048",
            "model_cfg.sampler_cfg.env_pool_cap=1024"]


def test_sixteen_shipped_scene_configs():
    assert len(SCENES) == 16


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(p)[6:-5]
                                              for p in SCENES])
def test_scene_config_resolves_to_the_jax_tuples(capture, path):
    """build_from_config on the shipped scene config (every key checked,
    `bounds` among them) gives the JAX package's EnvGSConfig, LossConfig,
    ScheduleConfig, both DensifyConfigs and both LRConfigs, field by
    field."""
    ov = _scene_overrides(capture)
    cfg = load_config(path, overrides=ov, root=ROOT)
    assert cfg.model_cfg.sampler_cfg.bounds  # the key every scene sets
    got = cli.build_from_config(cfg, "cpu")
    want = jcli.build_from_config(jload(path, overrides=ov, root=ROOT))
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for i, name in ((4, "EnvGSConfig"), (5, "LossConfig"),
                    (6, "ScheduleConfig"), (7, "DensifyConfig base"),
                    (8, "DensifyConfig env"), (9, "LRConfig base"),
                    (10, "LRConfig env")):
        g, w = got[i], want[i]
        for f in g._fields:
            # a field the port adds (test_torch_configs.ADDED) stays at
            # its default where the config does not set it
            want_f = getattr(w, f, type(g)._field_defaults.get(f))
            if f.endswith("_backend"):
                # the JAX reader turns pallas / tiled into their interpret
                # modes on the CPU; the port's names are the configs'
                want_f = want_f.removesuffix("_interp")
            assert getattr(g, f) == want_f, (name, f)
    assert got[7].max_gs == 2_000_000 and got[8].max_gs == 700_000


def test_a_misspelt_scene_key_still_raises(capture):
    path = "configs/exps/envgs/ref_real/envgs_sedan.yaml"
    cfg = load_config(path, overrides=_scene_overrides(capture) + [
        "model_cfg.sampler_cfg.bonuds=[[-1,-1,-1],[1,1,1]]"], root=ROOT)
    with pytest.raises(KeyError, match="bonuds"):
        cli.build_from_config(cfg, "cpu")


@pytest.mark.parametrize("moderator", [
    {"type": "DatasetRatioModerator", "milestone_start": 0.5,
     "iter_end": 20},
    {"type": "DatasetCenterCropRatioModerator", "milestone_start": 0.75},
    {"type": "AlternatingModerator"},
], ids=["ratio", "crop", "alternating"])
def test_make_runner_moderators_equal(capture, tmp_path, moderator):
    raw = _run_config(capture, str(tmp_path))
    raw["runner_cfg"]["moderator_cfg"] = moderator
    raw["model_cfg"]["sampler_cfg"]["patch_size"] = [16, 16]
    tr = cli.make_runner(cli.Config.wrap(copy.deepcopy(raw)), "cpu")
    jr = jcli.make_runner(jcli.Config.wrap(raw))
    for k in ("ratio_sched", "crop_sched", "alternating", "patch_size"):
        g, w = getattr(tr, k), getattr(jr, k)
        assert (g is None) == (w is None), k
        if g is not None:
            assert tuple(g) == tuple(w), k
    assert tr.patch_size == (16, 16)


def test_unknown_moderator_raises(capture, tmp_path):
    raw = _run_config(capture, str(tmp_path))
    raw["runner_cfg"]["moderator_cfg"] = {"type": "DatasetRatioModerater"}
    with pytest.raises(NotImplementedError, match="DatasetRatioModerater"):
        cli.make_runner(cli.Config.wrap(raw), "cpu")


def _run_config(root, out_root):
    """The compressed three-iteration schedule of test_torch_runner.py on
    the capture (densify at 1 and 2, the opacity reset at 2, reflections
    from the start)."""
    return {
        "exp_name": "capture", "out_root": out_root,
        "dataset_cfg": {"source": "multiview", "data_root": root,
                        "eval_every": 4, "use_normals": True},
        "model_cfg": {
            "sampler_cfg": {
                "pool_cap": 1280, "env_pool_cap": 640, "sh_deg": 1,
                "env_sh_deg": 1, "init_specular": 0.3, "spatial_scale": 2.5,
                "densify_grad_threshold": 5e-5, **MODEL, **SCHED},
            "supervisor_cfg": dict(LOSS)},
        "runner_cfg": {"resume": False, "record": False, "log_interval": 1,
                       "save_latest_every": 0},
    }


def _assert_step(got, grads, s0, want, j0, it, lr, what):
    """test_torch_runner.py's step check with the runner's learning rates
    (`lr`: the JAX LRConfig of each pool): visit counts equal but for two
    flips at the alpha floor, each gradient within GRAD_RTOL of its array's
    largest, and JAX's Adam on the port's gradients giving the port's
    parameters and moments within ADAM_RTOL."""
    b1 = 0.9
    for name in ("base", "env"):
        g, w, z = got[name], want[name], s0[name]
        assert g["step"] == w["step"]
        np.testing.assert_array_equal(g["stats"]["active"],
                                      w["stats"]["active"])
        flip = g["stats"]["denom"] != w["stats"]["denom"]
        assert flip.sum() <= 2, (what, name, flip.sum())
        assert (g["stats"]["weight_accum"][flip] < 1e-3).all()
        for k, gp in grads[name].items():
            mu0, mu1 = (d[name]["mu"][k].astype(np.float64)
                        for d in (j0, want))
            gj = np.where(mu1 != mu0, (mu1 - b1 * mu0) / (1 - b1), 0.0)
            atol = 2 * np.spacing(np.float32(np.abs(mu0).max())) / (1 - b1)
            err = np.abs(gp - gj)[~flip].max()
            assert err <= GRAD_RTOL * np.abs(gj[~flip]).max() + atol, (
                what, name, k, err, np.abs(gj).max())
        tree = lambda d: jg.GaussianParams(  # noqa: E731
            *(jnp.asarray(d[f]) if f in d else None
              for f in jg.GaussianParams._fields))
        new_p, new_opt = jopt.sparse_adam_update(
            tree(z["params"]), tree(grads[name]),
            jopt.AdamState(tree(z["mu"]), tree(z["nu"]),
                           jnp.asarray(z["step"], jnp.int32)),
            jopt.lr_tree_for(jnp.asarray(it), lr[name]))
        for grp, ref in (("params", new_p), ("mu", new_opt.mu),
                         ("nu", new_opt.nu)):
            for k in z[grp]:
                d_want = np.asarray(getattr(ref, k)) - z[grp][k]
                ulps = 2 * np.spacing(np.abs(z[grp][k]).max()) \
                    if grp == "params" else 0.0
                err = np.abs(g[grp][k] - z[grp][k] - d_want).max()
                assert err <= ADAM_RTOL * np.abs(d_want).max() + ulps, (
                    what, name, grp, k, err, np.abs(d_want).max())


def _copy(tree):
    """A deep copy of a _to_numpy dict (the JAX step donates its input)."""
    return jax.tree_util.tree_map(np.array, tree)


def test_runner_iterations_on_a_capture_match_jax(capture, tmp_path):
    """Both packages' make_runner on one capture (their views, cameras and
    first pools equal), then three iterations held as
    test_torch_runner.py::test_runner_iterations_match_jax holds them:
    each port iteration starts from JAX's state and takes JAX's split
    draws; per iteration the state after maintenance (masks and stats
    exactly, arrays 1e-6), the step's gradients (5e-4 of each array's
    largest) and JAX's Adam on the port's gradients."""
    raw = _run_config(capture, str(tmp_path))
    jr = jcli.make_runner(jcli.Config.wrap(copy.deepcopy(raw)))
    tr = cli.make_runner(cli.Config.wrap(raw), "cpu")
    assert [v["name"] for v in tr.views] == [v["name"] for v in jr.views]
    assert [v["name"] for v in tr.eval_views] == ["00", "04"]
    for a, b in zip(tr.views, jr.views):
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        np.testing.assert_array_equal(a["norm"], b["norm"])
        np.testing.assert_allclose(a["camera"].K.numpy(),
                                   np.asarray(b["camera"].K), atol=1e-6)
    start = _copy(_to_numpy(jr.state))
    first = ttrain.state_to_numpy(tr.state)
    for name in ("base", "env"):
        np.testing.assert_array_equal(first[name]["stats"]["active"],
                                      start[name]["stats"]["active"])
        for k, v in start[name]["params"].items():
            np.testing.assert_allclose(first[name]["params"][k], v,
                                       rtol=1e-6, atol=1e-6, err_msg=k)

    # ---- JAX: its Runner.train, maintenance and step recorded ----
    mkeys, jmaint, jpost = [], [], []
    maintain, step_fn = jr.maintain, jr._step_fn

    def jmaintain(st, it, mkey):
        mkeys.append(mkey)
        st = maintain(st, it, mkey)
        jmaint.append(_copy(_to_numpy(st)))
        return st

    def jstep_fn(cam):
        step = step_fn(cam)

        def recorded(*args):
            st, stats = step(*args)
            jpost.append(_copy(_to_numpy(st)))
            return st, stats
        return recorded

    jr.maintain, jr._step_fn = jmaintain, jstep_fn
    jr.train()

    # ---- the port: its Runner.train from JAX's states and draws ----
    tr.state = ttrain.state_from_numpy(start)._replace(gen=tr.state.gen)
    tmaintain, tstep_fn = tr.maintain, tr._step_fn
    tmaint, tpost, tgrads = [], [], []
    n_eps = tg.DensifyConfig().split_n + tg.DensifyConfig().weight_split_n

    def with_jax_draws(st, it, log=None):
        if it > 0:
            tpost.append(ttrain.state_to_numpy(st))
            st = ttrain.state_from_numpy(jpost[it - 1])._replace(gen=st.gen)
        st = tmaintain(st, it, log=log, draws=_draws(
            mkeys[it], it, tr.sched, 1280, n_eps))
        tmaint.append(ttrain.state_to_numpy(st))
        return st

    def recording(cam):
        step = tstep_fn(cam)

        def with_grads(*args):
            out = {}
            res = step(*args, grads_out=out)
            tgrads.append({name: {k: v.numpy() for k, v in
                                  out[name]._asdict().items()
                                  if v is not None}
                           for name in ("base", "env")})
            return res
        return with_grads

    tr.maintain, tr._step_fn = with_jax_draws, recording
    final = tr.train()
    tpost.append(ttrain.state_to_numpy(final))

    assert tr.events == [(1, "densify_base"), (2, "densify_base"),
                         (2, "reset_opacity_base")]
    assert len(jmaint) == len(jpost) == len(tgrads) == 3
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
        _assert_step(tpost[it], tgrads[it], tmaint[it], jpost[it],
                     jmaint[it], it, {"base": jr.lr_base, "env": jr.lr_env},
                     f"step {it}")
    n_active = [int(m["base"]["stats"]["active"].sum()) for m in jmaint]
    assert n_active[1] != n_active[0] and n_active[2] != n_active[1]


def _gaussiant_config(root, out_root):
    """configs/exps/gaussiant_synthetic.yaml on the capture, 3 iterations,
    the port's backend name."""
    return ["dataset_cfg.source=multiview", f"dataset_cfg.data_root={root}",
            "dataset_cfg.eval_every=4", f"out_root={out_root}",
            "model_cfg.sampler_cfg.raster_backend=pallas",
            "runner_cfg.ep_iter=3", "runner_cfg.log_interval=1"]


def test_gaussiant_config_entry_point_matches_jax(tmp_path, monkeypatch):
    """`train -c configs/exps/gaussiant_synthetic.yaml` with the multiview
    source on a 32x32 capture, through the port's TRAINERS and JAX's
    train_gaussiant: the loss of each of the 3 iterations within
    LOSS_ATOL, the active count equal, point_cloud.ply's positions within
    PLY_ATOL and its other arrays but rotations within GRAD_RTOL of each
    array's largest, metrics.json with PSNR / SSIM of the held-out views
    (JAX's within 1e-4).

    JAX's side runs its exact oracle (`ref`), not its interpret-mode
    kernel: on this capture the kernel rounds one cancelling first gradient
    to exactly 0.0 where the oracle, a float64 sum and the port agree on
    -1.6e-10, and Adam's first step turns that into a whole learning rate
    (the next test shows it). The bounds are those of the kernel's
    comparison."""
    root = str(tmp_path / "capture")
    write_capture(root, n_views=5, H=32, W=32)
    path = os.path.join(ROOT, "configs", "exps", "gaussiant_synthetic.yaml")
    losses = {"jax": [], "port": []}

    def recording(module, key):
        make = module.make_gaussiant_train_step

        def make_step(*args, **kw):
            step = make(*args, **kw)

            def recorded(*a):
                st, aux = step(*a)
                losses[key].append(float(aux["loss"]))
                return st, aux
            return recorded
        monkeypatch.setattr(module, "make_gaussiant_train_step", make_step)

    recording(jgt, "jax")
    render = jgt.render_gaussiant

    def jitted_eval_render(pool, cam, cfg, means2d_zero=None):
        """JAX's eval render, jitted (eager interpret mode is slow)."""
        if means2d_zero is not None:
            return render(pool, cam, cfg, means2d_zero)
        return jax.jit(lambda p: render(p, cam, cfg))(pool)

    monkeypatch.setattr(jgt, "render_gaussiant", jitted_eval_render)
    import envgs_tpu_torch.train.gaussiant_loop as loop
    recording(loop, "port")
    jstate = jcli.train_gaussiant(jload(path, overrides=_gaussiant_config(
        root, str(tmp_path / "jax")) + [
            "model_cfg.sampler_cfg.raster_backend=ref"], root=ROOT))
    assert TRAINERS.get("GaussianTSampler") is cli.train_gaussiant
    tstate, summary = cli.main(["train", "-c", path, *_gaussiant_config(
        root, str(tmp_path / "port"))], device="cpu")
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=LOSS_ATOL)
    n = int(np.asarray(jstate.pool.stats.active).sum())
    assert int(tstate.pool.stats.active.sum()) == n > 0
    plys = [load_gaussian_ply(str(tmp_path / side / "trained_model" /
                                  "gaussiant_synthetic" / "point_cloud.ply"))
            for side in ("port", "jax")]
    assert plys[0].keys() == plys[1].keys()
    for k, b in plys[1].items():
        a = plys[0][k]
        assert a.shape == b.shape and len(a) == n
        if k == "xyz":
            np.testing.assert_allclose(a, b, atol=PLY_ATOL, rtol=0)
        elif k != "rotation":
            _close(a, b, name=k)
    with open(tmp_path / "port" / "result" / "gaussiant_synthetic"
              / "metrics.json") as f:
        on_disk = json.load(f)
    assert len(on_disk["frames"]) == 2  # views 00 and 04 held out
    s = on_disk["summary"]
    assert np.isfinite(s["psnr_mean"]) and np.isfinite(s["ssim_mean"])
    assert s == json.loads(json.dumps(summary["summary"]))
    jsum = json.loads(open(tmp_path / "jax" / "result" / "gaussiant_synthetic"
                           / "metrics.json").read())["summary"]
    for k in ("psnr_mean", "ssim_mean"):
        np.testing.assert_allclose(s[k], jsum[k], rtol=1e-4)


def test_gaussiant_first_gradient_against_jax_kernel_and_oracle(tmp_path):
    """The first train step of the run above (the same 32x32 capture, the
    config's pool, its first view), differentiated by the port and by JAX
    through its interpret-mode kernel (pallas_interp) and its exact oracle
    (ref): the port's gradient of every array is within 2e-5 of the
    array's largest of JAX's oracle (FIRST_GRAD_RTOL; rotations aside, as
    above), and so is JAX's kernel's. Where JAX's
    kernel gives an element exactly 0 and the port does not, JAX's oracle
    does not either: such a zero is a cancellation that the kernel's
    log-domain transmittance happens to round to 0, and Adam's first step
    then moves the element by its whole learning rate in one package and
    leaves it in the other (ROADMAP.md Queue 3 item 5)."""
    root = str(tmp_path / "capture")
    write_capture(root, n_views=5, H=32, W=32)
    path = os.path.join(ROOT, "configs", "exps", "gaussiant_synthetic.yaml")
    cfg = load_config(path, overrides=_gaussiant_config(
        root, str(tmp_path / "out")), root=ROOT)
    views, _, xyz, rgb, _, _ = cli._load_views(cfg, "cpu")
    scfg = dict(cfg.model_cfg.sampler_cfg)
    cap = int(scfg.get("pool_cap", max(len(xyz) * 4, 1024)))
    order = np.random.default_rng(0).permutation(len(views))
    v = views[int(order[0])]
    cam, target = v["camera"], np.asarray(v["rgb"], np.float32)
    tcfg = tgt.GaussianTConfig(**{k: scfg[k] for k in scfg
                                  if k in tgt.GaussianTConfig._fields})
    tpool = tgt.init_gaussiant_pool(xyz, rgb, cap, tcfg, device="cpu")
    params = tg.map_params(lambda p: p.detach().requires_grad_(True),
                           tpool.params)
    m2z = torch.zeros((cap, 2), requires_grad=True)
    out = tgt.render_gaussiant(tpool._replace(params=params), cam, tcfg,
                               means2d_zero=m2z)
    t = torch.as_tensor(target)
    loss = (1 - tcfg.ssim_weight) * torch.mean(torch.abs(out.rgb - t)) + \
        tcfg.ssim_weight * (1 - tssim(out.rgb, t))
    grads = torch.autograd.grad(loss, tg.present(params), allow_unused=True)
    port = {f: np.zeros(x.shape, np.float32) if g is None else g.numpy()
            for f, g, x in zip(params._fields, grads, params)}

    jcam = JCamera(cam.H, cam.W, *(jnp.asarray(x.numpy())
                                   for x in (cam.K, cam.R, cam.T)),
                   cam.znear, cam.zfar)
    jcfg = jgt.GaussianTConfig(**tcfg._replace(
        raster_backend="pallas_interp")._asdict())
    jpool = jgt.init_gaussiant_pool(np.asarray(xyz), np.asarray(rgb), cap,
                                    jcfg)

    def jgrad(c):
        def loss_fn(prm):
            o = jgt.render_gaussiant(jpool._replace(params=prm), jcam, c,
                                     jnp.zeros((cap, 2), jnp.float32))
            return (1 - c.ssim_weight) * jnp.mean(jnp.abs(o.rgb - target)) \
                + c.ssim_weight * (1 - jssim(o.rgb, jnp.asarray(target)))
        g = jax.jit(jax.grad(loss_fn))(jpool.params)
        return {f: np.asarray(getattr(g, f)) for f in port}

    kernel = jgrad(jcfg)
    oracle = jgrad(jcfg._replace(raster_backend="ref"))
    act = np.asarray(jpool.stats.active)
    for f, r in oracle.items():
        r, k, p = r[act], kernel[f][act], port[f][act]
        if f == "rotation" or not r.any():
            continue  # rotation's gradients are rounding noise (above)
        bound = FIRST_GRAD_RTOL * np.abs(r).max()
        assert np.abs(p - r).max() <= bound, (f, np.abs(p - r).max(), bound)
        assert np.abs(k - r).max() <= bound, (f, np.abs(k - r).max(), bound)
        lone = (k == 0) & (p != 0)
        assert (r[lone] != 0).all(), f


def test_gaussiant_config_names_a_backend_the_port_lacks(tmp_path):
    """gaussiant_synthetic.yaml names the `ref` rasterizer, which the port
    has now: `train -c` runs the config as shipped, cut to 3 iterations on
    two 16 x 16 views (the oracle is O(P H W)), and writes its point cloud;
    a backend the port lacks (JAX's interpret name) raises by name before
    any work, as a misspelt key does."""
    path = os.path.join(ROOT, "configs", "exps", "gaussiant_synthetic.yaml")
    cut = ["dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=2",
           "runner_cfg.ep_iter=3", f"out_root={tmp_path}"]
    cli.main(["train", "-c", path, *cut], device="cpu")
    assert (tmp_path / "trained_model" / "gaussiant_synthetic"
            / "point_cloud.ply").exists()
    with pytest.raises(NotImplementedError, match="pallas_interp"):
        cli.main(["train", "-c", path, *cut,
                  "model_cfg.sampler_cfg.raster_backend=pallas_interp"],
                 device="cpu")
    with pytest.raises(KeyError, match="ssim_wieght"):
        cli.main(["train", "-c", path, "model_cfg.sampler_cfg.raster_backend"
                  "=pallas", "model_cfg.sampler_cfg.ssim_wieght=0.1"],
                 device="cpu")


def test_train_test_render_on_a_capture(tmp_path, monkeypatch, capsys):
    """The entry point on a capture, cut down: `train` (6 iterations, the
    ratio moderator then patches) writes the checkpoint and evaluates the
    held-out views; `render` resumes it and writes a 2-frame path."""
    root = str(tmp_path / "capture")
    write_capture(root, n_views=5, H=32, W=32)
    cfg = {
        "exp_name": "capture", "out_root": str(tmp_path / "out"),
        "dataset_cfg": {"source": "multiview", "data_root": root,
                        "eval_every": 4, "use_normals": True},
        "model_cfg": {"sampler_cfg": {
            "pool_cap": 1280, "env_pool_cap": 768, "sh_deg": 1,
            "env_sh_deg": 1, "render_reflection_start_iter": 3,
            "pair_cap": 2 ** 14, "patch_size": [16, 32]}},
        "runner_cfg": {"epochs": 1, "ep_iter": 6, "log_interval": 3,
                       "record": False,
                       "moderator_cfg": {"type": "AlternatingModerator"}},
    }
    path = str(tmp_path / "capture.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    summary = cli.main(["train", "-c", path], device="cpu")
    s = summary["summary"]
    assert np.isfinite(s["psnr_mean"]) and s["tracer_order"] == "exact"
    model_dir = tmp_path / "out" / "trained_model" / "capture"
    assert {"latest.npz", "6.npz", "base.ply", "env.ply"} <= {
        p.name for p in model_dir.iterdir()}
    assert "iter 5/6" in capsys.readouterr().out
    out = cli.main(["render", "-c", path, "--path-frames", "2"],
                   device="cpu")
    assert sorted(os.listdir(os.path.join(out, "RENDER"))) == [
        "frame0000_camera0000.png", "frame0000_camera0001.png"]
    assert "[resume]" in capsys.readouterr().out

"""compute_losses and one whole make_train_step with the aux supervisors
(a depth prior) and the perceptual loss (LPIPS on a random VGG16 npz)
against the JAX package, at the bounds of tests/test_torch_train_step.py;
the config reader's aux_cfg and the runner's depth prior and LPIPS.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_aux_step.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.ops import lpips_jax as jlp
from envgs_tpu.train import aux_supervisors as jaux
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch import cli
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.ops import lpips as tlp
from envgs_tpu_torch.train import aux_supervisors as taux
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_lpips import write_vgg_npz
from tests.test_torch_train_step import (
    EYE,
    GRAD_RTOL,
    LOSS_RTOL,
    ZERO,
    H,
    K,
    W,
    _close,
    _jax_state_to_numpy,
    _scene,
)
from torch_threads import one_thread  # noqa: F401

# every EnvGS term as in test_torch_train_step.py, the perceptual loss on
LOSS_CFG = dict(perc_loss_weight=0.05, gs_dist_loss_weight=0.01,
                gs_dist_loss_start_iter=0, env_opacity_loss_weight=0.01,
                msk_loss_weight=0.1, msk_loss_start_iter=0)
AUX = dict(dpt_loss_weight=1.0, msk_loss_weight=0.1, ent_loss_weight=0.01)


pytestmark = pytest.mark.usefixtures("one_thread")


def _lpips_pair_fns(tmp_path):
    path = write_vgg_npz(tmp_path / "vgg16.npz", seed=1, lins=True)
    return (functools.partial(jlp.lpips_pair, jlp.load_weights(path)),
            functools.partial(tlp.lpips_pair, tlp.load_weights(path)))


def _prior(rng):
    """A metric depth prior with holes (0)."""
    dpt = (rng.random((H, W, 1)) * 3 + 1).astype(np.float32)
    dpt[rng.random((H, W, 1)) < 0.2] = 0.0
    return dpt


@pytest.mark.parametrize("kind", ["smoothl1", "ssimse"])
@pytest.mark.parametrize("it", [100, 101], ids=["gate_closed", "gate_open"])
def test_compute_losses_with_aux_and_perceptual_matches_jax(tmp_path, it,
                                                            kind):
    """compute_losses with lpips_fn, aux_cfg and gt_dpt against JAX's: the
    same stats (perc_loss and the aux_ ones) within LOSS_RTOL, gradients
    with respect to every map within GRAD_RTOL. The perceptual gate is
    strict: at it == perc_loss_start_iter (100) the loss leaves it out."""
    rng = np.random.default_rng(0)
    maps = dict(
        rgb_map=rng.random((H, W, 3)), norm_map=rng.normal(size=(H, W, 3)),
        surf_norm_map=rng.normal(size=(H, W, 3)),
        acc_map=rng.random((H, W, 1)), dist_map=rng.random((H, W, 1)) * 1e-2,
        dpt_map=rng.random((H, W, 1)) * 3 + 1,
        env_opacity=rng.random((40, 1)))
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    gt = rng.random((H, W, 3)).astype(np.float32)
    msk = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    nrm = rng.random((H, W, 3)).astype(np.float32)
    dpt = _prior(rng)
    R = np.array([[0.8, 0.6, 0], [-0.6, 0.8, 0], [0, 0, 1]], np.float32)
    names = list(maps)
    cfg = dict(LOSS_CFG, perc_loss_start_iter=100)
    jfn, tfn = _lpips_pair_fns(tmp_path)

    def jloss(*vals):
        fields = {k: jnp.zeros(()) for k in jenv.EnvGSOutput._fields}
        fields.update(zip(names, vals))
        return jsup.compute_losses(
            jenv.EnvGSOutput(**fields), jnp.asarray(gt), jnp.asarray(msk),
            jnp.asarray(nrm), jnp.asarray(R), it, jsup.LossConfig(**cfg),
            bg_brightness=0.3, lpips_fn=jfn,
            aux_cfg=jaux.AuxLossConfig(dpt_loss_kind=kind, **AUX),
            gt_dpt=jnp.asarray(dpt))

    (jl, jstats), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(
        range(len(names))), has_aux=True))(*[jnp.asarray(maps[k])
                                             for k in names])
    targs = [torch.tensor(maps[k], requires_grad=True) for k in names]
    fields = {k: None for k in tenv.EnvGSOutput._fields}
    fields.update(zip(names, targs))

    def tloss(lpips_fn):
        return tsup.compute_losses(
            tenv.EnvGSOutput(**fields), torch.tensor(gt), torch.tensor(msk),
            torch.tensor(nrm), torch.tensor(R), it, tsup.LossConfig(**cfg),
            bg_brightness=0.3, lpips_fn=lpips_fn,
            aux_cfg=taux.AuxLossConfig(dpt_loss_kind=kind, **AUX),
            gt_dpt=torch.tensor(dpt))

    tl, tstats = tloss(tfn)
    assert set(tstats) == set(jstats)
    assert {"perc_loss", "aux_dpt_loss", "aux_msk_loss",
            "aux_ent_loss"} <= set(tstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    without = float(tloss(None)[0].detach())
    perc = cfg["perc_loss_weight"] * float(tstats["perc_loss"])
    if it == 100:  # the gate is closed: the total leaves LPIPS out
        assert float(tl.detach()) == without
    else:
        np.testing.assert_allclose(float(tl), without + perc, rtol=1e-6)
    for name, got, want in zip(names, torch.autograd.grad(tl, targs), jg):
        _close(got.numpy(), want, name=name)


def test_train_step_with_aux_and_perceptual_matches_jax(tmp_path):
    """One make_train_step (test_torch_train_step.py's scene and bounds)
    with the perceptual loss past its start and the aux supervisors on a
    depth prior (Batch.dpt), from the same numpy state on both sides: loss
    stats (perc_loss, aux_*) within LOSS_RTOL, the change of params and
    Adam moments within GRAD_RTOL, visit counts equal but for at most two
    env splats at the alpha floor."""
    state, (rgb, msk, nrm) = _scene()
    dpt = _prior(np.random.default_rng(9))
    kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0)
    cfg = dict(LOSS_CFG, perc_loss_start_iter=0)
    jfn, tfn = _lpips_pair_fns(tmp_path)
    jcam = make_camera(H, W, K, EYE, ZERO)
    jstep = jtrain.make_train_step(
        jcam, jenv.EnvGSConfig(raster_backend="pallas_interp",
                               tracer_backend="tiled_interp", **kw),
        jsup.LossConfig(**cfg), jopt.LRConfig(), jopt.LRConfig(),
        lpips_fn=jfn, donate=False, has_norm=True,
        aux_cfg=jaux.AuxLossConfig(**AUX))
    jnew, jstats = jstep(
        state, jtrain.Batch(*map(jnp.asarray, (rgb, msk, nrm, dpt))),
        jcam.K, jcam.R, jcam.T, jnp.asarray(25000))

    start = _jax_state_to_numpy(state)
    tcam_ = tcam.make_camera(H, W, K, EYE, ZERO)
    tstep = ttrain.make_train_step(
        tcam_, tenv.EnvGSConfig(**kw), tsup.LossConfig(**cfg),
        topt.LRConfig(), topt.LRConfig(), has_norm=True, lpips_fn=tfn,
        aux_cfg=taux.AuxLossConfig(**AUX))
    tnew, tstats = tstep(ttrain.state_from_numpy(start),
                         ttrain.Batch(*map(torch.tensor,
                                           (rgb, msk, nrm, dpt))),
                         tcam_.K, tcam_.R, tcam_.T, 25000)
    # the port's count of the env chunks its per-tile cap cut: none here
    assert set(tstats) == set(jstats) | {"trace_cut"}
    assert int(tstats.pop("trace_cut")) == 0
    assert {"perc_loss", "aux_dpt_loss", "aux_msk_loss"} <= set(tstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got, want = ttrain.state_to_numpy(tnew), _jax_state_to_numpy(jnew)
    for name in ("base", "env"):
        g, w, s0 = got[name], want[name], start[name]
        flip = g["stats"]["denom"] != w["stats"]["denom"]
        assert flip.sum() <= (0 if name == "base" else 2), flip.sum()
        keep = ~flip
        for grp in ("params", "mu", "nu"):
            for k, wv in w[grp].items():
                _close((g[grp][k] - s0[grp][k])[keep],
                       (wv - s0[grp][k])[keep], name=f"{name} {grp} {k}")
        _close(g["stats"]["grad_accum"][keep], w["stats"]["grad_accum"][keep],
               name=f"{name} grad_accum")


def test_config_reader_builds_aux_cfg(tmp_path):
    """supervisor_cfg.aux_cfg becomes the runner's AuxLossConfig, as the
    JAX package's build_from_config makes it (no training: the smoke
    config cut to two 16x16 views); an empty or absent aux_cfg gives None,
    an unknown key raises by name; perc_loss_weight without weights on
    disk leaves the perceptual loss inert."""
    def runner(aux):
        cfg = cli.smoke_config()
        cfg["out_root"] = str(tmp_path)  # the runners' records go there
        cfg["dataset_cfg"].update(H=16, W=16, n_views=2)
        if aux is not None:
            cfg["model_cfg"]["supervisor_cfg"] = {"aux_cfg": aux}
        return cli.make_runner(cfg, device="cpu")

    r = runner({"dpt_loss_weight": 1, "dpt_loss_kind": "silog",
                "msk_loss_weight": 0.5})
    assert r.aux_cfg == taux.AuxLossConfig(dpt_loss_weight=1,
                                           dpt_loss_kind="silog",
                                           msk_loss_weight=0.5)
    assert tuple(r.aux_cfg) == tuple(jaux.AuxLossConfig(
        dpt_loss_weight=1, dpt_loss_kind="silog", msk_loss_weight=0.5))
    assert runner({}).aux_cfg is None and runner(None).aux_cfg is None
    with pytest.raises(KeyError, match="dpt_loss_wieght"):
        runner({"dpt_loss_wieght": 1})
    assert r.loss_cfg.perc_loss_weight > 0 and r._lpips_fn() is None


def test_runner_carries_the_depth_prior_and_lpips(tmp_path, monkeypatch):
    """A view's `dpt` reaches the step's Batch; with $ENVGS_VGG16_NPZ the
    runner's step gets the LPIPS of those weights (perc_loss in its
    stats) beside the aux depth loss."""
    cfg = cli.smoke_config()  # 32x32: VGG16's fifth tap needs 2x2 pixels
    cfg["out_root"] = str(tmp_path)
    cfg["dataset_cfg"].update(H=32, W=32, n_views=2)
    cfg["model_cfg"]["supervisor_cfg"] = {
        "aux_cfg": {"dpt_loss_weight": 1.0}, "perc_loss_start_iter": 0}
    r = cli.make_runner(cfg, device="cpu")
    view = dict(r.views[0], dpt=_prior(np.random.default_rng(1))[:32, :32])
    batch = r._batch(view)
    np.testing.assert_array_equal(batch.dpt.numpy(), view["dpt"])
    assert r._batch(r.views[0]).dpt is None
    path = write_vgg_npz(tmp_path / "vgg16.npz", seed=2)
    monkeypatch.setenv("ENVGS_VGG16_NPZ", path)
    cam = view["camera"]
    new, stats = r._step_fn(cam)(r.state, batch, cam.K, cam.R, cam.T, 1)
    assert "perc_loss" in stats and "aux_dpt_loss" in stats
    assert np.isfinite(float(stats["loss"]))

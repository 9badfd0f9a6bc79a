"""Parity of the port's band-parallel train step (parallel/sharding.py) and
its band-exact losses with the JAX package's single-image functions, over
2 and 4 gloo ranks spawned on the CPU (tests/torch_ranks.py), at 64 x 32
in bands of 32 or 16 rows.

JAX's own sharded tests need 8 virtual devices and are slow, so the port
is held to what the band step must reproduce: JAX's single-chip
make_train_step from the same numpy state (the kernels in interpret mode;
the `ref` oracles for the traced base with camera optimisation), and
compute_losses of the whole image. The bounds are
tests/test_torch_train_step.py's. The replicated state must come out
bit-equal on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.ops import losses as jlosses
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_train_step import (
    LOSS_CFG,
    LOSS_RTOL,
    _close,
    _jax_state_to_numpy,
)
from torch_ranks import band_step_worker, run_ranks
from torch_threads import on_one_thread

H, W, F = 64, 32, 40.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
EYE, ZERO = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
IT = 25000
KW = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0)
COPT = dict(enabled=True, extri_lr=1e-4, intri_lr=1e-6)


def _scene(seed=0, P=150, Pe=200):
    """test_torch_train_step's scene at 64 x 32: a mid-run Adam state."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * [0.4, 0.8],
                          rng.random((P, 1)) * 2 + 2.0],
                         -1).astype(np.float32)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=160,
                       sh_degree=3, init_opacity=0.6)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=256,
                      sh_degree=3, init_opacity=0.6)
    state = jtrain.init_train_state(base, env, jax.random.PRNGKey(0))

    def moments(pool):
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


def _jax_step(state, batch, cfg, cam_opt=False):
    jcam = make_camera(H, W, K, EYE, ZERO)
    if cam_opt:
        step = jtrain.make_train_step(
            jcam, cfg, jsup.LossConfig(**LOSS_CFG), jopt.LRConfig(),
            jopt.LRConfig(), donate=False, has_norm=True,
            cam_opt=jtrain.CamOptConfig(**COPT))
        new, cs, stats = step(state, jtrain.init_cam_opt(4),
                              jtrain.Batch(*map(jnp.asarray, batch)),
                              jcam.K, jcam.R, jcam.T, jnp.asarray(2),
                              jnp.asarray(IT))
        return new, stats, np.asarray(cs.res.se3), np.asarray(cs.res.intr)
    step = jtrain.make_train_step(
        jcam, cfg, jsup.LossConfig(**LOSS_CFG), jopt.LRConfig(),
        jopt.LRConfig(), donate=False, has_norm=True)
    new, stats = step(state, jtrain.Batch(*map(jnp.asarray, batch)), jcam.K,
                      jcam.R, jcam.T, jnp.asarray(IT))
    return new, stats, None, None


def _loss_maps(seed):
    """Random maps of every term compute_losses reads, the batch, R."""
    rng = np.random.default_rng(seed)
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
    return maps, dpt, gt, msk, nrm, R


def _ranks(tmp, world, start, batch, tcfg, cam_opt=False, losses=None):
    return run_ranks(
        band_step_worker, world, tmp, start, batch, K, (H, W, EYE, ZERO),
        tcfg, tsup.LossConfig(**LOSS_CFG), topt.LRConfig(), IT, True,
        ttrain.CamOptConfig(**COPT) if cam_opt else None, 4, 2, losses)


@pytest.fixture(scope="module")
def default_case(tmp_path_factory):
    """The sedan-like configuration with every loss term: JAX's single-chip
    step, the port's single step (with its gradients) and the port's band
    step on 2 and 4 ranks, from one numpy state."""
    state, batch = _scene()
    start = _jax_state_to_numpy(state)
    jnew, jstats, _, _ = _jax_step(state, batch, jenv.EnvGSConfig(
        raster_backend="pallas_interp", tracer_backend="tiled_interp", **KW))
    tcfg = tenv.EnvGSConfig(**KW)
    tcam_ = tcam.make_camera(H, W, K, EYE, ZERO)
    single_grads = {}
    with on_one_thread():
        step = ttrain.make_train_step(
            tcam_, tcfg, tsup.LossConfig(**LOSS_CFG), topt.LRConfig(),
            topt.LRConfig(), has_norm=True)
        step(ttrain.state_from_numpy(start),
             ttrain.Batch(*map(torch.tensor, batch)), tcam_.K, tcam_.R,
             tcam_.T, IT, grads_out=single_grads)
    tmp = tmp_path_factory.mktemp("bands")
    ranks = {}
    for n in (2, 4):  # the band losses ride in the same ranks
        maps, dpt, gt, msk, nrm, R = _loss_maps(n)
        ranks[n] = _ranks(tmp, n, start, batch, tcfg, losses=(
            dict(maps, dpt_map=dpt), gt, msk, nrm, R, 100,
            tsup.LossConfig(**LOSS_CFG)))
    return dict(start=start, want=_jax_state_to_numpy(jnew),
                jstats={k: float(v) for k, v in jstats.items()},
                single=single_grads, ranks=ranks)


def _check_state(got, want, s0, max_env_flips=2):
    """New params, moments (their change from the start) and grad_accum
    within GRAD_RTOL, counts and radii equal, the wet accumulator within
    rtol 1e-2 atol 1e-3; env surfels met only at the alpha floor may flip
    (at most max_env_flips, each of weight below 1e-3), left out."""
    for name in ("base", "env"):
        g, w, s = got[name], want[name], s0[name]
        flip = g["stats"]["denom"] != w["stats"]["denom"]
        if name == "base":
            assert not flip.any()
        assert flip.sum() <= max_env_flips, flip.sum()
        assert (g["stats"]["weight_accum"][flip] < 1e-3).all()
        assert (w["stats"]["weight_accum"][flip] < 1e-3).all()
        keep = ~flip
        for grp in ("params", "mu", "nu"):
            for k, wv in w[grp].items():
                _close((g[grp][k] - s[grp][k])[keep], (wv - s[grp][k])[keep],
                       name=f"{name} {grp} {k}")
        gs, ws = g["stats"], w["stats"]
        for k in ("denom", "max_radii2d", "active"):
            np.testing.assert_array_equal(gs[k][keep], ws[k][keep],
                                          err_msg=k)
        _close(gs["grad_accum"][keep], ws["grad_accum"][keep],
               name=f"{name} grad_accum")
        np.testing.assert_allclose(gs["weight_accum"], ws["weight_accum"],
                                   rtol=1e-2, atol=1e-3)
        assert ws["denom"].sum() > 0.3 * len(ws["denom"])


@pytest.mark.parametrize("n", [2, 4])
def test_band_step_matches_jax(default_case, n):
    """The band step's new state against JAX's single-chip step; its loss
    terms (meaned over the bands) within LOSS_RTOL of the image's."""
    c = default_case
    got = c["ranks"][n][0]
    _check_state(got["state"], c["want"], c["start"])
    assert set(got["stats"]) == set(c["jstats"]) - {
        "num_pts", "env_num_pts", "pair_overflow", "trace_dropped"}
    for k, v in got["stats"].items():
        if k != "psnr":  # a band's, meaned over the bands
            np.testing.assert_allclose(v, c["jstats"][k], rtol=LOSS_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_band_step_gradients_match_single_step(default_case, n):
    """Every gradient the band step sums over the bands (both pools'
    params, the screen-space and world-space densification hooks, the two
    wet hooks) against the port's single step's, per array within
    GRAD_RTOL: the wet hooks carry each band's wet, the position hooks the
    band's share of the mean's gradient, and their sums are the image's."""
    c = default_case
    got = c["ranks"][n][0]["grads"]
    want = c["single"]
    for k in ("base", "env"):
        for f, v in got[k].items():
            _close(v, getattr(want[k], f).numpy(), name=f"{k} {f}")
    for k in ("means2d", "env_means3d", "wet_base", "wet_env"):
        _close(got[k], want[k].numpy(), name=k)
    assert np.abs(got["wet_base"]).max() > 1.0


@pytest.mark.parametrize("n", [2, 4])
def test_band_state_is_equal_across_ranks(default_case, n):
    """The replicated state, stats and summed gradients: bit-equal on
    every rank."""
    ranks = default_case["ranks"][n]

    def flat(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{path}/{k}")
        elif tree is not None:
            yield path, np.asarray(tree)

    first = dict(flat({k: v for k, v in ranks[0].items() if k != "losses"}))
    for r in ranks[1:]:
        other = dict(flat({k: v for k, v in r.items() if k != "losses"}))
        assert other.keys() == first.keys()
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_band_step_with_camera_opt_and_base_tracing(tmp_path):
    """Camera optimisation (the residual on the full camera, then the
    band) and the traced base (the (P, 3) world-space hook) on 2 ranks
    against JAX's single-chip step with both, the `ref` oracles on both
    sides: the new state and the view's residuals within GRAD_RTOL of their
    change."""
    state, batch = _scene(seed=1)
    start = _jax_state_to_numpy(state)
    kw = dict(KW, use_base_tracing=True)
    jnew, jstats, se3, intr = _jax_step(state, batch, jenv.EnvGSConfig(
        raster_backend="ref", tracer_backend="ref", **kw), cam_opt=True)
    ranks = _ranks(tmp_path, 2, start, batch, tenv.EnvGSConfig(
        raster_backend="ref", tracer_backend="ref", **kw), cam_opt=True)
    got = ranks[0]
    _check_state(got["state"], _jax_state_to_numpy(jnew), start)
    _close(got["cam"]["se3"], se3, name="se3")
    _close(got["cam"]["intr"], intr, name="intr")
    assert np.abs(se3[2]).max() > 0 and np.abs(se3[0]).max() == 0
    assert got["grads"]["means2d"].shape == (160, 3)
    for k in ("loss", "img_loss", "ssim_loss", "gs_norm_loss"):
        np.testing.assert_allclose(got["stats"][k], float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for r in ranks[1:]:
        for k, v in got["cam"].items():
            np.testing.assert_array_equal(r["cam"][k], v)


@pytest.mark.parametrize("n", [2, 4])
def test_band_losses_match_jax(default_case, n):
    """compute_losses(band=) over n ranks (SSIM through halos, the depth
    quantiles over the image) against JAX's compute_losses of the whole
    image, every term on: values within LOSS_RTOL, the gradients with
    respect to every map within GRAD_RTOL; psnr stays the bands' mean of
    their own PSNRs, as in the JAX package."""
    maps, dpt, gt, msk, nrm, R = _loss_maps(n)
    names = list(maps)

    def jloss(*vals):
        fields = {k: jnp.zeros(()) for k in jenv.EnvGSOutput._fields}
        fields.update(zip(names, vals), dpt_map=jnp.asarray(dpt))
        return jsup.compute_losses(
            jenv.EnvGSOutput(**fields), jnp.asarray(gt), jnp.asarray(msk),
            jnp.asarray(nrm), jnp.asarray(R), 100,
            jsup.LossConfig(**LOSS_CFG), bg_brightness=0.3)

    (_, jstats), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(maps[k]) for k in names])
    ranks = [r["losses"] for r in default_case["ranks"][n]]
    stats = ranks[0]["stats"]
    assert set(stats) == set(jstats)
    for k in jstats:
        if k != "psnr":
            np.testing.assert_allclose(stats[k], float(jstats[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    h = H // n
    gt_bg = gt + 0.3 * (1 - msk)
    band_psnr = [float(jlosses.psnr(jnp.asarray(maps["rgb_map"][b * h:(b + 1)
                                                               * h]),
                                    jnp.asarray(gt_bg[b * h:(b + 1) * h])))
                 for b in range(n)]
    np.testing.assert_allclose(stats["psnr"], np.mean(band_psnr), rtol=1e-5)
    for i, k in enumerate(names):
        if k == "env_opacity":
            got = ranks[0]["grads"][k]
        else:
            got = np.concatenate([r["grads"][k] for r in ranks])
        _close(got, np.asarray(jg[i]), name=k)
    for r in ranks[1:]:
        assert r["stats"] == stats

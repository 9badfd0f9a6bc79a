"""Parity of the port's train_gaussiant loop (envgs_tpu_torch/train/
gaussiant_loop.py) with the loop of the JAX package's
cli.py::train_gaussiant, its views and points handed in."""
import json
import re

import jax
import numpy as np
import torch

from envgs_tpu import cli as jcli
from envgs_tpu.models import gaussiant as jgt
from envgs_tpu_torch.models import gaussiant as tgt
from envgs_tpu_torch.train.gaussiant_loop import train_gaussiant
from test_torch_gaussiant import (
    CAP,
    CFG,
    H,
    P,
    W,
    _cams,
    _close,
    _jax_state_to_numpy,
    _points,
)


def _loop_inputs():
    """Two train views and one eval view (random targets) of the points."""
    rng = np.random.default_rng(4)
    xyz, rgb = _points(5)
    views = []
    for deg in (-3.0, 0.0, 3.0):
        jc, tc = _cams(deg)
        views.append((jc, tc, rng.random((H, W, 3)).astype(np.float32)))
    return xyz, rgb, views


def test_train_gaussiant_matches_jax_loop(monkeypatch, capsys, tmp_path):
    """Four iterations of the loop on both sides (densification by cloning
    at it=2, so no random draw is taken): the logged loss and point count of
    every logged iteration, the final pool (params within GRAD_RTOL of each
    array's max, `active` exactly) and the eval PSNR / SSIM."""
    xyz, rgb, views = _loop_inputs()
    spatial_scale = 2.5
    sampler = dict(CFG, pool_cap=CAP, densify_from_iter=2,
                   densification_interval=2, densify_grad_threshold=1e-6,
                   densify_size_threshold=100.0)
    runner = dict(epochs=1, ep_iter=4, log_interval=1)

    def jviews(idx):
        return [dict(rgb=views[i][2], camera=views[i][0]) for i in idx]

    monkeypatch.setattr(jcli, "_load_views", lambda cfg: (
        jviews([0, 2]), jviews([1]), xyz, rgb, None, spatial_scale))
    render = jgt.render_gaussiant

    def jitted_eval_render(pool, cam, cfg, means2d_zero=None):
        """The loop's eval render, jitted (eager interpret mode is slow)."""
        if means2d_zero is not None:
            return render(pool, cam, cfg, means2d_zero)
        return jax.jit(lambda p: render(p, cam, cfg))(pool)

    monkeypatch.setattr(jgt, "render_gaussiant", jitted_eval_render)
    jstate = jcli.train_gaussiant(dict(
        exp_name="loop", out_root=str(tmp_path),
        model_cfg=dict(sampler_cfg=dict(sampler, raster_backend="pallas")),
        runner_cfg=runner))
    jlog = capsys.readouterr().out

    tviews = [dict(rgb=views[i][2], camera=views[i][1]) for i in (0, 2)]
    tstate, summary = train_gaussiant(
        tviews, [dict(rgb=views[1][2], camera=views[1][1])], xyz, rgb,
        sampler, runner, spatial_scale, torch.Generator().manual_seed(0))
    tlog = capsys.readouterr().out

    pat = re.compile(r"iter (\d+)/4 loss ([\d.]+) psnr ([\d.]+) pts (\d+)")
    jl, tl = pat.findall(jlog), pat.findall(tlog)
    assert len(jl) == len(tl) == 4
    for (ji, jloss, jpsnr, jpts), (ti, tloss, tpsnr, tpts) in zip(jl, tl):
        assert ji == ti and jpts == tpts
        assert abs(float(jloss) - float(tloss)) <= 1e-4
        assert abs(float(jpsnr) - float(tpsnr)) <= 1e-2
    assert int(jl[-1][3]) > P  # clones landed
    got, want = tgt.gaussiant_state_to_numpy(tstate), _jax_state_to_numpy(
        jstate)
    np.testing.assert_array_equal(got["stats"]["active"],
                                  want["stats"]["active"])
    # the loop's pool starts isotropic (three equal 3-NN scales), so the
    # rotations' gradients are rounding noise that Adam turns into steps of
    # +-lr on either side: rotations are held to their bound by
    # test_torch_gaussiant's one-step test, which starts anisotropic
    for k, w in want["params"].items():
        if k != "rotation":
            _close(got["params"][k], w, name=k)
    jsum = json.JSONDecoder().raw_decode(jlog[jlog.index("\n{") + 1:])[0]
    np.testing.assert_allclose(summary["psnr"], jsum["psnr_mean"], rtol=1e-4)
    np.testing.assert_allclose(summary["ssim"], jsum["ssim_mean"], atol=1e-5)

"""`train -c` of the shipped NeRF, NeuS and ENeRF configs through the
port's command line against the JAX package's trainers (train_nerf,
train_neus, train_enerf), cut down to 4 views of 16x16 and 3 iterations:
the port resumes the latest.npz of iteration 0 that JAX's FamilyLoop
writes from JAX's initial weights and optax state, NeRF and NeuS take
JAX's own uniform draws per step (the key splits of JAX's loops), and both
pick the same rays and views (np.random.default_rng(0)). The loss of each
iteration, every final parameter leaf, metrics.json, and latest.npz read
back by JAX's FamilyLoop are compared.

The first iteration's loss (the same weights, batch and draws) is held to
1e-5. The steps themselves are held to JAX's in test_torch_nerf.py,
test_torch_neus.py and test_torch_enerf.py; over a loop, Adam turns a
gradient that float32 cannot resolve into a move of about the learning
rate either way, and NeRF's geometry gradient through the undetached
inverse CDF is such a gradient: on this config's first batch the port's
float32 gradient of the fine round's loss differs from its own float64 one
by several percent of a leaf's largest (the CDF's bins of width eps
divide; `python -m envgs_tpu_torch.probes.family_steps --float64`). The
later losses are held to LOOP_LOSS_RTOL and each
final parameter to PARAM_RTOL of its leaf's largest or, if more, to
ADAM_REACH: twice the most Adam moves a weight in N_ITERS steps.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from envgs_tpu.engine import TRAINERS as JTRAINERS
from envgs_tpu.engine import load_config as jload
from envgs_tpu.models import enerf as je
from envgs_tpu.models import nerf as jn
from envgs_tpu.models import neus as jneus
from envgs_tpu.train import families as jfam
from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import TRAINERS
from envgs_tpu_torch.models import enerf as te
from envgs_tpu_torch.models import nerf as tn
from envgs_tpu_torch.models import neus as tneus
from envgs_tpu_torch.train import families as tfam
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPS = os.path.join(ROOT, "configs", "exps")
# the first iteration's loss, relative (float32 sums in another order)
LOSS_RTOL = 1e-5
# the later iterations' losses, relative (Adam's moves in between)
LOOP_LOSS_RTOL = 2e-3
# the final parameters: per leaf max|d| / max|ref|, or ADAM_REACH
PARAM_RTOL = 5e-4
N_ITERS = 3

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = {
    # name: (config, TRAINERS name, JAX module, step maker, port module)
    "nerf": ("nerf_synthetic.yaml", "VolumetricVideoNetwork", jn,
             "make_nerf_train_step", tn),
    "neus": ("neus_synthetic.yaml", "NeusNetwork", jneus,
             "make_neus_train_step", tneus),
    "enerf": ("enerf_synthetic.yaml", "CostVolumeSampler", je,
              "make_enerf_train_step", te),
}


def _cut(out_root, *extra):
    return ["dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=4",
            f"out_root={out_root}", f"runner_cfg.ep_iter={N_ITERS}",
            "runner_cfg.log_interval=1", "runner_cfg.record=false", *extra]


def _jax_init(family, cfg, lr):
    """JAX's initial (params, optax state), as its loop makes them."""
    mcfg = cfg["model_cfg"]
    key = jax.random.PRNGKey(0)
    if family == "enerf":
        ecfg = jfam._named(je.ENeRFConfig, mcfg["sampler_cfg"])
        params = je.init_enerf(ecfg, key)
    else:
        ncfg = jfam._named(
            jn.NerfConfig if family == "nerf" else jneus.NeusConfig,
            {**mcfg.get("network_cfg", {}), **mcfg.get("sampler_cfg", {})})
        params = ncfg.init(jax.random.split(key)[1])
    return params, optax.adam(lr).init(params)


def _jax_step_keys():
    """The step keys of JAX's NeRF / NeuS loops."""
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    keys = []
    for _ in range(N_ITERS):
        key, sk = jax.random.split(key)
        keys.append(sk)
    return keys


def _draws(family, n_rays, n_samples):
    """Per iteration, the step's keyword arguments carrying JAX's draws."""
    out = []
    for sk in _jax_step_keys():
        if family == "nerf":  # one split a round (render_rays_nerf)
            ds, key = [], sk
            for n in n_samples:
                key, k = jax.random.split(key)
                ds.append(torch.tensor(np.asarray(
                    jax.random.uniform(k, (n_rays, n)))))
            out.append(dict(draws=ds))
        else:  # render_rays_neus draws from the step's key itself
            out.append(dict(u=torch.tensor(np.asarray(
                jax.random.uniform(sk, (n_rays, n_samples))))))
    return out


def _record(monkeypatch, module, name, losses, feed=None):
    """Wrap module.<name>'s step: its loss appended to `losses`, and the
    i-th call given feed[i] as keyword arguments."""
    make = getattr(module, name)

    def made(*a, **kw):
        init, step = make(*a, **kw)

        def recorded(*args, **k):
            if feed is not None:
                k = {**{kk: v for kk, v in k.items() if kk != "generator"},
                     **feed[len(losses)]}
            res = step(*args, **k)
            losses.append(float(res[-1]["loss"]))
            return res
        return init, recorded
    monkeypatch.setattr(module, name, made)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_entry_point_matches_jax(tmp_path, monkeypatch, family):
    yaml_name, tname, jmod, maker, tmod = FAMILIES[family]
    path = os.path.join(EXPS, yaml_name)
    exp = os.path.splitext(yaml_name)[0]
    jlosses, tlosses = [], []
    _record(monkeypatch, jmod, maker, jlosses)
    JTRAINERS.get(tname)(jload(path, overrides=_cut(tmp_path / "jax"),
                               root=ROOT))
    # JAX's initial weights and optax state as a latest.npz of iteration 0
    # where the port's run looks for one
    tcfg = jload(path, overrides=_cut(tmp_path / "port"), root=ROOT)
    lr = float(tcfg["runner_cfg"].get("lr", 5e-4))
    params, ostate = _jax_init(family, tcfg, lr)
    jfam.FamilyLoop(tcfg, family).save(0, params, ostate)
    feed = None
    if family != "enerf":
        ncfg = tcfg["model_cfg"]["network_cfg"]
        feed = _draws(family, int(tcfg["runner_cfg"]["n_rays"]),
                      ncfg["n_samples"])
    _record(monkeypatch, tmod, maker, tlosses, feed)
    net, summary = cli.main(["train", "-c", path,
                             *_cut(tmp_path / "port")], device="cpu")
    assert TRAINERS.get(tname).__module__ == tfam.__name__
    assert len(tlosses) == len(jlosses) == N_ITERS
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOOP_LOSS_RTOL)

    jz = np.load(tmp_path / "jax" / "trained_model" / exp / "latest.npz")
    tz = np.load(tmp_path / "port" / "trained_model" / exp / "latest.npz")
    got = tfam.tree_flatten(net.jax_params())
    assert int(jz["iter"]) == int(tz["iter"]) == N_ITERS
    assert len(got) == len(jax.tree_util.tree_leaves(params))
    reach = 2 * lr * N_ITERS  # Adam moves a weight at most about lr a step
    for i, g in enumerate(got):
        want = jz[f"p{i}"]
        err = np.abs(g.detach().numpy() - want).max()
        assert err <= max(PARAM_RTOL * np.abs(want).max(), reach), (i, err)
        np.testing.assert_array_equal(tz[f"p{i}"], g.detach().numpy())
    # the port's latest.npz resumes in JAX's loop, leaf for leaf
    blank = jax.tree_util.tree_map(jnp.zeros_like, (params, ostate))
    jp, jo, start = jfam.FamilyLoop(tcfg, family).restore(*blank)
    assert start == N_ITERS
    for i, x in enumerate(jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(x), tz[f"p{i}"])
    n_o = len(jax.tree_util.tree_leaves(jo))
    assert n_o == len([k for k in tz.files if k.startswith("o")])
    jsum = json.load(open(tmp_path / "jax" / "result" / exp /
                          "metrics.json"))["summary"]
    s = summary["summary"]
    assert np.isfinite(s["psnr_mean"])
    np.testing.assert_allclose(s["psnr_mean"], jsum["psnr_mean"], rtol=1e-4)
    saved = json.load(open(tmp_path / "port" / "result" / exp /
                           "metrics.json"))["summary"]
    assert saved["psnr_mean"] == s["psnr_mean"]

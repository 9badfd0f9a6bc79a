"""How well float32 resolves the kernel-free families' gradients.

    python -m envgs_tpu_torch.probes.family_steps            # on the card
    python -m envgs_tpu_torch.probes.family_steps --float64  # any device

On the card: where a small NeRF step's gradients part between the card and
the CPU (bench.family_small_step's NeRF: two networks, 16 + 16 samples, 48
rays): per parameter leaf (the JAX tree's leaf order), max|d| / max|ref|
of the card's float32 gradients and of the CPU's against the CPU's float64
ones (the reference), the card's float64 against the CPU's float64, and
then every ReLU unit of the networks whose pre-activation takes another
sign on the card than on the CPU in float32, with its size. A unit at its
kink on one device only moves the gradients of the layers upstream of it.

With --float64 (on the CPU): the worst leaf of the float32 gradients
against the float64 ones, max|d| / max|ref|, for NeRF's step on the first
batch of `train -c configs/exps/nerf_synthetic.yaml` cut to 4 views of
16x16 (the fine round's loss: its gradient reaches the coarse network
through the undetached inverse CDF), and for bench.family_small_step's
ENeRF (its cost heads behind the depth softmax, and the largest logit).
"""
from __future__ import annotations

import numpy as np
import torch

from envgs_tpu_torch.models import nerf as N
from envgs_tpu_torch.models import regressors as R
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import grads_of


def nerf_grads(device, dtype, pre=None):
    """The small NeRF step's loss gradients (float64 numpy, leaf order) on
    `device` in `dtype`; with `pre` (a list), each MLP layer's
    pre-activations are appended to it."""
    rng = np.random.default_rng(0)
    P = 48
    o = rng.normal(size=(P, 3)) * 0.1 + np.array([0.0, 0.0, -2.0])
    d = rng.normal(size=(P, 3)) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full(P, 0.5), np.full(P, 4.0)
    target = rng.uniform(0, 1, (P, 3))
    cfg = N.NerfConfig(xyz_freqs=4, dir_freqs=2, width=32, depth=5,
                       feat_dim=16, n_samples=(16, 16), separate_levels=True)
    net = cfg.init(torch.Generator().manual_seed(0)).to(dtype).to(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dtype).to(device)

    draws = [t(rng.uniform(0, 1, (P, n))) for n in cfg.n_samples]
    forward = R.MLP.forward

    def recording(self, x):
        h = x
        for i in range(self.depth):
            if i in self.skips and i > 0:
                h = torch.cat([h, x], dim=-1)
            z = h @ self.weights[i] + self.biases[i]
            pre.append(z.detach().double().cpu())
            h = torch.relu(z)
        out = h @ self.weights[self.depth] + self.biases[self.depth]
        return torch.sigmoid(out) if self.out_actvn == "sigmoid" else out

    if pre is not None:
        R.MLP.forward = recording
    try:
        out = N.render_rays_nerf(cfg, net, t(o), t(d), t(near), t(far),
                                 draws=draws)
    finally:
        R.MLP.forward = forward
    loss = sum(torch.mean((out[f"round{r}"]["rgb_map"] - t(target)) ** 2)
               for r in range(len(cfg.n_samples)))
    return [g.double().cpu().numpy()
            for g in grads_of(loss, tree_flatten(net.jax_params()))]


def _rel(got, want):
    top = max(np.abs(w).max() for w in want)
    return [np.abs(g - w).max() / max(np.abs(w).max(), 1e-2 * top)
            for g, w in zip(got, want)]


def _f64_gap(fn) -> list:
    """fn(dtype) -> gradients (float64 numpy): per leaf, the float32 ones'
    max|d| / max|ref| against the float64 ones."""
    return _rel(fn(torch.float32), fn(torch.float64))


def _nerf_loop_batch(dtype):
    """The NeRF loop's first step on nerf_synthetic.yaml cut to 4 views of
    16x16: its ray batch (np.random.default_rng(0)), the port's initial
    weights (generator seed 0), the fine round's loss's gradients."""
    import os

    from envgs_tpu_torch.engine import load_config
    from envgs_tpu_torch.train import families as F

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = load_config(os.path.join(root, "configs", "exps",
                                   "nerf_synthetic.yaml"), overrides=[
        "dataset_cfg.H=16", "dataset_cfg.W=16", "dataset_cfg.n_views=4"])
    views, _ = F._load_views_generic(cfg, "cpu")
    ro, rd, rgb = (x.to(dtype) for x in F._ray_pool(views, "cpu"))
    ncfg = N.NerfConfig(**{k: v for k, v in cfg["model_cfg"][
        "network_cfg"].items() if k != "type"})
    net = ncfg.init(torch.Generator().manual_seed(0)).to(dtype)
    n = int(cfg["runner_cfg"]["n_rays"])
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, ro.shape[0], n))
    draws = [torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (n, k)).astype(np.float32)).to(dtype) for k in ncfg.n_samples]
    out = N.render_rays_nerf(ncfg, net, ro[idx], rd[idx],
                             torch.full((n,), 0.5, dtype=dtype),
                             torch.full((n,), 8.0, dtype=dtype), draws=draws)
    loss = torch.mean((out["round1"]["rgb_map"] - rgb[idx]) ** 2)
    return [g.double().numpy()
            for g in grads_of(loss, tree_flatten(net.jax_params()))]


def _enerf_small(dtype, logits=None):
    """bench.family_small_step's ENeRF loss gradients in `dtype` (cost
    heads first in the leaf order after `agg`); `logits`, a list, gets the
    level-0 depth logits' largest magnitude."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models import enerf as E

    conv3 = E._conv3
    if logits is not None:
        def recording(x, p):
            y = conv3(x, p)
            if y.shape[-1] == 1:
                logits.append(float(y.detach().abs().max()))
            return y
        E._conv3 = recording
    try:
        got = bench.family_small_step("enerf", "cpu", dtype=dtype)
    finally:
        E._conv3 = conv3
    return [g.astype(np.float64) for g in got["grads"]]


def float64_gaps():
    nerf = _f64_gap(_nerf_loop_batch)
    print(f"NeRF, nerf_synthetic.yaml's first batch, the fine round's loss: "
          f"float32 against float64, worst leaf {max(nerf):.3g} (per leaf: "
          + " ".join(f"{e:.2g}" for e in nerf) + ")")
    logits = []
    _enerf_small(torch.float32, logits)
    enerf = _f64_gap(_enerf_small)
    print(f"ENeRF, the small step: float32 against float64, worst leaf "
          f"{max(enerf):.3g}, the cost heads' worst {max(enerf[4:12]):.3g}; "
          f"depth logits up to {max(logits):.4g}")


def main(argv=None):
    import sys

    if "--float64" in (sys.argv[1:] if argv is None else argv):
        return float64_gaps()
    if not torch.cuda.is_available():
        raise SystemExit("family_steps: needs a CUDA card")
    ref = nerf_grads("cpu", torch.float64)
    rows = {"cuda f32": _rel(nerf_grads("cuda", torch.float32), ref),
            "cpu f32": _rel(nerf_grads("cpu", torch.float32), ref),
            "cuda f64": _rel(nerf_grads("cuda", torch.float64), ref)}
    for name, errs in rows.items():
        print(f"{name} against cpu f64, per leaf: "
              + " ".join(f"{e:.2g}" for e in errs))
    pre = {"cpu": [], "cuda": []}
    for dev in pre:
        nerf_grads(dev, torch.float32, pre[dev])
    for k, (a, b) in enumerate(zip(pre["cpu"], pre["cuda"])):
        flip = (a > 0) != (b > 0)
        if flip.any():
            print(f"MLP layer call {k}: {int(flip.sum())} units of another "
                  f"sign on the card, |pre-activation| up to "
                  f"{float(a[flip].abs().max()):.3g}")


if __name__ == "__main__":
    main()

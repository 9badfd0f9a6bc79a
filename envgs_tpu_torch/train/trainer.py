"""EnvGS train step (port of envgs_tpu/train/trainer.py::make_train_step,
without camera optimisation and aux supervisors).

One step: the forward through both passes in training mode, the losses,
`torch.autograd.grad` of the loss with respect to both pools' parameters
and the four zeros hooks, masked sparse Adam on both pools, and the
densification statistics. The hooks' gradients are the screen-space
(base) and world-space (env) densification gradients and the per-splat
wet of each pass, so no `.grad` is retained and no forward wet is built.

The JAX TrainState's random key is left out: the step draws no random
numbers, and the maintenance events that do (densify, color sabotage)
are not ported yet; they will bring a `torch.Generator`.

`state_to_numpy` / `state_from_numpy` carry a train state across the two
packages under the JAX field names.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu_torch.train.optimizer import (
    AdamState,
    LRConfig,
    init_adam,
    lr_tree_for,
    sparse_adam_update,
)
from envgs_tpu_torch.train.supervisor import LossConfig, compute_losses
from envgs_tpu_torch.utils.camera import Camera


class TrainState(NamedTuple):
    base: G.GaussianPool
    env: G.GaussianPool
    opt_base: AdamState
    opt_env: AdamState


class Batch(NamedTuple):
    """One training view."""

    rgb: torch.Tensor  # (H, W, 3)
    msk: torch.Tensor  # (H, W, 1)
    norm: torch.Tensor  # (H, W, 3) monocular prior (zeros if absent)


def init_train_state(base: G.GaussianPool, env: G.GaussianPool) -> TrainState:
    return TrainState(base, env, init_adam(base.params), init_adam(env.params))


def make_train_step(cam: Camera, model_cfg: EnvGSConfig, loss_cfg: LossConfig,
                    lr_base: LRConfig, lr_env: LRConfig,
                    has_norm: bool = False):
    """The train step for the template camera's resolution and planes.

    step(state, batch, K, R, T, it, mark=None, grads_out=None) -> (new
    state, stats dict). `mark(name)`, when given, is called as each stage
    ends ("forward", "backward", "optimizer"), e.g. to record CUDA events;
    `grads_out`, a dict, receives the step's gradients ("base", "env":
    GaussianParams; "means2d", "env_means3d", "wet_base", "wet_env")."""
    H, W, znear, zfar = cam.H, cam.W, cam.znear, cam.zfar

    def step(state: TrainState, batch: Batch, K, R, T, it: int,
             mark: Callable[[str], None] | None = None,
             grads_out: dict | None = None):
        base, env = state.base, state.env
        dev = base.params.xyz.device
        leaf = lambda x: x.detach().requires_grad_(True)  # noqa: E731
        bparams = G.GaussianParams(*map(leaf, base.params))
        eparams = G.GaussianParams(*map(leaf, env.params))
        zeros = lambda *s: torch.zeros(s, device=dev, requires_grad=True)  # noqa: E731
        m2z, e3z = zeros(base.cap, 2), zeros(env.cap, 3)
        wz_b, wz_e = zeros(base.cap), zeros(env.cap)

        camera = Camera(H, W, K, R, T, znear, zfar)
        out = forward_envgs(base._replace(params=bparams),
                            env._replace(params=eparams), camera, it,
                            model_cfg, m2z, e3z, wz_b, wz_e)
        loss, stats = compute_losses(
            out, batch.rgb, batch.msk, batch.norm if has_norm else None,
            camera.R, it, loss_cfg, bg_brightness=model_cfg.bg_brightness)
        if mark:
            mark("forward")

        leaves = [*bparams, *eparams, m2z, e3z, wz_b, wz_e]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        nb, ne = len(bparams), len(eparams)
        g_base = G.GaussianParams(*grads[:nb])
        g_env = G.GaussianParams(*grads[nb:nb + ne])
        g_m2z, g_e3z, g_wet_b, g_wet_e = grads[nb + ne:]
        if grads_out is not None:
            grads_out.update(base=g_base, env=g_env, means2d=g_m2z,
                             env_means3d=g_e3z, wet_base=g_wet_b,
                             wet_env=g_wet_e)
        if mark:
            mark("backward")

        # one of {forward wet, gradient-lane wet} is exact zeros: the port's
        # training path always uses the lane
        wet_b = g_wet_b + out.base_wet.detach()
        wet_e = g_wet_e + out.env_wet.detach()
        new_bp, opt_base = sparse_adam_update(
            base.params, g_base, state.opt_base, lr_tree_for(it, lr_base))
        new_ep, opt_env = sparse_adam_update(
            env.params, g_env, state.opt_env, lr_tree_for(it, lr_env))
        b_stats = G.accumulate_stats(
            base.stats, g_m2z, out.base_visibility | (wet_b > 0),
            weight=wet_b, radii=out.base_radii.detach())
        e_stats = G.accumulate_stats(
            env.stats, g_e3z, out.env_visibility | (wet_e > 0), weight=wet_e)
        new_state = TrainState(base._replace(params=new_bp, stats=b_stats),
                               env._replace(params=new_ep, stats=e_stats),
                               opt_base, opt_env)
        stats["num_pts"] = base.stats.active.sum()
        stats["env_num_pts"] = env.stats.active.sum()
        # capacity truncation counters: pairs past the raster budget, and
        # tracer slots lost to the env budget (0 = nothing dropped)
        stats["pair_overflow"] = torch.clamp(
            out.base_num_pairs - model_cfg.pair_cap, min=0)
        stats["trace_dropped"] = out.env_dropped_pairs
        if mark:
            mark("optimizer")
        return new_state, stats

    return step


# ---------------------------------------------------------------------------
# Weight bridge: train states as numpy under the JAX field names
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def pool_state_to_numpy(pool: G.GaussianPool, opt: AdamState) -> dict:
    """{"params", "stats", "mu", "nu": {field: array}, "step": int,
    "max_sh_degree": int} of one pool and its Adam state."""
    params, stats = G.pool_to_numpy(pool)
    return dict(params=params, stats=stats,
                mu={k: _np(v) for k, v in opt.mu._asdict().items()},
                nu={k: _np(v) for k, v in opt.nu._asdict().items()},
                step=int(opt.step), max_sh_degree=pool.max_sh_degree)


def pool_state_from_numpy(s: dict, device=None):
    """Inverse of pool_state_to_numpy -> (pool, AdamState). Parameter dicts
    may carry the JAX package's temporal fields as None (the static
    families)."""
    def params(fields):
        return G.GaussianParams(*(
            torch.tensor(np.asarray(fields[k]), dtype=torch.float32,
                         device=device)
            for k in G.GaussianParams._fields))

    return (G.pool_from_numpy(s["params"], s["stats"], s["max_sh_degree"],
                              device),
            AdamState(params(s["mu"]), params(s["nu"]),
                      torch.tensor(int(s["step"]), dtype=torch.int32,
                                   device=device)))


def state_to_numpy(state: TrainState) -> dict:
    """{"base"|"env": pool_state_to_numpy of that pool}."""
    return {"base": pool_state_to_numpy(state.base, state.opt_base),
            "env": pool_state_to_numpy(state.env, state.opt_env)}


def state_from_numpy(d: dict, device=None) -> TrainState:
    """Inverse of state_to_numpy."""
    (base, opt_base), (env, opt_env) = (
        pool_state_from_numpy(d[k], device) for k in ("base", "env"))
    return TrainState(base, env, opt_base, opt_env)

"""The plain-3DGS training loop (port of the loop of
envgs_tpu/cli.py::train_gaussiant, without its config file, dataset and
ply parts): maintenance every iteration, views in `default_rng(0)`
permutations, one train step per view resolution, a log line every
`log_interval` iterations, and PSNR / SSIM on held-out views at the end.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from envgs_tpu_torch.models.gaussians import DensifyConfig
from envgs_tpu_torch.models.gaussiant import (
    GaussianTConfig,
    GaussianTState,
    gaussiant_maintenance,
    init_gaussiant_pool,
    init_gaussiant_state,
    make_gaussiant_train_step,
    render_gaussiant,
)
from envgs_tpu_torch.ops.losses import psnr, ssim


def _named(cls, cfg: dict):
    """cls built from the keys of cfg that are its fields."""
    return cls(**{k: v for k, v in (cfg or {}).items() if k in cls._fields})


def train_gaussiant(views: list, eval_views: list, init_xyz: np.ndarray,
                    init_rgb: np.ndarray, sampler_cfg: dict, runner_cfg: dict,
                    spatial_scale: float, generator: torch.Generator
                    ) -> tuple[GaussianTState, dict | None]:
    """Train a 3DGS pool on `views` and evaluate it on `eval_views`.

    views / eval_views: dicts with "rgb" ((H, W, 3) float array or tensor)
    and "camera" (a Camera whose tensors are on the generator's device).
    sampler_cfg: GaussianTConfig and DensifyConfig fields plus "pool_cap"
    (default max(4 points, 1024)); runner_cfg: "epochs", "ep_iter",
    "log_interval". The generator draws the densification's split offsets
    and sets the device. -> (final state, {"psnr", "ssim"} means over the
    eval views, or None without them)."""
    dev = generator.device
    gcfg = _named(GaussianTConfig, sampler_cfg)
    cap = int(sampler_cfg.get("pool_cap", max(len(init_xyz) * 4, 1024)))
    state = init_gaussiant_state(
        init_gaussiant_pool(init_xyz, init_rgb, cap, gcfg, device=dev))
    dcfg = _named(DensifyConfig, dict(sampler_cfg, spatial_scale=spatial_scale,
                                      max_gs=cap))
    total = int(runner_cfg.get("epochs", 1)) * int(runner_cfg.get("ep_iter",
                                                                  500))
    log_every = int(runner_cfg.get("log_interval", 50))

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    step_cache: dict = {}

    def step_for(cam):
        key = (cam.H, cam.W)
        if key not in step_cache:
            step_cache[key] = make_gaussiant_train_step(gcfg, cam)
        return step_cache[key]

    rng = np.random.default_rng(0)
    order = rng.permutation(len(views))
    oi = 0
    for it in range(total):
        state = gaussiant_maintenance(state, it, gcfg, dcfg, generator)
        v = views[int(order[oi])]
        oi = (oi + 1) % len(order)
        if oi == 0:
            order = rng.permutation(len(views))
        cam = v["camera"]
        state, aux = step_for(cam)(state, cam.K, cam.R, cam.T,
                                   tensor(v["rgb"]))
        if it % log_every == 0 or it == total - 1:
            print(f"iter {it}/{total} loss {float(aux['loss']):.4f} "
                  f"psnr {float(aux['psnr']):.2f} "
                  f"pts {int(aux['n_pts'])}", flush=True)

    summary = None
    if eval_views:
        scores = []
        with torch.no_grad():
            for v in eval_views:
                rgb = render_gaussiant(state.pool, v["camera"], gcfg).rgb
                gt = tensor(v["rgb"])
                scores.append((float(psnr(rgb, gt)), float(ssim(rgb, gt))))
        summary = {"psnr": float(np.mean([s[0] for s in scores])),
                   "ssim": float(np.mean([s[1] for s in scores]))}
        print(json.dumps(summary, indent=2))
    return state, summary

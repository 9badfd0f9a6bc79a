"""Sparse Adam and the learning rates of the repository's recipes
(envgs.yaml's optimizer_cfg), from their definitions.

Adam (b1 0.9, b2 0.999, eps 1e-15, bias-corrected) moves an element only
where its gradient is not exactly zero, and leaves its moments there
untouched. The position's rate decays log-linearly from 1.6e-4 to 1.6e-6
over 30,000 iterations; the opacity's follows 3DGS-DR's pulse between the
reflection's start and the end of normal propagation: 0.05, but 0 for the
200 iterations after each normal-propagation event (every 1000th
iteration past the reflection's start that is not an opacity reset, every
3000th, nor the end itself).
"""
from __future__ import annotations

import math

import torch

RATES = dict(xyz=None, features_dc=0.0025, features_rest=0.000125,
             opacity=0.05, scaling=0.005, rotation=0.001, specular=0.01,
             roughness=0.05)


def rates(it: int, reflection_start: int = 3000,
          normal_prop_until: int = 18000) -> dict:
    """{field: learning rate} at iteration `it`."""
    t = min(max(it / 30000, 0.0), 1.0)
    out = dict(RATES, xyz=math.exp((1 - t) * math.log(1.6e-4)
                                   + t * math.log(1.6e-6)))
    last = it // 200 * 200
    event = (last % 1000 == 0 and last % 3000 != 0
             and last != normal_prop_until and last > reflection_start)
    if reflection_start < it <= normal_prop_until:
        out["opacity"] = 0.0 if event else 0.05
    return out


def adam_state(pool: dict, step: int) -> dict:
    zeros = {k: torch.zeros_like(v) for k, v in pool.items()}
    return dict(m=zeros, v={k: torch.zeros_like(v) for k, v in pool.items()},
                step=step)


def adam(pool: dict, grads: dict, st: dict, lr: dict):
    """One step -> (new pool, new state)."""
    n = st["step"] + 1
    c1, c2 = 1 - 0.9 ** n, 1 - 0.999 ** n
    new, m, v = {}, {}, {}
    for k, p in pool.items():
        g = grads[k]
        live = g != 0
        m[k] = torch.where(live, 0.9 * st["m"][k] + 0.1 * g, st["m"][k])
        v[k] = torch.where(live, 0.999 * st["v"][k] + 0.001 * g * g,
                           st["v"][k])
        step = lr[k] * (m[k] / c1) / (torch.sqrt(v[k] / c2) + 1e-15)
        new[k] = torch.where(live, p - step, p)
    return new, dict(m=m, v=v, step=n)

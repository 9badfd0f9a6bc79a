"""Sparse-update Adam and the per-parameter learning-rate schedules (port
of envgs_tpu/train/optimizer.py for the static surfel pools).

`sparse_adam_update` skips every element whose gradient is exactly zero:
untouched surfels keep their moments and do not decay, the semantics
adaptive density control relies on. Learning rates follow the per-name
table, the log-linear xyz decay and the 3DGS-DR opacity pulse. The
schedules are computed in float32, as the JAX package computes them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from envgs_tpu_torch.models.gaussians import GaussianParams


class AdamState(NamedTuple):
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor  # () int32


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(GaussianParams(*map(torch.zeros_like, params)),
                     GaussianParams(*map(torch.zeros_like, params)),
                     torch.zeros((), dtype=torch.int32,
                                 device=params.xyz.device))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def sparse_adam_update(params, grads, state: AdamState, lr_tree,
                       b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-15):
    """One masked Adam step over matching NamedTuples of tensors; lr_tree
    holds a python float per field. -> (new params, new AdamState)."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - _f32(b1).to(stepf.device) ** stepf
    c2 = 1.0 - _f32(b2).to(stepf.device) ** stepf
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lr_tree):
        live = g != 0.0
        m_new = torch.where(live, b1 * m + (1 - b1) * g, m)
        v_new = torch.where(live, b2 * v + (1 - b2) * g * g, v)
        denom = torch.sqrt(v_new / c2) + eps
        new_p.append(torch.where(live, p - lr * (m_new / c1) / denom, p))
        new_m.append(m_new)
        new_v.append(v_new)
    cls = type(params)
    return cls(*new_p), AdamState(cls(*new_m), cls(*new_v), step)


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=30000) -> float:
    """Log-linear LR interpolation with an optional warm-up delay; a zero
    endpoint freezes the parameter."""
    if lr_init <= 0.0 or lr_final <= 0.0:
        return 0.0
    step = _f32(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(_f32(lr_init)) * (1 - t)
                         + torch.log(_f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay = 1.0
    return float(delay * log_lerp)


class LRConfig(NamedTuple):
    """Per-field LRs (envgs.yaml optimizer_cfg defaults; the JAX package's
    fields without the temporal ones, which the static pools lack)."""

    xyz: float = 0.00016
    features_dc: float = 0.0025
    features_rest: float = 0.000125
    opacity: float = 0.05
    scaling: float = 0.005
    rotation: float = 0.001
    specular: float = 0.01
    roughness: float = 0.05
    # xyz schedule
    xyz_lr_init: float = 0.00016
    xyz_lr_final: float = 0.0000016
    xyz_lr_delay_mult: float = 0.01
    xyz_lr_max_steps: int = 30000
    spatial_scale: float = 1.0
    # opacity pulse trick
    opacity_pulse_lr: float = 0.05
    opacity_pulse_interval: int = 200
    normal_prop_interval: int = 1000
    opacity_reset_interval: int = 3000
    reflection_start_iter: int = 3000
    normal_prop_until_iter: int = 18000
    use_opacity_pulse: bool = True


def lr_tree_for(it, cfg: LRConfig) -> GaussianParams:
    """Scalar LR (python float, float32-exact) per GaussianParams field at
    iteration `it`. Opacity: within (reflection_start, normal_prop_until]
    the pulse LR, except 0 for the pulse interval after each
    normal-propagation event that is not an opacity reset."""
    itf = _f32(it)
    xyz_lr = expon_lr(itf, cfg.xyz_lr_init * cfg.spatial_scale,
                      cfg.xyz_lr_final * cfg.spatial_scale,
                      lr_delay_mult=cfg.xyz_lr_delay_mult,
                      max_steps=cfg.xyz_lr_max_steps)
    opac_lr = cfg.opacity
    if cfg.use_opacity_pulse:
        last = float(torch.floor(itf / cfg.opacity_pulse_interval)
                     * cfg.opacity_pulse_interval)
        is_prop_evt = (last % cfg.normal_prop_interval == 0
                       and last % cfg.opacity_reset_interval != 0
                       and last != cfg.normal_prop_until_iter
                       and last > cfg.reflection_start_iter)
        if cfg.reflection_start_iter < float(itf) <= cfg.normal_prop_until_iter:
            opac_lr = 0.0 if is_prop_evt else cfg.opacity_pulse_lr
    f32 = lambda v: float(_f32(v))  # noqa: E731  the JAX package's f32 LRs
    return GaussianParams(
        xyz=xyz_lr, features_dc=f32(cfg.features_dc),
        features_rest=f32(cfg.features_rest), scaling=f32(cfg.scaling),
        rotation=f32(cfg.rotation), opacity=f32(opac_lr),
        specular=f32(cfg.specular), roughness=f32(cfg.roughness))

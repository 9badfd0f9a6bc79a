"""Reference 2D-surfel ray tracer in plain PyTorch, exact and slow (port of
envgs_tpu/ops/tracer_ref.py): the containers, `prepare_trace_scene`, and
`trace_rays_reference`, the oracle the `ref` tracer backend runs.

Per ray: the exact ray / splat-plane hit of every splat, the hits sorted by
their ray parameter t, front-to-back alpha blending with the blend
constants of `ops/common.py`. Rays follow the tracer's convention: the
direction need not be normalized (z-depth scaling for camera rays) and the
blended depth is the ray parameter t, so o + t*d is the hit point.
Differentiable by autograd; O(P log P) per ray, for small scenes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_CUTOFF
from envgs_tpu_torch.utils.transforms import quat_to_rotmat

# elements of one (rays, P) plane of the reference tracer: 4M (16 MB in
# f32); it holds a few dozen such planes at once
_REF_BLOCK_ELEMS = 1 << 22


class TraceOutput(NamedTuple):
    rgb: torch.Tensor  # (..., 3) includes bg
    dpt: torch.Tensor  # (...,) normalized expected ray parameter
    acc: torch.Tensor  # (...,)
    norm: torch.Tensor  # (..., 3) world space, unnormalized
    dist: torch.Tensor  # (...,)
    aux: torch.Tensor  # (..., A) extra blended channels
    wet: torch.Tensor  # (P,)
    trans: torch.Tensor  # (...,) final transmittance
    dropped_pairs: torch.Tensor | None = None  # () candidate slots dropped
    #   by the total_pair_cap tile clamp (0 = no truncation; None on the
    #   reference tracer)
    # distortion moments sum w m, sum w m^2: filled only by
    # trace_rays(compose_raw=True)
    d1: torch.Tensor | None = None  # (...,)
    d2: torch.Tensor | None = None  # (...,)
    num_pairs: torch.Tensor | None = None  # () chunk-aligned slots used
    cut_chunks: torch.Tensor | None = None  # () chunks the per-tile cap
    #   cut, summed over the tiles (0 = no tile lost a candidate to it;
    #   None on the reference tracer)


class TraceScene(NamedTuple):
    """Per-splat world-space data prepared once per (frame, gaussian set)."""

    mean: torch.Tensor  # (P, 3)
    t_u: torch.Tensor  # (P, 3) tangent / scale_u
    t_v: torch.Tensor  # (P, 3)
    normal: torch.Tensor  # (P, 3) unit
    opacity: torch.Tensor  # (P,)
    color: torch.Tensor  # (P, 3)
    aux: torch.Tensor  # (P, A)
    valid: torch.Tensor  # (P,) bool


def prepare_trace_scene(
    means3d, quats, scales, opacities, colors, aux=None, active=None,
    scale_modifier: float = 1.0,
) -> TraceScene:
    P = means3d.shape[0]
    R = quat_to_rotmat(quats)
    su = scales[:, 0] * scale_modifier
    sv = scales[:, 1] * scale_modifier
    valid = (torch.ones(P, dtype=torch.bool, device=means3d.device)
             if active is None else active)
    if aux is None:
        aux = means3d.new_zeros((P, 0))
    return TraceScene(
        mean=means3d,
        t_u=R[..., :, 0] / torch.clamp(su[:, None], min=1e-12),
        t_v=R[..., :, 1] / torch.clamp(sv[:, None], min=1e-12),
        normal=R[..., :, 2],
        opacity=opacities * valid,
        color=colors,
        aux=aux,
        valid=valid,
    )


def _ray_hits(scene: TraceScene, o: torch.Tensor, d: torch.Tensor,
              t_min: float):
    """Every splat's hit on each of the rays o, d (R, 3): (t, alpha, flip),
    each (R, P); alpha zero where the hit fails the floor, t_min or the
    grazing test, flip the sign that turns the normal against the ray."""
    o, d = o[:, None, :], d[:, None, :]
    dn = torch.sum(d * scene.normal, -1)  # (R, P)
    dn_safe = torch.where(torch.abs(dn) < 1e-9, 1e-9, dn)
    t = torch.sum((scene.mean - o) * scene.normal, -1) / dn_safe
    delta = o + t[..., None] * d - scene.mean
    u = torch.sum(delta * scene.t_u, -1)
    v = torch.sum(delta * scene.t_v, -1)
    alpha = torch.clamp(scene.opacity * torch.exp(-0.5 * (u * u + v * v)),
                        max=ALPHA_MAX)
    ok = (alpha >= ALPHA_MIN) & (t > t_min) & (torch.abs(dn) >= 1e-9)
    alpha = torch.where(ok, alpha, 0.0)
    flip = torch.where(dn > 0, -1.0, 1.0)
    return t, alpha, flip


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running sum along the last axis."""
    return torch.nn.functional.pad(torch.cumsum(x, -1), (1, 0))[..., :-1]


def trace_rays_reference(
    scene: TraceScene,
    ray_o: torch.Tensor,  # (..., 3)
    ray_d: torch.Tensor,  # (..., 3), not normalized
    bg_color: torch.Tensor,  # (3,)
    t_min: float = 1e-4,
) -> TraceOutput:
    """Trace every ray against every splat in its own depth order. The
    transmittance before a hit is the product of (1 - alpha) over all the
    ray's earlier hits; a hit contributes iff T (1 - alpha) >= 1e-4.
    Per-splat wet is the contributing weight summed over the rays. Rays go
    through in blocks of at most _REF_BLOCK_ELEMS // P."""
    P = scene.mean.shape[0]
    A = scene.aux.shape[-1]
    shape = ray_o.shape[:-1]
    o_all = ray_o.reshape(-1, 3)
    d_all = ray_d.reshape(-1, 3)
    B = max(1, _REF_BLOCK_ELEMS // max(P, 1))
    parts = []
    wet = scene.mean.new_zeros(P)
    for r0 in range(0, o_all.shape[0], B):
        t, alpha, flip = _ray_hits(scene, o_all[r0:r0 + B],
                                   d_all[r0:r0 + B], t_min)
        order = torch.argsort(torch.where(alpha > 0, t, float("inf")),
                              dim=-1, stable=True)
        a_s = torch.gather(alpha, 1, order)
        t_s = torch.gather(t, 1, order)
        m_s = t_s / (1.0 + torch.abs(t_s))  # the bounded distortion mapping
        log_om = torch.log1p(-a_s)
        Ttil = torch.exp(_excl(log_om))
        contrib = (a_s > 0) & (Ttil * (1.0 - a_s) >= T_CUTOFF)
        w = torch.where(contrib, a_s * Ttil, 0.0)  # (R, P) in ray order
        wp = torch.zeros_like(w).scatter(1, order, w)  # in pool order
        n_f = flip[..., None] * scene.normal  # (R, P, 3)
        acc = w.sum(-1)
        rgb = wp @ scene.color
        dptw = torch.sum(w * t_s, -1)
        nrm = torch.sum(wp[..., None] * n_f, 1)
        aux = wp @ scene.aux
        dist = torch.sum(w * (m_s * m_s * _excl(w) + _excl(w * m_s * m_s)
                              - 2 * m_s * _excl(w * m_s)), -1)
        T_fin = torch.exp(torch.sum(torch.where(contrib, log_om, 0.0), -1))
        wet = wet + wp.sum(0)
        parts.append((rgb, dptw, acc, nrm, dist, aux, T_fin))
    rgb, dptw, acc, nrm, dist, aux, T_fin = (torch.cat(x) for x in
                                             zip(*parts))
    rgb = rgb + T_fin[:, None] * bg_color[None, :]
    dpt = torch.where(acc > 1e-8, dptw / torch.clamp(acc, min=1e-8), 0.0)
    return TraceOutput(
        rgb=rgb.reshape(*shape, 3),
        dpt=dpt.reshape(shape),
        acc=acc.reshape(shape),
        norm=nrm.reshape(*shape, 3),
        dist=dist.reshape(shape),
        aux=aux.reshape(*shape, A),
        wet=wet,
        trans=T_fin.reshape(shape),
    )

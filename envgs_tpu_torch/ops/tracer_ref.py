"""Surfel tracer containers and scene preparation (port of the types and
`prepare_trace_scene` of envgs_tpu/ops/tracer_ref.py; the exact O(P) per
ray reference tracer is not ported — the JAX package's stays the
oracle)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.utils.transforms import quat_to_rotmat


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
    #   by the total_pair_cap tile clamp (0 = no truncation)
    num_pairs: torch.Tensor | None = None  # () chunk-aligned slots used


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

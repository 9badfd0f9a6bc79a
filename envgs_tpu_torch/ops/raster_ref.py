"""Raw rasterizer output type (port of the container of
envgs_tpu/ops/raster_ref.py; the O(P*HW) reference rasterizer itself is
not ported — the JAX package's stays the oracle)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RasterOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, C) includes the bg blend
    depth_expected: torch.Tensor  # (H, W) premultiplied by alpha
    alpha: torch.Tensor  # (H, W)
    normal: torch.Tensor  # (H, W, 3) view space, unnormalized
    depth_median: torch.Tensor  # (H, W) zeros on the render path
    distortion: torch.Tensor  # (H, W) zeros on the render path
    wet: torch.Tensor  # (P,) zeros on the render path
    radii: torch.Tensor  # (P,) screen radii (0 = culled)
    trans: torch.Tensor  # (H, W) final transmittance
    num_pairs: torch.Tensor | None = None  # () requested (splat, tile) pairs
    #   before the pair_cap clamp (num_pairs > pair_cap: far splats dropped)

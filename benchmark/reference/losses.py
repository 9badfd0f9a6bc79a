"""The training losses of the benchmark's cells in plain PyTorch, from
their definitions: SSIM (Wang et al. 2004: an 11-tap Gaussian window of
sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, the mean over the windows that lie
inside the image) and EnvGS's normal losses.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.geometry import unit


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images in [0, 1]."""
    g = torch.exp(-(torch.arange(11, dtype=torch.float32, device=x.device)
                    - 5.0) ** 2 / (2 * 1.5 ** 2))
    g = g / g.sum()
    k = (g[:, None] * g[None, :]).expand(3, 1, 11, 11)

    def blur(a):
        return F.conv2d(a.permute(2, 0, 1)[None], k, groups=3)

    mx, my = blur(x), blur(y)
    vx, vy = blur(x * x) - mx * mx, blur(y * y) - my * my
    cxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * cxy + c2))
            / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean()


def quantile_low(d: torch.Tensor, p: float) -> torch.Tensor:
    """The smallest value of d whose share of values at or below it
    reaches p."""
    s = torch.sort(d.reshape(-1)).values
    return s[max(math.ceil(p * s.numel()) - 1, 0)]


def depth_weight(depth: torch.Tensor) -> torch.Tensor:
    """EnvGS's depth weighting of the normal losses: 1 at the 1% depth
    quantile falling to 0 at the 99% one, clamped (no gradient)."""
    d = depth.detach()
    near, far = quantile_low(d, 0.01), quantile_low(d, 0.99)
    span = torch.where(far == near, torch.ones_like(far), far - near)
    return torch.clamp(1.0 - (d - near) / span, 0.0, 1.0)


def normal_consistency(normal, surf_normal, depth) -> torch.Tensor:
    """2DGS's normal consistency: 1 - <rendered normal, the depth map's
    normal>, depth-weighted."""
    return ((1.0 - (normal * surf_normal).sum(-1)) * depth_weight(depth)
            ).mean()


def normal_prior(normal, prior, R, depth) -> torch.Tensor:
    """The monocular prior's loss: L1 plus 1 - cosine between the rendered
    normal in view space and the prior (a [0, 1] encoding of one),
    depth-weighted."""
    n = unit(unit(normal) @ R.T)
    g = unit(prior * 2.0 - 1.0)
    cos = (unit(n) * unit(g)).sum(-1)
    return (((n - g).abs().sum(-1) + 1.0 - cos) * depth_weight(depth)).mean()

"""Coordinate embedders (port of envgs_tpu/models/embedders.py, the part
the PointPlanes family uses): `KPlanesEmbedder`, the K-Planes factored
spatio-temporal grid. One 2D feature plane per coordinate pair — (xy, xz,
yz), plus (xt, yt, zt) when `n_frames` > 1 — bilinearly interpolated and
multiplied across planes (the Hadamard combination), the multiscale levels
concatenated.

The planes are parameters of the module, under the JAX package's keys
(`l<level>_s<a><b>`, `l<level>_t<a>`) and in its (R0, R1, F) layout, so
weights cross between the packages by name.
"""
from __future__ import annotations

import torch
from torch import nn

SPATIAL_PAIRS = ((0, 1), (0, 2), (1, 2))


class KPlanesEmbedder(nn.Module):
    """x (..., 3) in `bounds`, t in [0, 1] -> (..., out_dim) features.

    Planes start at 1 + 0.1 N(0, 1) (drawn from `generator`; not the JAX
    package's draws) so that the product starts informative."""

    def __init__(self, n_features: int = 8, resolutions: tuple = (64, 128),
                 time_resolution: int = 25, n_frames: int = 1,
                 bounds: tuple = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_features = n_features
        self.resolutions = tuple(resolutions)
        self.time_resolution = time_resolution
        self.n_frames = n_frames
        self.bounds = bounds
        planes = {}
        for li, res in enumerate(self.resolutions):
            shapes = [(f"l{li}_s{a}{b}", (res, res)) for a, b in SPATIAL_PAIRS]
            if n_frames > 1:
                shapes += [(f"l{li}_t{a}", (res, time_resolution))
                           for a in range(3)]
            for name, (r0, r1) in shapes:
                planes[name] = nn.Parameter(1.0 + 0.1 * torch.randn(
                    (r0, r1, n_features), generator=generator,
                    device=device))
        self.planes = nn.ParameterDict(planes)

    @property
    def out_dim(self) -> int:
        return len(self.resolutions) * self.n_features

    @staticmethod
    def _interp2(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """plane (R0, R1, F); u / v (...,) in [0, 1] -> (..., F) bilinear."""
        R0, R1 = plane.shape[:2]
        x = u * (R0 - 1)
        y = v * (R1 - 1)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, R0 - 2)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, R1 - 2)
        wx = (x - x0)[..., None]
        wy = (y - y0)[..., None]
        return (plane[x0, y0] * (1 - wx) * (1 - wy)
                + plane[x0 + 1, y0] * wx * (1 - wy)
                + plane[x0, y0 + 1] * (1 - wx) * wy
                + plane[x0 + 1, y0 + 1] * wx * wy)

    def forward(self, x: torch.Tensor, t=0.0) -> torch.Tensor:
        """x (..., 3); t a scalar or (...,) in [0, 1] -> (..., out_dim)."""
        lo = torch.tensor(self.bounds[0], dtype=torch.float32,
                          device=x.device)
        hi = torch.tensor(self.bounds[1], dtype=torch.float32,
                          device=x.device)
        u = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
        t = torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32,
                                               device=x.device), x.shape[:-1])
        outs = []
        for li in range(len(self.resolutions)):
            f = torch.ones((*x.shape[:-1], self.n_features), device=x.device)
            for a, b in SPATIAL_PAIRS:
                f = f * self._interp2(self.planes[f"l{li}_s{a}{b}"],
                                      u[..., a], u[..., b])
            if self.n_frames > 1:
                for a in range(3):
                    f = f * self._interp2(self.planes[f"l{li}_t{a}"],
                                          u[..., a], t)
            outs.append(f)
        return torch.cat(outs, dim=-1)

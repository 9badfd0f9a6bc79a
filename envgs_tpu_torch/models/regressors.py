"""Output regressors (port of envgs_tpu/models/regressors.py, the part the
PointPlanes family uses): `MLP`, the MlpRegressor.

The weights keep the JAX package's layout: layer i computes h @ w_i + b_i
with w_i of shape (din, dout), so a JAX parameter list [(w, b), ...]
crosses by `load_jax` / `jax_params`.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    """`depth` hidden ReLU layers of `width`, a linear head of `out_dim`
    with an optional activation (none | sigmoid | relu | softplus | tanh),
    the input concatenated again before the layers in `skips` (as the JAX
    package: the widths of those layers include it, and layer 0 never
    takes it). Hidden weights start at N(0, 2 / din), the head's at
    N(0, 1 / d), biases at 0 (drawn from `generator`; not the JAX
    package's draws)."""

    def __init__(self, in_dim: int, width: int = 256, depth: int = 8,
                 out_dim: int = 4, skips: tuple = (4,),
                 out_actvn: str = "none",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.in_dim, self.width, self.depth = in_dim, width, depth
        self.out_dim, self.skips = out_dim, tuple(skips)
        self.out_actvn = out_actvn
        ws, bs = [], []
        d = in_dim
        for i in range(depth + 1):
            head = i == depth
            din = d + (in_dim if i in self.skips and not head else 0)
            dout = out_dim if head else width
            scale = math.sqrt((1.0 if head else 2.0) / din)
            ws.append(nn.Parameter(torch.randn(
                (din, dout), generator=generator, device=device) * scale))
            bs.append(nn.Parameter(torch.zeros(dout, device=device)))
            d = width
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            if i in self.skips and i > 0:
                h = torch.cat([h, x], dim=-1)
            h = torch.relu(h @ self.weights[i] + self.biases[i])
        out = h @ self.weights[self.depth] + self.biases[self.depth]
        if self.out_actvn == "sigmoid":
            out = torch.sigmoid(out)
        elif self.out_actvn == "relu":
            out = torch.relu(out)
        elif self.out_actvn == "softplus":
            out = nn.functional.softplus(out)
        elif self.out_actvn == "tanh":
            out = torch.tanh(out)
        return out

    def jax_params(self) -> list:
        """[(w, b), ...] of the layers: the JAX package's parameter list
        (the module's own tensors)."""
        return list(zip(self.weights, self.biases))

    @torch.no_grad()
    def load_jax(self, params: list):
        """Copy a JAX parameter list [(w, b), ...] (arrays or tensors) into
        the layers."""
        for (w, b), tw, tb in zip(params, self.weights, self.biases):
            tw.copy_(torch.as_tensor(w, dtype=torch.float32))
            tb.copy_(torch.as_tensor(b, dtype=torch.float32))

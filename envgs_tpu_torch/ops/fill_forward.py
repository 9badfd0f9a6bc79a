"""Multi-channel fill-forward ("last marker wins"): the plain PyTorch
version and the wrapper of its CUDA kernel K5 (port of
envgs_tpu/ops/fill_forward.py).

Given value channels `vals` (C, N) int32 and markers `valid` (N,), every
position takes the channel values of the last marker at or before it;
positions before the first marker get 0. The chunk-aligned training layout
of ops/binning.py broadcasts each tile's (source start, aligned start,
source end) over its aligned slots with it.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels


def fill_forward_torch(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version: the running max of the marker positions, then one
    gather of every channel."""
    N = vals.shape[1]
    pos = torch.arange(N, device=vals.device)
    last = torch.cummax(torch.where(valid.bool(), pos, -1), 0).values
    got = vals[:, torch.clamp(last, min=0)]
    return torch.where(last >= 0, got, 0).to(torch.int32)


def fill_forward(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """vals (C, N) int32, valid (N,) bool/int -> (C, N) int32: kernel K5 on
    a CUDA tensor, the plain version on a CPU tensor."""
    if vals.device.type == "cpu":
        return fill_forward_torch(vals, valid)
    return kernels.fill_forward(vals.to(torch.int32).contiguous(),
                                valid.to(torch.int32).contiguous())

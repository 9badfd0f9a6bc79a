"""Segmented row sum and the exact permutation helpers (port of the parts
of envgs_tpu/ops/segsum.py that a kernel or plain indexing carries).

`segmented_inclusive_sum(rows, seg_start)` is the scan of the JAX package's
scatter-free transpose of the pair gather: out[i] = rows[i] + (seg_start[i]
? 0 : out[i-1]) per lane, a zero carry before row 0. On CUDA tensors it is
kernel K6 (kernels/csrc/segscan.cu), on CPU tensors the plain version.

Left behind: `gather_rows` (the custom-VJP gather), `gather_transpose`,
`contiguous_run_sums` and `presort_transpose`. They exist because a
duplicate-index scatter-add serializes on the TPU; the port's blend
backward kernels add each pair's gradient into its splat's row with
atomics, so no path of the port transposes a gather.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels

SROWS = kernels.SEG_ROWS  # rows per block of the scan; N must be a multiple
SLANES = kernels.SEG_LANES


def segmented_inclusive_sum_torch(rows: torch.Tensor,
                                  seg_start: torch.Tensor) -> torch.Tensor:
    """Plain version: the float64 running sum down the rows minus its value
    just before each row's segment start, cast to float32. (Rounds once per
    element, so it stands for the sequential float32 sum to within that
    sum's own rounding; a non-finite row reaches every row after it.)"""
    N = rows.shape[0]
    cs = torch.cumsum(rows.to(torch.float64), dim=0)
    pos = torch.arange(N, device=rows.device)
    start = torch.cummax(torch.where(seg_start != 0, pos, -1), 0).values
    before = torch.where((start > 0)[:, None],
                         cs[torch.clamp(start - 1, min=0)], 0.0)
    return (cs - before).to(torch.float32)


def segmented_inclusive_sum(rows: torch.Tensor,
                            seg_start: torch.Tensor) -> torch.Tensor:
    """rows (N, 128) f32, seg_start (N,) int32 -> inclusive segmented sums:
    kernel K6 on a CUDA tensor, the plain version on a CPU tensor."""
    N = rows.shape[0]
    assert N % SROWS == 0 and rows.shape[1] == SLANES
    if rows.device.type == "cpu":
        return segmented_inclusive_sum_torch(rows, seg_start)
    return kernels.segscan(rows.contiguous(),
                           seg_start.to(torch.int32).contiguous())


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv_perm: torch.Tensor) -> torch.Tensor:
    """`x[perm]` for a permutation `perm`. (The JAX package passes the
    inverse to write the transpose as a gather; autograd's index backward
    needs no such help, the argument keeps the signature.)"""
    del inv_perm
    return x[perm]


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation: a unique-index scatter of arange, int32."""
    n = perm.shape[0]
    inv = torch.empty(n, dtype=torch.int32, device=perm.device)
    inv[perm.to(torch.int64)] = torch.arange(n, dtype=torch.int32,
                                             device=perm.device)
    return inv

"""Row gathers of 128-column tables (port of the two gather kernels of
scripts/tpu_micro_dmagather.py): out[j, :] = table[idx[j], :].

`gather_rows` is P1 (one vector per thread, a row per warp or half-warp),
`gather_rows_win8` P2 (the aligned 8-row window of each index staged in
shared memory, the row idx % 8 picked after the copy); both are
kernels/csrc/gather_rows.cu on CUDA tensors and their plain versions on
CPU tensors, and both return exactly `table[idx]`. They are a probe of the
staging pattern of the blend kernels (`packed[gauss_idx]`), driven by
`python -m envgs_tpu_torch.probes.dmagather`; no path of the system calls
them.
"""
from __future__ import annotations

import torch

from envgs_tpu_torch import kernels

WIN = 8  # rows of an aligned window


def gather_rows_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1."""
    return table[idx.to(torch.int64)]


def gather_rows_win8_torch(table: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P2: index the window, then the row inside it."""
    i = idx.to(torch.int64)
    return table.view(-1, WIN, table.shape[1])[i // WIN, i % WIN]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (S, 128) f32/bf16, idx (n,) int32 in [0, S) -> (n, 128):
    kernel P1 on a CUDA tensor, the plain version on a CPU tensor."""
    if table.device.type == "cpu":
        return gather_rows_torch(table, idx)
    return kernels.gather_rows(table, idx)


def gather_rows_win8(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """As gather_rows, through 8-row windows (S a multiple of 8): kernel P2
    on a CUDA tensor, the plain version on a CPU tensor."""
    if table.device.type == "cpu":
        return gather_rows_win8_torch(table, idx)
    return kernels.gather_rows_win8(table, idx)

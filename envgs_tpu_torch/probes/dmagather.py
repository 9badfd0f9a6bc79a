"""Probe: the hand-written row gathers against PyTorch's indexing, on one
CUDA card (port of scripts/tpu_micro_dmagather.py).

    python -m envgs_tpu_torch.probes.dmagather

At the JAX script's sizes (a 500 000-row table, 2^21 indices from
`default_rng(0)`) it times `table[idx]`, P1 (`gather_rows`) and P2
(`gather_rows_win8`) on a bf16 table and `table[idx]` and P1 on an f32
table, prints ms and ns per row of each with the bytes each must move
(`least_bytes`), and checks that every kernel's output is bit-equal to
`table[idx]`. The first
line is the card's name and power limit. Needs a CUDA card; without one it
raises instead of timing the CPU.
"""
from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from envgs_tpu_torch.ops.gather import gather_rows, gather_rows_win8

S = 500_000
CAP = 2 ** 21


def probe_inputs(device, S: int = S, cap: int = CAP):
    """(bf16 table (S, 128), f32 table, idx (cap,) int32) from
    `default_rng(0)`, the indices drawn first as the JAX script draws them."""
    rng = np.random.default_rng(0)
    idx = torch.tensor(rng.integers(0, S, cap).astype(np.int32), device=device)
    t32 = torch.tensor(rng.standard_normal((S, 128)).astype(np.float32),
                       device=device)
    return t32.to(torch.bfloat16), t32, idx


def cuda_ms(fn, n: int = 10) -> float:
    """Median device ms of fn over n runs after one warm-up (CUDA events)."""
    fn()
    pairs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def least_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """The bytes a gather of table[idx] must move, each input byte read
    once and each output byte written once: the distinct rows that idx
    names, the indices, and the output rows. (idx repeats rows; a kernel
    reads a repeated row again, from L2 at best, so the traffic it causes
    is larger: one row read per output row.)"""
    row = table.shape[1] * table.element_size()
    touched = int(torch.unique(idx).numel())
    return (touched * row + idx.numel() * idx.element_size()
            + idx.numel() * row)


def variants(tbf16, t32, idx):
    """[(name, function, table)] in the JAX script's order."""
    long_idx = idx.to(torch.int64)
    return [
        ("table[idx] bf16", lambda: tbf16[long_idx], tbf16),
        ("gather_rows bf16", lambda: gather_rows(tbf16, idx), tbf16),
        ("gather_rows_win8 bf16", lambda: gather_rows_win8(tbf16, idx), tbf16),
        ("table[idx] f32", lambda: t32[long_idx], t32),
        ("gather_rows f32", lambda: gather_rows(t32, idx), t32),
    ]


def main(device: str = "cuda", n: int = 10) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    tbf16, t32, idx = probe_inputs(device)
    out = {}
    for name, fn, table in variants(tbf16, t32, idx):
        if not torch.equal(fn(), table[idx.to(torch.int64)]):
            raise AssertionError(f"{name}: differs from table[idx]")
        ms = cuda_ms(fn, n)
        least = least_bytes(table, idx)
        row = 128 * table.element_size()
        traffic = 2 * idx.numel() * row + idx.numel() * 4
        out[name] = ms
        print(f"{name}: {ms:.4f} ms ({ms / idx.numel() * 1e6:.3f} ns/row), "
              f"bit-equal to table[idx]; must move {least / 2 ** 30:.3f} GiB "
              f"(distinct rows, indices, output: {least / ms / 1e9:.2f} TB/s "
              f"of device memory at least); one row read per output row is "
              f"{traffic / 2 ** 30:.3f} GiB = {traffic / ms / 1e9:.2f} TB/s "
              "through L2 and device memory together", flush=True)
    return out


if __name__ == "__main__":
    main()

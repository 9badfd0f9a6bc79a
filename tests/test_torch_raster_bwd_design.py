"""The index algebra of kernel K2's design, on the CPU.

K2 sums each pair's gradient row over a warp's 32 pixels by transposition:
in halving steps lanes swap the half of their remaining slots that the
partner keeps, after which lane k holds the warp's sum of slot k. The
kernel itself runs only on a card, where it is held against the plain
backward. These cases guard the design's model, not the kernel's code:
`transpose_reduce_model` below is the same steps written in PyTorch, held
against plain sums, so a wrong shuffle or select in the `.cu` passes them.
What does tie to the source: the slot-to-column map of the packed gauss3d
row (`gauss3d_slot_columns`) is held against the columns the plain
backward writes and against `gauss3d_column` as parsed from the `.cu`.

    python -m pytest tests/test_torch_raster_bwd_design.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from envgs_tpu_torch.ops.raster_blend import (
    CHUNK,
    LO,
    WET_COL,
    blend_tiles_bwd_torch,
    blend_tiles_torch,
    gauss3d_slot_columns,
)

K2_SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "envgs_tpu_torch"
             / "kernels" / "csrc" / "raster_blend_bwd.cu")


def transpose_reduce_model(v: torch.Tensor) -> torch.Tensor:
    """Model of kernel K2's warp reduction by transposition: v (32 lanes, N slots), N = 32 (the surfel row) or 16 (the packed gauss3d
    row) -> (32,), what each lane holds in slot 0 afterwards: lane k the sum
    over all lanes of slot k % N. In each halving step h = N/2 .. 1, lane l
    and its partner l ^ h split their 2h remaining slots: the lane with bit
    h set keeps the upper h, the other the lower h, each adding what the
    partner hands over; N = 16 ends with one fold across lane bit 16."""
    lanes = torch.arange(32)
    n = v.shape[1]
    if v.shape[0] != 32 or n not in (16, 32):
        raise ValueError(f"v: expected (32, 16 or 32), got {tuple(v.shape)}")
    h = n // 2
    while h >= 1:
        up = ((lanes & h) != 0)[:, None]
        lo, hi = v[:, :h], v[:, h:2 * h]
        send = torch.where(up, lo, hi)
        keep = torch.where(up, hi, lo)
        v = keep + send[lanes ^ h]  # __shfl_xor_sync(send, h)
        h //= 2
    out = v[:, 0]
    if n < 32:
        out = out + out[lanes ^ n]
    return out


def _expected(v):
    n = v.shape[1]
    return v.sum(0)[torch.arange(32) % n]


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transposing_reduction_leaves_column_k_on_lane_k(n, seed):
    """Integer-valued floats: every partial sum is exact, so the model must
    equal the column sums to the bit whatever the order."""
    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.integers(-50, 50, (32, n)).astype(np.float32))
    assert torch.equal(transpose_reduce_model(v), _expected(v))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("lane", [0, 1, 7, 16, 31])
def test_transposing_reduction_with_one_live_lane(n, lane):
    """All lanes but one hold zeros (a splat that meets one pixel of the
    warp): lane k must end up with that lane's slot k, exactly."""
    rng = np.random.default_rng(lane)
    v = torch.zeros(32, n)
    v[lane] = torch.tensor(rng.standard_normal(n).astype(np.float32))
    assert torch.equal(transpose_reduce_model(v), v[lane][torch.arange(32) % n])


@pytest.mark.parametrize("n", [16, 32])
def test_transposing_reduction_on_random_floats(n):
    """Random floats: the sums agree with a float64 sum to float32 rounding
    of 32 terms."""
    rng = np.random.default_rng(5)
    v = torch.tensor(rng.standard_normal((32, n)).astype(np.float32))
    want = _expected(v.double())
    got = transpose_reduce_model(v).double()
    assert float((got - want).abs().max()) <= 32 * 2.0 ** -24 * float(
        v.abs().sum(0).max())


def test_transposing_reduction_rejects_other_widths():
    with pytest.raises(ValueError, match="expected"):
        transpose_reduce_model(torch.zeros(32, 24))
    with pytest.raises(ValueError, match="expected"):
        transpose_reduce_model(torch.zeros(16, 16))


@pytest.mark.parametrize("C", [1, 3, 7])
def test_gauss3d_slots_fit_the_packed_row_and_cover_the_plain_columns(C):
    """The 16-slot row holds every column the plain gauss3d backward writes
    (and the wet in its last slot), each once; checked on one tile of 64
    overlapping Gaussians with a random cotangent."""
    cols = gauss3d_slot_columns(C)
    assert len(cols) == len(set(cols)) <= 15 and WET_COL not in cols
    rng = np.random.default_rng(C)
    P = CHUNK
    packed = torch.zeros(P + 1, LO)
    packed[:P, 0] = packed[:P, 2] = torch.tensor(
        rng.uniform(0.02, 0.2, P).astype(np.float32))
    packed[:P, 3] = torch.tensor(rng.uniform(1, 3, P).astype(np.float32))
    packed[:P, 9:11] = torch.tensor(rng.uniform(2, 14, (P, 2))
                                    .astype(np.float32))
    packed[:P, 11] = 0.3
    packed[:P, 15:15 + C] = torch.tensor(rng.random((P, C))
                                         .astype(np.float32))
    idx = torch.arange(P, dtype=torch.int32)
    bounds = torch.tensor([0, P], dtype=torch.int32)
    out = blend_tiles_torch(packed, idx, bounds, C, 1, 1,
                            needs=(True, True, False), mode="gauss3d")
    g_out = torch.tensor(rng.standard_normal(tuple(out.shape))
                         .astype(np.float32))
    grad = blend_tiles_bwd_torch(packed, idx, bounds, out, g_out, C, 1, 1,
                                 mode="gauss3d")
    live = {k for k in range(LO) if bool(grad[:, k].any())}
    assert live == set(cols) | {WET_COL}


def _gauss3d_column_of_source():
    """`gauss3d_column(slot)` of the kernel's source as a Python function:
    its body is one chain `slot < a ? slot [+ k] : ... : WET_COL`."""
    text = K2_SOURCE.read_text()
    body = re.search(r"int gauss3d_column\(int slot\)\s*\{\s*return (.*?);",
                     text, re.S).group(1)
    *arms, last = [a.strip() for a in body.split(":")]
    assert last == "WET_COL"
    chain = []
    for arm in arms:
        m = re.fullmatch(r"slot < (\d+) \? slot(?: \+ (\d+))?", arm)
        assert m, arm
        chain.append((int(m.group(1)), int(m.group(2) or 0)))
    lo = int(re.search(r"constexpr int LO = (\d+);", text).group(1))
    assert re.search(r"constexpr int WET_COL = LO - 1;", text)
    wet = lo - 1

    def column(slot):
        for below, add in chain:
            if slot < below:
                return slot + add
        return wet
    return column


@pytest.mark.parametrize("C", [1, 3, 5, 8])
def test_gauss3d_slot_columns_are_the_sources_gauss3d_column(C):
    """The map the tests and the card checks use is the one the kernel
    applies to its lanes: slot by slot, with the wet from slot 15."""
    column = _gauss3d_column_of_source()
    cols = gauss3d_slot_columns(C)
    assert cols == [column(slot) for slot in range(len(cols))]
    assert column(15) == WET_COL

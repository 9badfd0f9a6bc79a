"""The design of kernel K6 (the segmented row sum), on the CPU.

K6 scans each 64-row tile in registers (a warp per row group, each thread
its group's rows in order, the group sums folded in order) and carries the
sum across tiles by a decoupled look-back: a tile publishes its sum at once
(as its inclusive prefix if it holds a segment start, else as its
aggregate), and a tile that needs the carry folds the aggregates after the
nearest published inclusive prefix onto it, in order. The kernel runs only
on a card, where it is held against its plain version. These cases guard
the design's model: it equals the plain version on ragged inputs (a start
at row 0, starts on tile and row-group boundaries, chains of tiles with no
start, every row a start), gives the same bits wherever the look-back stops
(a textbook look-back that sums the aggregates as a tree does not), and
keeps a NaN row inside its segment. What ties the model to the source: the
tile's row groups and rows per group are parsed from `segscan.cu`, and the
selects and folds the model makes are found there as written.

    python -m pytest tests/test_torch_segscan_design.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops.segsum import segmented_inclusive_sum_torch

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "envgs_tpu_torch"
          / "kernels" / "csrc" / "segscan.cu")
TEXT = SOURCE.read_text()
GROUPS = int(re.search(r"constexpr int GROUPS = (\d+);", TEXT).group(1))
RPT = int(re.search(r"constexpr int RPT = (\d+);", TEXT).group(1))
TILE = GROUPS * RPT
# chip_smoke.py's bound for K6 against its plain version
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4


def tile_scan(rows, seg):
    """The kernel's work inside each tile, in its float32 order -> (P, started,
    A, FA): P (nt, TILE, 128) each row's prefix within its tile (from the
    tile's last start at or before it, else from the tile's first row),
    started (nt, TILE) whether such a start exists, A (nt, 128) the tile's
    sum as P gives it at the last row, FA (nt,) whether the tile holds a
    start."""
    nt = rows.shape[0] // TILE
    v = rows.reshape(nt, GROUPS, RPT, -1).clone()
    f = seg.reshape(nt, GROUPS, RPT) != 0
    own = torch.cummax(f.to(torch.int32), dim=2).values.bool()
    for i in range(1, RPT):  # each thread's rows, in order, select on a start
        v[:, :, i] = torch.where(f[:, :, i, None], v[:, :, i],
                                 v[:, :, i - 1] + v[:, :, i])
    G, F = v[:, :, -1].clone(), own[:, :, -1]
    before = torch.zeros((nt, GROUPS), dtype=torch.bool)
    e = G[:, 0]
    for g in range(1, GROUPS):  # the groups before g, folded in order
        if g > 1:
            e = torch.where(F[:, g - 1, None], G[:, g - 1], e + G[:, g - 1])
        before[:, g] = before[:, g - 1] | F[:, g - 1]
        v[:, g] = torch.where(own[:, g, :, None], v[:, g],
                              e[:, None] + v[:, g])
    A = G[:, 0]
    for g in range(1, GROUPS):
        A = torch.where(F[:, g, None], G[:, g], A + G[:, g])
    started = own | before[:, :, None]
    return (v.reshape(nt, TILE, -1), started.reshape(nt, TILE), A,
            F.any(1))


def last_start_before(FA):
    """Per tile k, the nearest tile before it with a start (-1: none): the
    farthest the look-back can go, since that tile publishes its inclusive
    prefix at once."""
    s, out = -1, []
    for k, fa in enumerate(FA.tolist()):
        out.append(s)
        if fa:
            s = k
    return out


def carry_from(j, k, inc, A, taken=()):
    """The carry of tile k when its look-back stops at tile j (-1: before
    tile 0): I_j, then A_{j+1}, ..., A_{k-1} folded in order, except that
    at the tiles in `taken` (their inclusive prefix published while the
    fold ran) I_m is taken as it is. None for the zero carry (no row to
    add)."""
    c = inc[j] if j >= 0 else None
    for m in range(j + 1, k):
        c = inc[m] if m in taken else A[m] if c is None else c + A[m]
    return c


def lookback_model(rows, seg, stop="random", seed=0):
    """Model of K6: the tiles' scans, then each tile's carry from a
    look-back that stops at the tile `stop` picks among those it may find
    inclusive (nearest: tile k - 1; deepest: the last tile with a start,
    or before tile 0; random); the inclusive prefixes are published as the
    kernel publishes them. -> (N, 128) f32."""
    P, started, A, FA = tile_scan(rows, seg)
    rng = np.random.default_rng(seed)
    s_of = last_start_before(FA)
    inc, carries = [], []
    for k in range(P.shape[0]):
        lo = s_of[k]
        j = {"nearest": k - 1, "deepest": lo,
             "random": int(rng.integers(lo, k)) if k else -1}[stop]
        j = max(j, lo)
        c = carry_from(j, k, inc, A)
        carries.append(c)
        inc.append(A[k] if FA[k] or c is None else c + A[k])
    zero = torch.zeros_like(A[0])
    C = torch.stack([zero if c is None else c for c in carries])
    have = torch.tensor([c is not None for c in carries])
    out = torch.where(started[..., None] | ~have[:, None, None], P,
                      C[:, None] + P)
    return out.reshape(rows.shape)


def ragged(kind, n_tiles=48, seed=0):
    """(rows, seg) of N = n_tiles * TILE rows (a multiple of 1024, as the
    wrapper asks) with the segment starts of `kind`."""
    N = n_tiles * TILE
    assert N % kernels.SEG_ROWS == 0
    rng = np.random.default_rng(seed)
    rows = torch.tensor(rng.standard_normal((N, 128)).astype(np.float32))
    seg = np.zeros(N, np.int32)
    if kind == "row 0":
        seg[0] = 1
        seg[rng.choice(N, N // 50, replace=False)] = 1
    elif kind == "tile boundaries":
        seg[::TILE] = 1
        seg[TILE * 7::TILE * 3] = 0  # some boundaries left out
        seg[0] = 0
    elif kind == "group boundaries":
        seg[RPT::RPT * 3] = 1
        seg[TILE - 1::TILE * 5] = 1  # a tile's last row
    elif kind == "chains":  # tiles with no start, chained over many tiles
        seg[rng.choice(N, N // 40, replace=False)] = 1
        seg[3 * TILE + 5:30 * TILE + 2] = 0
        seg[40 * TILE:] = 0
        seg[0] = 0
    elif kind == "every row":
        seg[:] = 1
    elif kind == "random":
        seg[rng.choice(N, N // 4, replace=False)] = 1
    return rows, torch.tensor(seg)


KINDS = ["row 0", "tile boundaries", "group boundaries", "chains",
         "every row", "random", "none"]


@pytest.mark.parametrize("stop", ["nearest", "deepest", "random"])
@pytest.mark.parametrize("kind", KINDS)
def test_model_is_the_plain_scan(kind, stop):
    rows, seg = ragged(kind)
    want = segmented_inclusive_sum_torch(rows, seg)
    got = lookback_model(rows, seg, stop=stop)
    assert torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL), (
        float((got - want).abs().max()))
    if kind == "every row":
        assert torch.equal(got, rows)


def test_model_at_phase_12_shape_of_segments():
    """A segment that runs through many tiles among short ones, as phase
    12's 5000-row segment among 500 000 starts in 2^21 rows (scaled down)."""
    N = 1024 * 8
    rng = np.random.default_rng(3)
    rows = torch.tensor(rng.standard_normal((N, 128)).astype(np.float32))
    seg = np.zeros(N, np.int32)
    seg[rng.choice(N, N // 4, replace=False)] = 1
    seg[1000:6000] = 0
    seg[0] = 0
    seg = torch.tensor(seg)
    want = segmented_inclusive_sum_torch(rows, seg)
    got = lookback_model(rows, seg)
    assert torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)
    assert float(want[5999].abs().max()) > 100  # the long segment summed up


@pytest.mark.parametrize("kind", ["chains", "none", "tile boundaries"])
def test_every_stop_of_the_lookback_gives_the_same_bits(kind):
    """For every tile, the carry from every tile its look-back may stop at
    (the last tile with a start, or before tile 0, up to the tile before
    it) has the same bits: the inclusive prefixes are left folds, so the
    kernel's result does not depend on timing."""
    rows, seg = ragged(kind)
    _, _, A, FA = tile_scan(rows, seg)
    s_of = last_start_before(FA)
    inc = []
    depths = 0
    rng = np.random.default_rng(5)
    for k in range(A.shape[0]):
        lo = s_of[k]
        first = carry_from(k - 1, k, inc, A) if k else None
        for j in range(lo, k):
            # the fold from j, and the same with the inclusive prefixes of
            # some tiles after j taken as they were published meanwhile
            taken = {m for m in range(j + 1, k) if rng.random() < 0.3}
            for c in (carry_from(j, k, inc, A),
                      carry_from(j, k, inc, A, taken)):
                assert (c is None) == (first is None)
                assert c is None or torch.equal(c, first), (k, j)
            depths = max(depths, k - j)
        inc.append(A[k] if FA[k] or first is None else first + A[k])
    assert depths >= (20 if kind != "tile boundaries" else 1)
    runs = [lookback_model(rows, seg, stop=s, seed=i)
            for i, s in enumerate(("nearest", "deepest", "random",
                                   "random"))]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_a_tree_of_the_aggregates_would_change_the_bits():
    """The test above has teeth: a look-back that sums the aggregates
    between the stop and the tile as a tree (a textbook decoupled
    look-back's window reduction) gives carries whose bits depend on where
    it stopped."""
    rows, seg = ragged("none")
    _, _, A, _ = tile_scan(rows, seg)
    inc = []
    differ = 0
    for k in range(A.shape[0]):
        first = carry_from(k - 1, k, inc, A) if k else None
        inc.append(A[k] if first is None else first + A[k])
        for j in range(0, k - 1):
            parts = list(A[j + 1:k])
            while len(parts) > 1:  # pairwise, as a tree
                parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                         else parts[i] for i in range(0, len(parts), 2)]
            differ += not torch.equal(inc[j] + parts[0], first)
    assert differ > 0


def test_a_nan_row_stays_inside_its_segment():
    rows, seg = ragged("chains")
    clean = lookback_model(rows, seg)
    bad_row = 3 * TILE + 9  # inside the chain of tiles with no start
    rows[bad_row] = float("nan")
    bad = lookback_model(rows, seg)
    nxt = int(torch.nonzero(seg[bad_row:])[0]) + bad_row
    assert nxt > bad_row + 5 * TILE
    assert torch.isnan(bad[bad_row:nxt]).all()
    assert torch.equal(bad[nxt:], clean[nxt:])
    assert torch.equal(bad[:bad_row], clean[:bad_row])
    want = segmented_inclusive_sum_torch(rows, seg)
    assert torch.isnan(want[bad_row:nxt]).all()


def test_source_makes_the_models_selects_and_folds():
    """The kernel assigns at a start (never multiplies by 1 - f), folds in
    the model's order, publishes each column's value and flag as one 64-bit
    word, waits where a word is not published yet, and is one launch after
    the memsets of its status words and counter."""
    body = " ".join(TEXT.split())
    for line in (
            "v[i] = f[i] ? v[i] : add4(v[i - 1], v[i]);",
            "e = (F || !have) ? G : add4(e, G);",
            "if (have && !own[i]) v[i] = add4(e, v[i]);",
            "A = F ? s_grp[h][q] : add4(A, s_grp[h][q]);",
            "return (flag_of(w) == INCLUSIVE || !have) ? value_of(w) "
            ": c + value_of(w);",
            "publish(mine, A, FA ? INCLUSIVE : AGGREGATE);",
            "publish(mine, have_c ? add4(c, A) : A, INCLUSIVE);",
            "have_c ? add4(c, v[i]) : v[i]",
            "for (int m = j + 1; m < b; ++m)",
            "} while (none); if (all_inc) break;",
            "return (unsigned long long)flag << 32 | __float_as_uint(v);",
            "st.relaxed.gpu.global.v2.u64",
            "ld.relaxed.gpu.global.v2.u64",
            "atomicAdd(counter, 1u)",
            "sizeof(unsigned long long) * LANES * (size_t)nt",
            "cudaMemsetAsync(counter, 0, sizeof(int32_t), s)"):
        assert line in body, line
    assert len(re.findall(r"<<<", TEXT)) == 1
    assert not re.search(r"\*\s*\(\s*1(\.f?)?\s*-", TEXT)
    assert "constexpr int TILE = GROUPS * RPT;" in TEXT
    assert TILE == kernels.SEG_TILE and kernels.SEG_ROWS % TILE == 0
    assert re.search(r"constexpr int QUADS = LANES / 4;", TEXT)

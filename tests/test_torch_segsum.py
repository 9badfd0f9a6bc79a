"""Parity of the port's segmented row sum (plain version of kernel K6) and
permutation helpers with envgs_tpu/ops/segsum.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import segsum as jseg
from envgs_tpu_torch.ops import segsum as tseg


def _loop(rows, seg):
    """The sequential float32 definition."""
    ref = np.zeros_like(rows)
    acc = np.zeros(rows.shape[1], np.float32)
    for i in range(rows.shape[0]):
        if seg[i]:
            acc = np.zeros(rows.shape[1], np.float32)
        acc = acc + rows[i]
        ref[i] = acc
    return ref


@pytest.mark.parametrize("first_row_starts", [True, False])
def test_segmented_sum_matches_jax(first_row_starts):
    """Three 1024-row blocks, 37 random starts, none in rows 700..2500 (a
    segment that runs through a whole block without a start), with and
    without a start at row 0 (JAX then sums from a zero carry). Bound: the
    JAX test's own, rtol 1e-5 / atol 1e-4: the three sum in different
    orders (JAX a log-step tree per block, the plain version a float64
    running sum, the loop sequentially in float32)."""
    rng = np.random.default_rng(0)
    N = tseg.SROWS * 3
    assert tseg.SROWS == jseg.SROWS and tseg.SLANES == jseg.SLANES
    rows = rng.normal(size=(N, 128)).astype(np.float32)
    seg = np.zeros(N, np.int32)
    seg[rng.choice(N, 37, replace=False)] = 1
    seg[700:2500] = 0
    seg[0] = int(first_row_starts)
    want = np.asarray(jseg.segmented_inclusive_sum(
        jnp.asarray(rows), jnp.asarray(seg), interpret=True))
    got = tseg.segmented_inclusive_sum(torch.tensor(rows),
                                       torch.tensor(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, _loop(rows, seg), rtol=1e-5, atol=1e-4)
    assert np.abs(want[2499]).max() > 20  # the long segment did accumulate


def test_segmented_sum_rejects_ragged_length():
    rows = torch.zeros(1000, 128)
    with pytest.raises(AssertionError):
        tseg.segmented_inclusive_sum(rows, torch.zeros(1000,
                                                       dtype=torch.int32))


def test_permutation_helpers_match_jax():
    """invert_permutation and permute_rows (forward and gradient) equal the
    JAX package's."""
    rng = np.random.default_rng(3)
    n, w = 257, 5
    x = rng.random((n, w), np.float32)
    perm = rng.permutation(n).astype(np.int32)
    cot = rng.random((n, w), np.float32)
    jinv = jseg.invert_permutation(jnp.asarray(perm))
    tinv = tseg.invert_permutation(torch.tensor(perm))
    assert tinv.dtype == torch.int32
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    jy, jvjp = jax.vjp(lambda a: jseg.permute_rows(a, jnp.asarray(perm), jinv),
                       jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tseg.permute_rows(tx, torch.tensor(perm).long(), tinv)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    (g,) = torch.autograd.grad(ty, tx, torch.tensor(cot))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]))

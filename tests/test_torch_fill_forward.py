"""Parity of the port's fill-forward (K5's plain version) and of the
chunk-aligned training layout of bin_splats with the JAX package."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import binning as jbin
from envgs_tpu.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu.ops.fill_forward import fill_forward as jfill_forward
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.ops import binning as tbin
from envgs_tpu_torch.ops.common import PreparedSplats
from envgs_tpu_torch.ops.fill_forward import fill_forward, fill_forward_torch

N = 2 * 128 * 256  # two blocks of the JAX kernel: the carry crosses a block


@pytest.mark.parametrize("markers", ["random", "none", "at_zero"])
def test_fill_forward_matches_pallas_kernel(markers):
    """Three int32 channels (negative values included); the marker set is
    random, empty (every position 0), or one marker at position 0 plus a
    few more, the first only past the first JAX block."""
    rng = np.random.default_rng(1)
    vals = rng.integers(-2 ** 30, 2 ** 30, size=(3, N), dtype=np.int32)
    if markers == "random":
        valid = rng.random(N) < 0.01
    elif markers == "none":
        valid = np.zeros(N, bool)
    else:
        valid = np.zeros(N, bool)
        valid[[0, 128 * 256 + 5, N - 1]] = True
    want = np.asarray(jfill_forward(jnp.asarray(vals), jnp.asarray(valid),
                                    interpret=True))
    got = fill_forward(torch.tensor(vals), torch.tensor(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fill_forward_torch(torch.tensor(vals), torch.tensor(valid)).numpy(),
        want)
    if markers == "none":
        assert not want.any()
    if markers == "at_zero":
        assert (want[:, 5] == vals[:, 0]).all()


def _prep(H, W, P, seed):
    """Splats in the middle of the view: the outer tiles stay empty."""
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.3,
                            rng.random((P, 1)) * 3.0 + 3.0],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.3 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, 5)).astype(np.float32)
    active = jnp.asarray(rng.random(P) > 0.1)
    return jax.jit(lambda *a: prepare_splats(*a, cam, active=active))(
        means, quats, scales, opac, colors)


def test_bin_splats_aligned_matches_jax():
    """The training layout on JAX's own prepared splats: gauss_idx and the
    64-aligned tile_bounds integer-equal, every tile's range a multiple of
    64 padded with the sentinel P, the layout's length JAX's cap_aligned."""
    H, W, P = 48, 128, 300
    jp = _prep(H, W, P, seed=2)
    jb = jax.jit(functools.partial(
        jbin.bin_splats, H=H, W=W, tile=16, pair_cap=4096, align=64,
        interpret=True, lowpass_r=ROWCULL_LOWPASS_R, aligned=True))(jp)
    tp = PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tb = tbin.bin_splats(tp, H, W, 16, 4096, align=64,
                         lowpass_r=ROWCULL_LOWPASS_R, aligned=True)
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.gauss_idx.numpy(),
                                  np.asarray(jb.gauss_idx))
    np.testing.assert_array_equal(tb.tile_bounds.numpy(),
                                  np.asarray(jb.tile_bounds))
    assert int(tb.num_pairs) == int(jb.num_pairs)
    bounds = tb.tile_bounds.numpy()
    assert (bounds % 64 == 0).all()
    # some tiles are empty, some hold more than one chunk
    sizes = np.diff(bounds)
    assert (sizes == 0).any() and (sizes > 64).any()
    gidx = tb.gauss_idx.numpy()
    assert (gidx[bounds[-1]:] == P).all() and (gidx[:bounds[-1]] == P).any()

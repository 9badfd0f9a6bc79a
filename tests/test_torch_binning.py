"""Parity of the port's render-layout binning with the JAX package:
integer-equal pair layouts from the same prepared splats."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import binning as jbin
from envgs_tpu.ops.common import ROWCULL_LOWPASS_R, prepare_splats
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.ops import binning as tbin
from envgs_tpu_torch.ops.common import PreparedSplats


def _prep(H, W, P, scale, seed):
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.7,
                            rng.random((P, 1)) * 3.0 + 1.0],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * scale + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, 5)).astype(np.float32)
    active = jnp.asarray(rng.random(P) > 0.1)
    return jax.jit(lambda *a: prepare_splats(*a, cam, active=active))(
        means, quats, scales, opac, colors)


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_bin_splats_matches_jax(case):
    """Unaligned render layout with the row cull: order, gauss_idx,
    tile_bounds and num_pairs integer-equal to JAX. "overflow" requests
    more pairs than the cap (32768 after the layout's rounding), so the
    farthest splats drop deterministically on both sides."""
    H, W, P, scale = ((48, 64, 300, 0.25) if case == "fits"
                      else (128, 160, 1500, 0.9))
    jp = _prep(H, W, P, scale, seed=4)
    cap = 4096
    jb = jax.jit(functools.partial(
        jbin.bin_splats, H=H, W=W, tile=16, pair_cap=cap, align=64,
        lowpass_r=ROWCULL_LOWPASS_R, aligned=False))(jp)
    tp = PreparedSplats(*(torch.tensor(np.asarray(x)) for x in jp))
    tb = tbin.bin_splats(tp, H, W, 16, cap, align=64,
                         lowpass_r=ROWCULL_LOWPASS_R)
    n = int(jb.num_pairs)
    assert (n > 32768) == (case == "overflow"), n
    assert int(tb.num_pairs) == n
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.gauss_idx.numpy(),
                                  np.asarray(jb.gauss_idx))
    np.testing.assert_array_equal(tb.tile_bounds.numpy(),
                                  np.asarray(jb.tile_bounds))
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    # the row cull retargeted some pairs past every real tile
    assert int(tb.tile_bounds[-1]) < min(n, 32768)


def test_aligned_layout_is_not_ported():
    tp = PreparedSplats(*(torch.tensor(np.asarray(x))
                          for x in _prep(32, 32, 20, 0.2, seed=0)))
    with pytest.raises(NotImplementedError, match="K5"):
        tbin.bin_splats(tp, 32, 32, 16, 1024, aligned=True)

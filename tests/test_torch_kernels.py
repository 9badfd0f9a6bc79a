"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and skip without one; on the card:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from envgs_tpu_torch import bench, kernels
from envgs_tpu_torch.models.envgs import EnvGSConfig
from envgs_tpu_torch.models.gaussians import create_pool
from envgs_tpu_torch.ops.raster_blend import blend_tiles, blend_tiles_torch
from envgs_tpu_torch.ops.trace_blend import trace_blend, trace_blend_torch
from envgs_tpu_torch.utils.camera import make_camera

pytestmark = pytest.mark.cuda
# the kernels round every operation as the plain versions do (-fmad=false);
# what is left is expf / division ulps moving a pixel across the 1e-4
# transmittance test, bounded by T ~ 1e-4 times a channel value
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(device, H=80, W=104):
    """K1 and K3 arguments of a small render (seeded numpy); W is not a
    multiple of 16."""
    rng = np.random.default_rng(7)
    P, Pe = 600, 800
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.7,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                       sh_degree=3, init_opacity=0.7, device=device)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                      sh_degree=3, init_opacity=0.7, device=device)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), device=device)
    cfg = EnvGSConfig(pair_cap=2 ** 15, env_pair_cap=2 ** 16,
                      reflection_start_iter=0, render_mode=True)
    return bench.blend_inputs(base, env, cam, cfg)


def test_raster_blend_kernel_matches_plain(cuda):
    args = _inputs(cuda)[0]
    n = kernels.LAUNCHES["raster_blend_fwd"]
    got = blend_tiles(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_blend_fwd"] == n + 1
    want = blend_tiles_torch(*args)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ATOL
    assert float(want[args[3] + 1].max()) > 0.9  # saturated pixels


def test_trace_blend_kernel_matches_plain(cuda):
    args = _inputs(cuda)[1]
    n = kernels.LAUNCHES["trace_blend_fwd"]
    got = trace_blend(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_blend_fwd"] == n + 1
    want = trace_blend_torch(*args)
    assert float((got - want).abs().max()) <= ATOL
    assert float(want[3].max()) > 0.5


def test_kernel_wrappers_reject_bad_inputs(cuda):
    packed = torch.zeros(5, 32, device=cuda)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    bounds = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.raster_blend_fwd(packed, idx.long(), bounds, 3, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        kernels.trace_blend_fwd(packed, idx, torch.zeros(2, 8, 256,
                                                         device=cuda),
                                bounds, 1, 1)
    out = kernels.raster_blend_fwd(packed, idx, bounds, 3, 1, 1)
    assert float(out[-1].min()) == 1.0  # empty tile: T stays 1

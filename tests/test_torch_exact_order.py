"""Parity of the port's exact per-ray tracer order (`trace_rays(
exact_order=True)`, the evaluation default) with the JAX package's, and
the model-level switch `tracer_exact_order`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import tracer as jtr
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops.tracer_ref import \
    prepare_trace_scene as t_prepare_trace_scene

H, W = 40, 48  # 3 x 3 ray tiles, the last row partial
# both sides run the same float32 formulas; what differs is the order of
# the sums over a ray's hits (XLA's einsum and reductions against torch's):
# 1e-5 absolute on the unit-scale outputs and 1e-5 relative on the depth,
# a ratio of two such sums that reaches 9 units here
ATOL = 1e-5
RTOL = 1e-5


def _scene_arrays(P=1200, seed=0):
    """Surfels at 4-9 units, tangent to their shell, around the bundle's
    direction (the scene of test_torch_tracer.py), with two aux channels."""
    rng = np.random.default_rng(seed)
    base = np.array([0.3, -0.2, 1.0])
    dirs = base / np.linalg.norm(base) + 0.35 * rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = rng.choice(np.linspace(4.0, 9.0, 6), size=P)
    means = (dirs * radii[:, None]).astype(np.float32)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(np.broadcast_to(z, dirs.shape), dirs)
    s = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(s > 1e-6, axis / np.clip(s, 1e-6, None), [1.0, 0, 0])
    ang = np.arccos(np.clip(dirs[:, 2:3], -1, 1))
    quats = np.concatenate([np.cos(ang / 2), axis * np.sin(ang / 2)], -1)
    quats = (quats + 0.03 * rng.normal(size=(P, 4))).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.08 + 0.03).astype(np.float32)
    opac = (rng.random(P) * 0.8 + 0.15).astype(np.float32)
    colors = rng.random((P, 3)).astype(np.float32)
    aux = rng.random((P, 2)).astype(np.float32)
    active = rng.random(P) > 0.05
    return (means, quats, scales, opac, colors, aux), active


def _rays(seed=1):
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    base = np.array([0.3, -0.2, 1.0])
    d = base + 0.45 * np.stack([jj, ii, 0.2 * jj * ii], -1)
    o = 0.05 * np.stack([jj, ii, np.zeros_like(jj)], -1)
    o = o + 0.01 * rng.normal(size=o.shape)
    return o.astype(np.float32), d.astype(np.float32)


def test_exact_order_matches_jax():
    """Every output of the exact-order blend (rgb with background, depth,
    acc, ray-facing normal, distortion, aux, final T) within ATOL of JAX's
    from the same numpy inputs; the candidate windows are the same (slot
    counts equal); a tile block of 2 gives what the default gives; and the
    exact order does differ from the radial order somewhere."""
    o, d = _rays()
    arrays, active = _scene_arrays()
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    @jax.jit
    def jfwd(*a):
        scene = prepare_trace_scene(*a[:5], aux=a[5],
                                    active=jnp.asarray(active))
        return jtr.trace_rays(scene, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(bg), backend="tiled_interp",
                              total_pair_cap=2 ** 14, exact_order=True)

    jout = jfwd(*arrays)
    ts = t_prepare_trace_scene(*map(torch.tensor, arrays[:5]),
                               aux=torch.tensor(arrays[5]),
                               active=torch.tensor(active))
    args = (ts, torch.tensor(o), torch.tensor(d), torch.tensor(bg))
    tout = ttr.trace_rays(*args, total_pair_cap=2 ** 14, exact_order=True)
    for k in ("rgb", "dpt", "acc", "norm", "dist", "aux", "trans"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert int(tout.num_pairs) == int(jout.num_pairs)
    assert int(tout.dropped_pairs) == int(jout.dropped_pairs) == 0
    assert not tout.wet.any() and tout.aux.shape == (H, W, 2)
    assert float(tout.acc.max()) > 0.5

    tiles = ttr.build_ray_tiles(args[1], args[2])
    gidx, bounds, *_ = ttr.cull_and_sort(
        tiles, ts, ttr.splat_radius3(ts),
        per_tile_cap=ttr.default_per_tile_cap(1200), total_pair_cap=2 ** 14)
    K = ttr.default_per_tile_cap(1200)
    a = ttr._trace_tiles_exact(ts, tiles.rays, gidx, bounds, K)
    b = ttr._trace_tiles_exact(ts, tiles.rays, gidx, bounds, K, tile_block=2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)

    radial = ttr.trace_rays(*args, total_pair_cap=2 ** 14)
    assert float((radial.rgb - tout.rgb).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="exact_order"):
        ttr.trace_rays(*args, exact_order=True, wet_zero=torch.zeros(1200))

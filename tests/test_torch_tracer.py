"""Parity of the port's surfel tracer (render path) with the JAX package:
ray tiles, the chunk index, the cone cull (integer-equal), the plain
version of kernel K3 against the Pallas kernel in interpret mode, and
trace_rays end to end, also with the geometry outputs (the other `needs`:
tests/test_torch_trace_needs.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import tracer as jtr
from envgs_tpu.ops.raster_pallas import pack_rows
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops.trace_blend import trace_blend_torch
from envgs_tpu_torch.ops.tracer_ref import TraceScene
from envgs_tpu_torch.ops.tracer_ref import \
    prepare_trace_scene as t_prepare_trace_scene

H, W = 40, 48  # 3 x 3 ray tiles, the last row partial (edge padding)
ATOL = 1e-5


def _scene_arrays(P=1200, seed=0):
    """Environment-like surfels at 4-9 units, tangent to their shell (the
    EnvGS dome geometry), concentrated around the ray bundle's direction so
    tiles see many candidates and the direction-space probe has work."""
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
    active = rng.random(P) > 0.05
    return means, quats, scales, opac, colors, active


def _rays(seed=1):
    """A coherent reflected-ray-like bundle: per-pixel origins near a
    surface point, directions spread over a cone."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    base = np.array([0.3, -0.2, 1.0])
    d = base + 0.45 * np.stack([jj, ii, 0.2 * jj * ii], -1)
    o = 0.05 * np.stack([jj, ii, np.zeros_like(jj)], -1)
    o = o + 0.01 * rng.normal(size=o.shape)
    return o.astype(np.float32), d.astype(np.float32)


def _both():
    means, quats, scales, opac, colors, active = _scene_arrays()
    js = prepare_trace_scene(*map(jnp.asarray, (means, quats, scales, opac,
                                                colors)),
                             active=jnp.asarray(active))
    ts = t_prepare_trace_scene(*map(torch.tensor, (means, quats, scales,
                                                   opac, colors)),
                               active=torch.tensor(active))
    return js, ts


def _t(x):
    return torch.tensor(np.asarray(x))


def _radius3(scene):
    su = 1.0 / jnp.clip(jnp.linalg.norm(scene.t_u, axis=-1), 1e-12, None)
    sv = 1.0 / jnp.clip(jnp.linalg.norm(scene.t_v, axis=-1), 1e-12, None)
    return 3.0 * jnp.maximum(su, sv)


def test_build_ray_tiles():
    o, d = _rays()
    jt = jtr.build_ray_tiles(jnp.asarray(o), jnp.asarray(d))
    tt = ttr.build_ray_tiles(torch.tensor(o), torch.tensor(d))
    assert tt.n_tiles == jt.n_tiles == 9
    np.testing.assert_array_equal(tt.probe_ok.numpy(), np.asarray(jt.probe_ok))
    for k in ("rays", "apex", "axis", "tan_half", "spread", "probe_frame",
              "probe_box"):
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(jt, k)), atol=ATOL,
                                   err_msg=k)


def test_build_chunk_index():
    js, ts = _both()
    ji = jtr.build_chunk_index(js, _radius3(js))
    ti = ttr.build_chunk_index(ts, ttr.splat_radius3(ts))
    np.testing.assert_array_equal(ti.order.numpy(), np.asarray(ji.order))
    np.testing.assert_array_equal(ti.cact.numpy(), np.asarray(ji.cact))
    for k in ("mean_s", "rad_s", "cmean", "crad"):
        np.testing.assert_allclose(getattr(ti, k).numpy(),
                                   np.asarray(getattr(ji, k)), atol=ATOL,
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("total_cap", [None, 1024])
def test_cull_and_sort_matches_jax(total_cap):
    """Same tiles, scene and radii in: slot indices, bounds and the dropped
    count integer-equal. The scene makes the direction-space probe reject
    candidates (checked against the JAX cull with the probe off); the 1024
    budget truncates the last tiles."""
    o, d = _rays()
    js, _ = _both()
    r3 = _radius3(js)
    jt = jtr.build_ray_tiles(jnp.asarray(o), jnp.asarray(d))
    cull = jax.jit(lambda probe: jtr.cull_and_sort(
        jt, js, r3, per_tile_cap=1024, total_pair_cap=total_cap,
        probe=probe), static_argnums=0)
    jg, jb, jd = cull(True)
    if total_cap is None:
        assert int(cull(False)[1][-1]) > int(jb[-1])  # the probe rejects
    else:
        assert int(jd) > 0
    tt = ttr.RayTiles(*(_t(x) if not isinstance(x, int) else x for x in jt))
    ts = TraceScene(*map(_t, js))
    tg, tb, td, _ = ttr.cull_and_sort(tt, ts, _t(r3), per_tile_cap=1024,
                                      total_pair_cap=total_cap, tile_block=4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(td) == int(jd)


def test_trace_blend_matches_pallas_kernel():
    """Same slots, table and rays in: rgb, acc and T equal to ATOL."""
    o, d = _rays()
    js, _ = _both()
    jt = jtr.build_ray_tiles(jnp.asarray(o), jnp.asarray(d))
    gidx, bounds, _ = jtr.cull_and_sort(jt, js, _radius3(js),
                                        per_tile_cap=1024)
    packed = jtr._pack_scene_table(js)

    @jax.jit
    def blend(packed, gidx, rays, bounds):
        pairs = pack_rows(packed)[gidx]
        return jtr._trace_fwd_call(pairs, rays, bounds, 0, True,
                                   needs=(False, False, False))[0]

    tiles = np.asarray(blend(packed, gidx, jt.rays, bounds))  # (T, F, 256)
    got = trace_blend_torch(_t(packed), _t(gidx), _t(jt.rays), _t(bounds),
                            3, 3).numpy()
    want = tiles.reshape(3, 3, -1, 16, 16).transpose(2, 0, 3, 1, 4).reshape(
        tiles.shape[1], 48, 48)
    r = jtr._rows(0)
    np.testing.assert_allclose(got[:3], want[:3], atol=ATOL)
    np.testing.assert_allclose(got[3], want[r["acc"]], atol=ATOL)
    np.testing.assert_allclose(got[4], want[r["trans"]], atol=ATOL)
    assert want[r["acc"]].max() > 0.5


def test_trace_rays_matches_jax():
    """trace_rays end to end from the same numpy inputs."""
    o, d = _rays()
    means, quats, scales, opac, colors, active = _scene_arrays()
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    @jax.jit
    def jfwd(*a):
        scene = prepare_trace_scene(*a, active=jnp.asarray(active))
        return jtr.trace_rays(scene, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(bg), backend="tiled_interp",
                              total_pair_cap=2 ** 14,
                              needs=(False, False, False))

    jout = jfwd(means, quats, scales, opac, colors)
    ts = t_prepare_trace_scene(*map(torch.tensor, (means, quats, scales,
                                                   opac, colors)),
                               active=torch.tensor(active))
    tout = ttr.trace_rays(ts, torch.tensor(o), torch.tensor(d),
                          torch.tensor(bg), total_pair_cap=2 ** 14)
    for k in ("rgb", "acc", "trans", "dpt", "norm"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=ATOL,
                                   err_msg=k)
    assert int(tout.num_pairs) == int(jout.num_pairs)
    assert int(tout.dropped_pairs) == int(jout.dropped_pairs) == 0


def test_trace_rays_geometry_outputs_raise():
    """needs = (False, False, True), once refused, is the geometry path of
    a traced base pass now (K3's geometry configuration): depth, normal,
    acc and rgb within ATOL of JAX's (depth within ATOL of its largest
    value: ray parameters of 4 to 9), distortion and wet zeros on both
    sides."""
    js, ts = _both()
    o, d = _rays()
    want = jax.jit(lambda s: jtr.trace_rays(
        s, jnp.asarray(o), jnp.asarray(d), jnp.zeros(3),
        backend="tiled_interp", total_pair_cap=2 ** 14,
        needs=(False, False, True)))(js)
    got = ttr.trace_rays(ts, torch.tensor(o), torch.tensor(d), torch.zeros(3),
                         total_pair_cap=2 ** 14, needs=(False, False, True))
    for k in ("rgb", "acc", "trans", "norm", "dist", "wet"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.dpt.numpy(), np.asarray(want.dpt),
                               atol=ATOL * float(np.abs(want.dpt).max()))
    assert float(got.dpt.max()) > 4.0 and float(got.norm.abs().max()) > 0.5
    assert not got.dist.any() and not got.wet.any()

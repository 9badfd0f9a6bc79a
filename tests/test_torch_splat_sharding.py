"""Parity of the port's splat-slab parallelism (parallel/splat_sharding.py)
with the JAX package: slab_assignment, compose_slabs and
compose_trace_slabs on numpy-made parts, and the slab base pass, the slab
train step over 2 gloo ranks and the ('band', 'splat') step over 2 x 2
ranks (tests/torch_ranks.py) against a JAX reference built from JAX's
single-device pieces as its _slab_base_pass / _slab_env_pass compose them:
slab_assignment, prepare_splats on `active & (slab == k)`, rasterize with
bg 0, trace_rays(compose_raw=True), compose_slabs, compose_trace_slabs,
render_decode. That checks the slab-local wet exactly, not against the
single image's wet. The JAX side runs its kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.ops import raster as jraster
from envgs_tpu.ops import tracer as jtracer
from envgs_tpu.ops.common import prepare_splats
from envgs_tpu.ops.raster_ref import RasterOutput as JRasterOutput
from envgs_tpu.ops.tracer_ref import TraceOutput as JTraceOutput
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu.parallel import splat_sharding as jss
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.utils.camera import Camera as JCamera
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.ops.raster_ref import RasterOutput
from envgs_tpu_torch.ops.tracer_ref import TraceOutput
from envgs_tpu_torch.parallel import splat_sharding as tss
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_train_step import (
    LOSS_CFG,
    LOSS_RTOL,
    _close,
    _jax_state_to_numpy,
)
from torch_ranks import run_ranks, slab_render_worker, slab_step_worker

H, W, F = 32, 32, 40.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
EYE, ZERO = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
IT = 25000
CAP = 2 ** 12  # each slab's pair cap (base and env)
KW = dict(pair_cap=2 ** 13, env_pair_cap=2 ** 13, reflection_start_iter=0)
ATOL = 1e-5
# the depth-derived surface normal: a normalized cross product of depth
# differences, which turns last-bit depth differences into 1e-5 of a unit
# vector (tests/test_torch_envgs.py's bound for the maps past the depth)
NORMAL_ATOL = 1e-4
# slabs against the single blend, of each map's largest value: a slab
# keeps pairs the single blend refuses at T (1 - a) < 1e-4, each weighing
# a T up to 1e-4 / (1 - a) <= 1e-2 (a <= 0.99)
SLAB_CUTOFF_RTOL = 1e-2


def test_slab_assignment_matches_jax():
    """The JAX test's example, and random depths with ties and invalid
    splats over 3 slabs: equal to JAX's slabs."""
    depth = np.float32([5.0, 1.0, 3.0, 2.0, 4.0, 9.0])
    valid = np.array([True, True, True, True, True, False])
    got = tss.slab_assignment(torch.tensor(depth), torch.tensor(valid), 3)
    np.testing.assert_array_equal(got.numpy(), [2, 0, 1, 0, 1, 2])
    rng = np.random.default_rng(0)
    depth = np.round(rng.random(101) * 10, 1).astype(np.float32)  # ties
    valid = rng.random(101) > 0.2
    for D in (2, 3, 4):
        got = tss.slab_assignment(torch.tensor(depth), torch.tensor(valid), D)
        want = jss.slab_assignment(jnp.asarray(depth), jnp.asarray(valid), D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _parts(fields, shapes, rng, D=3):
    return {k: rng.random((D, *shapes[k])).astype(np.float32)
            for k in fields}


def test_compose_slabs_matches_jax():
    """Three numpy-made premultiplied parts (T in (0, 1), the moments
    positive) composed in slab order: every output within 1e-6 of JAX's,
    wet summed, radii maxed, pair counts summed."""
    rng = np.random.default_rng(1)
    h, w, P, C = 8, 6, 10, 5
    shapes = dict(rgb=(h, w, C), depth_expected=(h, w), alpha=(h, w),
                  normal=(h, w, 3), depth_median=(h, w), distortion=(h, w),
                  wet=(P,), radii=(P,), trans=(h, w), d1=(h, w), d2=(h, w))
    parts = _parts(shapes, shapes, rng)
    npairs = np.int32([7, 11, 13])
    bg = np.float32([0.2, 0.3, 0.4])
    want = jss.compose_slabs(JRasterOutput(
        **{k: jnp.asarray(v) for k, v in parts.items()},
        num_pairs=jnp.asarray(npairs)), jnp.asarray(bg), C)
    got = tss.compose_slabs(RasterOutput(
        **{k: torch.tensor(v) for k, v in parts.items()},
        num_pairs=torch.tensor(npairs)), torch.tensor(bg), C)
    for k in shapes:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert int(got.num_pairs) == int(want.num_pairs) == 31


def test_compose_trace_slabs_matches_jax():
    """Three raw trace parts composed in slab order: every output within
    1e-6 of JAX's, the normalized depth included."""
    rng = np.random.default_rng(2)
    h, w, P, A = 8, 6, 10, 2
    shapes = dict(rgb=(h, w, 3), dpt=(h, w), acc=(h, w), norm=(h, w, 3),
                  dist=(h, w), aux=(h, w, A), wet=(P,), trans=(h, w),
                  d1=(h, w), d2=(h, w))
    parts = _parts(shapes, shapes, rng)
    dropped = np.int32([0, 3, 1])
    bg = np.float32([0.1, 0.2, 0.3])
    want = jss.compose_trace_slabs(JTraceOutput(
        **{k: jnp.asarray(v) for k, v in parts.items()},
        dropped_pairs=jnp.asarray(dropped)), jnp.asarray(bg))
    got = tss.compose_trace_slabs(TraceOutput(
        **{k: torch.tensor(v) for k, v in parts.items()},
        dropped_pairs=torch.tensor(dropped)), torch.tensor(bg))
    for k in shapes:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert int(got.dropped_pairs) == 4


# ---- the JAX reference from single-device pieces ----

def _jax_base_pass(D):
    """JAX's _slab_base_pass with the slabs looped on one device."""
    def base_pass(pool, cam, cfg, means2d_zero=None, wet_zero=None):
        train = not cfg.render_mode
        colors = jenv._pool_colors(pool, cam.center)
        if cfg.render_reflection:
            colors = jnp.concatenate(
                [colors, pool.get_specular, pool.get_roughness], axis=-1)
        args = (pool.params.xyz, pool.params.rotation, pool.get_scaling,
                pool.get_opacity[:, 0])
        pre = prepare_splats(*args, jnp.zeros((pool.cap, 3)), cam,
                             scale_modifier=cfg.scale_modifier,
                             active=pool.stats.active)
        slab = jax.lax.stop_gradient(
            jss.slab_assignment(pre.depth, pre.valid, D))
        outs = []
        for k in range(D):
            prep = prepare_splats(*args, colors, cam,
                                  scale_modifier=cfg.scale_modifier,
                                  active=pool.stats.active & (slab == k))
            outs.append(jraster.rasterize(
                prep, cam, jnp.zeros(3), backend=cfg.raster_backend,
                pair_cap=CAP, means2d_zero=means2d_zero,
                needs=(train, train, train), wet_zero=wet_zero))
        parts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)
        C = 3 + (cfg.specular_channels + 1 if cfg.render_reflection else 0)
        composed = jss.compose_slabs(
            parts, jnp.full((3,), cfg.bg_brightness, jnp.float32), C)
        return jraster.render_decode(
            composed, cam, specular_channels=(
                cfg.specular_channels if cfg.render_reflection else 0),
            depth_ratio=cfg.depth_ratio)

    return base_pass


def _jax_env_pass(D):
    """JAX's _slab_env_pass with the slabs looped on one device."""
    def env_pass(env, ref_o, ref_d, cfg, env_means3d_zero=None,
                 ray_mask=None, wet_zero=None):
        train = not cfg.render_mode
        xyz = env.params.xyz
        if env_means3d_zero is not None:
            xyz = xyz + env_means3d_zero
        colors = jenv._pool_colors_at(env, ref_o)
        apex = jax.lax.stop_gradient(jnp.mean(ref_o.reshape(-1, 3), axis=0))
        radial = jnp.linalg.norm(jax.lax.stop_gradient(xyz) - apex[None],
                                 axis=-1)
        eslab = jss.slab_assignment(radial, env.stats.active, D)
        outs = []
        for k in range(D):
            scene = prepare_trace_scene(
                xyz, env.params.rotation, env.get_scaling,
                env.get_opacity[:, 0], colors,
                active=env.stats.active & (eslab == k),
                scale_modifier=cfg.scale_modifier)
            outs.append(jtracer.trace_rays(
                scene, ref_o, ref_d, jnp.zeros(3),
                backend=cfg.tracer_backend, total_pair_cap=CAP,
                ray_mask=ray_mask, needs=(train, train, train),
                wet_zero=wet_zero, compose_raw=True))
        parts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)
        return jss.compose_trace_slabs(
            parts, jnp.full((3,), cfg.env_bg_brightness, jnp.float32))

    return env_pass


def _pools(seed=4, dense=False):
    """A base pool and the JAX test's two radial env shells (the slab
    order then matches every ray's own order). `dense`: 400 base surfels
    of opacity 0.95 that take the image's transmittance to the blend's
    1e-4 floor."""
    rng = np.random.default_rng(seed)
    P, Pe = (400, 96) if dense else (96, 96)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * (0.3 if dense else 0.6),
                          rng.random((P, 1)) * 4 + 1.5], -1).astype(np.float32)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                       sh_degree=1, init_opacity=0.95 if dense else 0.7)
    lo, span = (0.1, 0.3) if dense else (0.02, 0.15)
    base = base._replace(params=base.params._replace(scaling=jnp.asarray(
        np.log(rng.random((P, 2)) * span + lo).astype(np.float32))))
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    r = np.where(np.arange(Pe) % 2 == 0, 12.0, 22.0)[:, None]
    env = create_pool((dirs * r).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                      sh_degree=1, init_opacity=0.6)
    env = env._replace(params=env.params._replace(
        scaling=jnp.full((Pe, 2), np.log(0.8), jnp.float32)))
    from envgs_tpu.train import trainer as jtrain

    state = jtrain.init_train_state(base, env, jax.random.PRNGKey(0))
    batch = (rng.random((H, W, 3)).astype(np.float32),
             (rng.random((H, W, 1)) > 0.1).astype(np.float32),
             rng.random((H, W, 3)).astype(np.float32))
    return state, batch


JCFG = jenv.EnvGSConfig(raster_backend="pallas_interp",
                        tracer_backend="tiled_interp", **KW)
TCFG = tenv.EnvGSConfig(**KW)


@pytest.fixture(scope="module")
def slab_renders(tmp_path_factory):
    """The sparse and the dense scene's base pools rendered by
    make_splat_sharded_render_base on 2 ranks (one spawn)."""
    starts = [_jax_state_to_numpy(_pools(dense=d)[0]) for d in (False, True)]
    tcfg = TCFG._replace(render_mode=True, render_reflection=False,
                         pair_cap=2 * CAP)
    res = run_ranks(slab_render_worker, 2, tmp_path_factory.mktemp("slabs"),
                    starts, K, (H, W, EYE, ZERO), tcfg)
    return dict(zip((False, True), zip(*res)))


@pytest.mark.parametrize("dense", [False, True])
def test_slab_render_base_matches_jax(slab_renders, dense):
    """make_splat_sharded_render_base on 2 ranks (render configuration):
    every decoded map within ATOL of the JAX reference's (the surface
    normal within NORMAL_ATOL), the radii too. Against the port's own
    single render_base: within ATOL where the image stays transparent
    enough; on the dense scene within SLAB_CUTOFF_RTOL of each map's
    largest value, and JAX's slabs depart from JAX's single render as
    much: a slab blends with its own transmittance from 1, so it keeps
    pairs the single blend refuses once T (1 - a) < 1e-4."""
    state, _ = _pools(dense=dense)
    cfg = JCFG._replace(render_mode=True, render_reflection=False)
    jcam = make_camera(H, W, K, EYE, ZERO)
    want = jax.jit(lambda b: _jax_base_pass(2)(b, jcam, cfg))(state.base)
    start = _jax_state_to_numpy(state)
    tcfg = TCFG._replace(render_mode=True, render_reflection=False,
                         pair_cap=2 * CAP)
    res = slab_renders[dense]
    got = res[0]
    tstate = ttrain.state_from_numpy(start)
    single = tenv.render_base(tstate.base, tcam.make_camera(
        H, W, K, EYE, ZERO), tcfg)
    jsingle = jax.jit(lambda b: jenv.render_base(b, jcam, cfg))(state.base)
    for k in ("rgb", "alpha", "depth_expected", "normal_world", "surf_depth",
              "surf_normal", "radii"):
        atol = NORMAL_ATOL if k == "surf_normal" else ATOL
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)),
                                   atol=atol, err_msg=k)
        np.testing.assert_array_equal(res[1][k], got[k])
        if k in ("surf_normal", "normal_world"):
            continue  # derived from the depth and alpha checked here
        ref = getattr(single, k).numpy()
        bound = SLAB_CUTOFF_RTOL * np.abs(ref).max() if dense else ATOL
        assert np.abs(got[k] - ref).max() <= bound, k
        jdev = np.abs(np.asarray(getattr(want, k))
                      - np.asarray(getattr(jsingle, k))).max()
        assert jdev <= bound, k
        if dense and k != "radii":  # the departure is real in both
            assert jdev > ATOL and np.abs(got[k] - ref).max() > ATOL, k
    assert got["alpha"].max() > 0.5


def _jax_slab_grads(state, batch, n_bands):
    """The JAX reference of a slab step's loss and gradients: forward_envgs
    with the single-device slab passes on each band's camera (the full K
    with its principal point shifted up by the band's row), the bands'
    maps stacked into the image, the surface normal of the whole image's
    depth, compute_losses of the whole image (the band-exact terms' value)."""
    D = 2
    band_h = H // n_bands
    jcam = make_camera(H, W, K, EYE, ZERO)
    base, env = state.base, state.env
    cfg = JCFG
    lcfg = jsup.LossConfig(**LOSS_CFG)

    def loss_fn(bp, ep, m2z, e3z, wz_b, wz_e):
        b = base._replace(params=bp)
        e = env._replace(params=ep)
        outs = []
        for i in range(n_bands):
            Kb = jcam.K.at[1, 2].add(-float(i * band_h))
            cam_b = JCamera(band_h, W, Kb, jcam.R, jcam.T, jcam.znear,
                            jcam.zfar)
            outs.append(jenv.forward_envgs(
                b, e, cam_b, IT, cfg, m2z, e3z, wz_b, wz_e,
                base_pass=_jax_base_pass(D), env_pass=_jax_env_pass(D)))
        out = outs[0]
        if n_bands > 1:
            cat = {k: jnp.concatenate([getattr(o, k) for o in outs])
                   for k in ("rgb_map", "acc_map", "dpt_map", "norm_map",
                             "dist_map")}
            sn = jraster.depth_to_normal(jcam, cat["dpt_map"][..., 0])
            out = out._replace(surf_norm_map=sn * jax.lax.stop_gradient(
                cat["acc_map"]), **cat)
        loss, stats = jsup.compute_losses(
            out, *map(jnp.asarray, batch), jcam.R, IT, lcfg,
            bg_brightness=cfg.bg_brightness)
        return loss, stats

    zeros = (jnp.zeros((base.cap, 2)), jnp.zeros((env.cap, 3)),
             jnp.zeros((base.cap,)), jnp.zeros((env.cap,)))
    (_, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=tuple(range(6)), has_aux=True))(
        base.params, env.params, *zeros)
    return stats, grads


@pytest.mark.parametrize("n_bands,world", [(1, 2), (2, 4)])
def test_slab_step_matches_jax(tmp_path, n_bands, world):
    """make_splat_sharded_train_step on 2 ranks (2 slabs) and on 2 x 2
    ranks (bands x slabs), every loss term on: the loss terms within
    LOSS_RTOL of the JAX reference's, every summed gradient (both pools,
    the position hooks, the slab-local wet hooks) within GRAD_RTOL of its
    array's largest; nothing over a slab's cap; the state, stats and
    gradients bit-equal on every rank."""
    state, batch = _pools()
    jstats, jg = _jax_slab_grads(state, batch, n_bands)
    start = _jax_state_to_numpy(state)
    res = run_ranks(slab_step_worker, world, tmp_path, start, batch, K,
                    (H, W, EYE, ZERO), TCFG, tsup.LossConfig(**LOSS_CFG),
                    topt.LRConfig(), IT, n_bands)
    got = res[0]
    assert set(got["stats"]) == set(jstats) | {"pair_overflow",
                                               "trace_dropped"}
    for k, v in got["stats"].items():
        if k in ("pair_overflow", "trace_dropped"):
            assert v == 0, k
        elif k != "psnr":
            np.testing.assert_allclose(v, float(jstats[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
    g = got["grads"]
    for name, tree in (("base", jg[0]), ("env", jg[1])):
        for f, v in g[name].items():
            _close(v, np.asarray(getattr(tree, f)), name=f"{name} {f}")
    for k, j in (("means2d", 2), ("env_means3d", 3), ("wet_base", 4),
                 ("wet_env", 5)):
        _close(g[k], np.asarray(jg[j]), name=k)
    assert np.abs(g["wet_env"]).max() > 0 and np.abs(g["wet_base"]).max() > 0
    for r in res[1:]:
        for name in ("base", "env"):
            for grp in ("params", "stats", "mu", "nu"):
                for k, v in got["state"][name][grp].items():
                    np.testing.assert_array_equal(
                        r["state"][name][grp][k], v, err_msg=k)
        assert r["stats"] == got["stats"]

"""The port's render slice against the JAX package: forward_envgs end to
end (render mode) on the same seeded pools, the bench scene's arrays, and
the port's independence from JAX."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch import bench as tbench
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.utils import camera as tcam

# two blends in a row plus the reflected-ray chain between them: last-bit
# differences of the base pass move the reflected rays, the env trace
# sees them through its intersections
ATOL = 1e-4


def _inputs(seed=0, P=150, Pe=200):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    col = rng.random((P, 3)).astype(np.float32)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    exyz = (dirs * 8).astype(np.float32)
    ecol = rng.random((Pe, 3)).astype(np.float32)
    return xyz, col, exyz, ecol


@pytest.mark.parametrize("filtering", [False, True])
def test_forward_envgs_matches_jax(filtering):
    """The slice: rgb, specular, acc, depth, normal and env rgb within ATOL
    of JAX (Pallas kernels in interpret mode); with `filtering`, the
    specular-quantile ray filter is on and traces only the top 30%."""
    H, W, f = 32, 48, 50.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    xyz, col, exyz, ecol = _inputs()
    kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0,
              render_mode=True)
    if filtering:
        kw.update(specular_filtering_start_iter=5,
                  specular_filtering_percent=0.7)
    jcam = make_camera(H, W, K, eye, zero)
    jb = create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    je = create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    # a spread of specular values so the quantile filter has work
    spec = np.linspace(-3, 2, 160, dtype=np.float32)[:, None]
    jb = jb._replace(params=jb.params._replace(specular=jnp.asarray(spec)))
    jcfg = EnvGSConfig(raster_backend="pallas_interp",
                       tracer_backend="tiled_interp", **kw)
    want = jax.jit(lambda b, e: forward_envgs(b, e, jcam, jnp.asarray(10),
                                              jcfg))(jb, je)

    tb = tg.create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    te = tg.create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    tb = tb._replace(params=tb.params._replace(specular=torch.tensor(spec)))
    got = tenv.forward_envgs(tb, te, tcam.make_camera(H, W, K, eye, zero),
                             10, tenv.EnvGSConfig(**kw))
    for k in ("rgb_map", "spec_map", "acc_map", "dpt_map", "norm_map",
              "env_rgb_map"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=ATOL,
                                   err_msg=k)
    for k in ("base_num_pairs", "env_num_pairs", "env_dropped_pairs"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert float(got.env_acc_map.max()) > 0.5
    traced = (got.env_acc_map > 0).float().mean()
    assert (traced < 0.9) == filtering  # the filter culls ray tiles


@pytest.mark.parametrize("depth_ratio", [0.5, 1.0])
def test_render_mode_with_median_depth_matches_jax(depth_ratio):
    """render_mode with depth_ratio > 0: the base pass on the unaligned
    render layout with the median depth written (the blend's training
    variant, the median plane alone kept). Median depth, surface depth
    and rgb within 1e-5 (absolute, plus 1e-5 of the value: depths are 2 to
    4 here, and the two packages' screen transforms differ in their last
    bits, as test_prepare_splats allows) of JAX; the surface normal, a
    normalized cross product of depth differences between neighbouring
    pixels that magnifies those last bits, within 1e-4 (within 1e-5 from
    identical prepared splats: test_torch_raster.py); distortion and wet
    zeros; and forward_envgs runs end to end on it."""
    from envgs_tpu.models.envgs import render_base

    H, W, f = 32, 48, 50.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    xyz, col, exyz, ecol = _inputs(seed=3)
    kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0,
              render_mode=True, depth_ratio=depth_ratio)
    jcam = make_camera(H, W, K, eye, zero)
    jb = create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    jcfg = EnvGSConfig(raster_backend="pallas_interp",
                       tracer_backend="tiled_interp", **kw)
    want = jax.jit(lambda b: render_base(b, jcam, jcfg))(jb)

    tb = tg.create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    te = tg.create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    cam = tcam.make_camera(H, W, K, eye, zero)
    cfg = tenv.EnvGSConfig(**kw)
    got = tenv.render_base(tb, cam, cfg)
    for k in ("depth_median", "surf_depth", "rgb"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.surf_normal.numpy(),
                               np.asarray(want.surf_normal), atol=1e-4)
    assert float(got.depth_median.max()) > 2.0  # the median was written
    assert not got.distortion.any() and not got.wet.any()
    assert not got.depth_median.requires_grad
    out = tenv.forward_envgs(tb, te, cam, 10, cfg)
    np.testing.assert_array_equal(out.dpt_map.numpy(), got.surf_depth.numpy())
    assert bool(torch.isfinite(out.rgb_map).all())
    assert float(out.env_acc_map.max()) > 0.5


def test_make_render_scene_matches_jax():
    """The port's bench scene holds the JAX bench's arrays (no render)."""
    path = Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("jax_bench", path)
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jbase, jenv, jcam, jcfg = jbench.make_render_scene()
    tbase, tenv_, tcam_, tcfg = tbench.make_render_scene("cpu")
    for jp, tp in ((jbase, tbase), (jenv, tenv_)):
        assert tp.max_sh_degree == jp.max_sh_degree
        for k in tg.STATIC_FIELDS:
            np.testing.assert_allclose(getattr(tp.params, k).numpy(),
                                       np.asarray(getattr(jp.params, k)),
                                       atol=1e-6, err_msg=k)
        for k in tp.stats._fields:
            np.testing.assert_array_equal(getattr(tp.stats, k).numpy(),
                                          np.asarray(getattr(jp.stats, k)))
    assert (tcam_.H, tcam_.W) == (jcam.H, jcam.W)
    for k in ("K", "R", "T"):
        np.testing.assert_array_equal(getattr(tcam_, k).numpy(),
                                      np.asarray(getattr(jcam, k)))
    assert (tcfg.pair_cap, tcfg.env_pair_cap, tcfg.render_mode) == (
        jcfg.pair_cap, jcfg.env_pair_cap, jcfg.render_mode)


def test_make_train_scene_matches_jax():
    """The port's train bench scene holds the arrays of the JAX package's
    bench.py::main_train: its numpy draws, in its order (the pools, then the
    batch image), repeated here on the JAX side; no step is run. The caps
    are the port's non-truncating ones."""
    from envgs_tpu.models.gaussians import logit

    H, W, P, Pe = 1038, 1558, 500_000, 131_072
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 1.5,
                          rng.random((P, 1)) * 5 + 2.0], -1).astype(np.float32)
    jbase = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=P,
                        sh_degree=3, init_opacity=0.8)
    jbase = jbase._replace(params=jbase.params._replace(
        scaling=jnp.full((P, 2), np.log(0.012)),
        specular=jnp.full((P, 1), float(logit(jnp.asarray(0.3))))))
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jenv = create_pool((dirs * 20).astype(np.float32),
                       rng.random((Pe, 3)).astype(np.float32), cap=Pe,
                       sh_degree=3, init_opacity=0.8)
    jenv = jenv._replace(params=jenv.params._replace(
        scaling=jnp.full((Pe, 2), np.log(0.5))))
    rgb = rng.random((H, W, 3)).astype(np.float32)

    tbase, tenv_, tcam_, tcfg, batch = tbench.make_train_scene("cpu")
    for jp, tp in ((jbase, tbase), (jenv, tenv_)):
        for k in tg.STATIC_FIELDS:
            np.testing.assert_allclose(getattr(tp.params, k).numpy(),
                                       np.asarray(getattr(jp.params, k)),
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(tp.stats.active.numpy(),
                                      np.asarray(jp.stats.active))
    np.testing.assert_array_equal(batch.rgb.numpy(), rgb)
    assert float(batch.msk.min()) == 1.0 and float(batch.norm.abs().max()) == 0
    assert (tcam_.H, tcam_.W) == (H, W)
    np.testing.assert_allclose(tcam_.K.numpy()[0, 0], 0.9 * W)
    assert (tcfg.pair_cap, tcfg.env_pair_cap) == (2 ** 21, 2 ** 22)
    assert tcfg.reflection_start_iter == 0 and not tcfg.render_mode


def test_port_imports_no_jax():
    """envgs_tpu_torch and all its submodules import neither jax nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import envgs_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'envgs_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 15  # every module was imported


def test_unported_configurations_raise():
    """The two configurations once refused (a traced base pass, a second
    bounce) render: rgb, acc, depth and env rgb within ATOL of JAX's at
    16 x 16 (the tests of tests/test_torch_base_tracing.py go further)."""
    H = W = 16
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    xyz, col, exyz, ecol = _inputs(seed=5, P=60, Pe=100)
    jb = create_pool(xyz, col, cap=64, sh_degree=3, init_opacity=0.6)
    je = create_pool(exyz, ecol, cap=128, sh_degree=3, init_opacity=0.6)
    tb = tg.create_pool(xyz, col, cap=64, sh_degree=3, init_opacity=0.6)
    te = tg.create_pool(exyz, ecol, cap=128, sh_degree=3, init_opacity=0.6)
    for extra in (dict(use_base_tracing=True), dict(max_trace_depth=1)):
        kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 12,
                  reflection_start_iter=0, render_mode=True, **extra)
        jcfg = EnvGSConfig(raster_backend="pallas_interp",
                           tracer_backend="tiled_interp", **kw)
        want = jax.jit(lambda b, e: forward_envgs(
            b, e, make_camera(H, W, K, eye, zero), jnp.asarray(10),
            jcfg))(jb, je)
        got = tenv.forward_envgs(tb, te, tcam.make_camera(H, W, K, eye, zero),
                                 10, tenv.EnvGSConfig(**kw))
        for k in ("rgb_map", "acc_map", "dpt_map", "env_rgb_map"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       atol=ATOL, err_msg=f"{extra} {k}")
        assert float(got.acc_map.max()) > 0.5

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
        for k in tp.params._fields:
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
    cam = tcam.make_camera(16, 16, np.eye(3, dtype=np.float32),
                           np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
    pool = tg.create_pool(np.zeros((1, 3), np.float32), None, cap=2)
    for cfg in (tenv.EnvGSConfig(use_base_tracing=True),
                tenv.EnvGSConfig(max_trace_depth=1)):
        with pytest.raises(NotImplementedError):
            tenv.forward_envgs(pool, pool, cam, 0, cfg)

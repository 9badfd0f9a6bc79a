"""Parity of the port's traced base pass (`use_base_tracing`) and
multi-bounce tracing (`max_trace_depth > 0`) with the JAX package:
trace_rays_multibounce at depths 0 and 1 (the tiled tracer and the `ref`
oracle), the mirror and red wall of tests/test_base_tracing.py,
forward_envgs in render mode and its gradients in training mode, and one
train step with a traced base (the (P, 3) world-space hook, the stats
without a raster pair count).

The JAX side runs its Pallas kernels in interpret mode; the port its plain
versions. Scenes: 150 base and 200 env surfels seen at 32 x 32, a dome of
96 surfels around 16 x 16 rays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.ops import tracer as jtr
from envgs_tpu.ops.tracer_ref import prepare_trace_scene
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.ops import tracer as ttr
from envgs_tpu_torch.ops.tracer_ref import \
    prepare_trace_scene as t_prepare_trace_scene
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam
from tests.test_torch_envgs import _inputs
from tests.test_torch_train_step import LOSS_CFG, _jax_state_to_numpy

H = W = 32
F = 40.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
EYE, ZERO = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
# maps: two blends (or a blend and its bounce) chained through the rays, as
# test_torch_envgs.py holds forward_envgs
ATOL = 1e-4
# gradients and arrays derived from them: per array max|d| / max|ref|
GRAD_RTOL = 5e-4
# the per-splat wet, a sum of up to a few hundred weights: 1e-5 of the
# largest
WET_RTOL = 1e-5
MAPS = ("rgb_map", "spec_map", "rough_map", "acc_map", "dpt_map",
        "norm_map", "dist_map", "surf_norm_map", "env_rgb_map")
JAX_BACKENDS = {"tiled": ("pallas_interp", "tiled_interp"),
                "ref": ("ref", "ref")}
SPEC = np.linspace(-3, 2, 160, dtype=np.float32)[:, None]


def _pools():
    xyz, col, exyz, ecol = _inputs()
    jb = create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    jb = jb._replace(params=jb.params._replace(specular=jnp.asarray(SPEC)))
    je = create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    tb = tg.create_pool(xyz, col, cap=160, sh_degree=3, init_opacity=0.6)
    tb = tb._replace(params=tb.params._replace(specular=torch.tensor(SPEC)))
    te = tg.create_pool(exyz, ecol, cap=256, sh_degree=3, init_opacity=0.6)
    return (jb, je), (tb, te)


def _cfgs(backend, **kw):
    kw = dict(pair_cap=2 ** 14, env_pair_cap=2 ** 13,
              reflection_start_iter=0, **kw)
    raster, tracer = JAX_BACKENDS[backend]
    port = ("pallas", "tiled") if backend == "tiled" else ("ref", "ref")
    return (jenv.EnvGSConfig(raster_backend=raster, tracer_backend=tracer,
                             **kw),
            tenv.EnvGSConfig(raster_backend=port[0], tracer_backend=port[1],
                             **kw))


def _close_rel(got, want, rtol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (name, err)


def _dome(P=96, seed=0):
    """The env-like dome of tests/test_base_tracing.py, with specular and
    roughness drawn for the bounces."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    arrays = ((dirs * 6.0).astype(np.float32),
              np.concatenate([np.ones((P, 1)), rng.normal(size=(P, 3)) * 0.2],
                             -1).astype(np.float32),
              np.full((P, 2), 0.8, np.float32),
              np.full((P,), 0.7, np.float32),
              rng.random((P, 3)).astype(np.float32),
              rng.random((P, 2)).astype(np.float32))
    js = prepare_trace_scene(*map(jnp.asarray, arrays[:5]),
                             aux=jnp.asarray(arrays[5]))
    ts = t_prepare_trace_scene(*map(torch.tensor, arrays[:5]),
                               aux=torch.tensor(arrays[5]))
    return js, ts


@pytest.mark.parametrize("backend", ["tiled", "ref"])
@pytest.mark.parametrize("depth", [0, 1])
def test_multibounce_matches_jax(depth, backend):
    """trace_rays_multibounce on the dome from rays inside it: the
    composited output and every bounce's within ATOL (wet within WET_RTOL)
    of JAX's; with depth 1 some rays bounce and the composite differs from
    bounce 0. The rays start off the dome's centre: from the centre every
    surfel lies at one distance, and the tiled tracer's radial order would
    rest on the last bits of that distance."""
    js, ts = _dome()
    rng = np.random.default_rng(2)
    d = rng.normal(size=(16, 16, 3)).astype(np.float32)
    o = np.broadcast_to(np.float32([0.7, -0.4, 0.3]), (16, 16, 3)).copy()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    thr = 0.3
    jb = "ref" if backend == "ref" else "tiled_interp"
    jout, jmids = jax.jit(lambda s: jtr.trace_rays_multibounce(
        s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(bg),
        max_trace_depth=depth, specular_threshold=thr, backend=jb))(js)
    out, mids = ttr.trace_rays_multibounce(
        ts, torch.tensor(o), torch.tensor(d), torch.tensor(bg),
        max_trace_depth=depth, specular_threshold=thr, backend=backend)
    assert len(mids) == len(jmids) == depth + 1
    for got, want in [(out, jout)] + list(zip(mids, jmids)):
        for k in ("rgb", "dpt", "acc", "norm", "aux", "trans"):
            # ATOL of each array's largest value, at least ATOL: the second
            # bounce starts at o + t d of the first, so its errors scale
            # with the ray parameters (up to 9 here)
            want_k = np.asarray(getattr(want, k))
            np.testing.assert_allclose(
                getattr(got, k).numpy(), want_k,
                atol=ATOL * max(1.0, float(np.abs(want_k).max())), err_msg=k)
        _close_rel(got.wet.numpy(), want.wet, WET_RTOL, "wet")
    if depth:
        assert float((out.rgb - mids[0].rgb).abs().max()) > 0.05
        assert float(mids[1].acc.max()) > 0.5


@pytest.mark.parametrize("backend", ["tiled", "ref"])
def test_multibounce_reflects_the_red_wall(backend):
    """tests/test_base_tracing.py's mirror: a fully specular plane ahead
    of a ray reflects it onto a red wall behind its origin; the composite
    is the wall's red, as JAX's oracle gives it."""
    arrays = ([[0, 0, 2.0], [0, 0, -2.0]], [[1, 0, 0, 0], [1, 0, 0, 0]],
              [[4.0, 4.0], [4.0, 4.0]], [0.999, 0.999],
              [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], [[1.0, 0.0], [0.0, 0.0]])
    arrays = [np.asarray(a, np.float32) for a in arrays]
    ts = t_prepare_trace_scene(*map(torch.tensor, arrays[:5]),
                               aux=torch.tensor(arrays[5]))
    js = prepare_trace_scene(*map(jnp.asarray, arrays[:5]),
                             aux=jnp.asarray(arrays[5]))
    o = np.zeros((1, 1, 3), np.float32)
    d = np.array([[[0.0, 0.0, 1.0]]], np.float32)
    out, mids = ttr.trace_rays_multibounce(
        ts, torch.tensor(o), torch.tensor(d), torch.zeros(3),
        max_trace_depth=1, specular_threshold=0.5, backend=backend)
    jout, _ = jtr.trace_rays_multibounce(
        js, jnp.asarray(o), jnp.asarray(d), jnp.zeros(3), max_trace_depth=1,
        specular_threshold=0.5, backend="ref")
    assert len(mids) == 2
    rgb = out.rgb.numpy()[0, 0]
    assert rgb[0] > 0.5 and rgb[1] < 0.1 and rgb[2] < 0.1, rgb
    np.testing.assert_allclose(rgb, np.asarray(jout.rgb)[0, 0], atol=ATOL)


@pytest.mark.parametrize("extra,backend", [
    (dict(use_base_tracing=True), "tiled"),
    (dict(use_base_tracing=True), "ref"),
    (dict(max_trace_depth=1), "tiled"),
    (dict(use_base_tracing=True, max_trace_depth=1), "tiled")],
    ids=["traced base", "traced base, ref", "two bounces",
         "traced base, two bounces"])
def test_forward_envgs_render_matches_jax(extra, backend):
    """forward_envgs in render mode: every map within ATOL of JAX's, the
    per-splat wet within WET_RTOL, visibility and the env counters equal;
    a traced base pass has no raster pair count."""
    (jb, je), (tb, te) = _pools()
    jcfg, tcfg = _cfgs(backend, render_mode=True, **extra)
    want = jax.jit(lambda b, e: jenv.forward_envgs(
        b, e, make_camera(H, W, K, EYE, ZERO), jnp.asarray(10), jcfg))(jb, je)
    got = tenv.forward_envgs(tb, te, tcam.make_camera(H, W, K, EYE, ZERO), 10,
                             tcfg)
    for k in MAPS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=ATOL,
                                   err_msg=k)
    for k in ("base_wet", "env_wet"):
        _close_rel(getattr(got, k).numpy(), getattr(want, k), WET_RTOL, k)
    for k in ("base_visibility", "env_visibility"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    assert (got.base_num_pairs is None) == extra.get("use_base_tracing",
                                                     False)
    assert int(got.env_dropped_pairs) == int(want.env_dropped_pairs) == 0
    assert float(got.acc_map.max()) > 0.9
    assert float(got.env_acc_map.max()) > 0.5


@pytest.mark.parametrize("depth", [0, 1])
def test_traced_base_gradients_match_jax(depth):
    """forward_envgs in training mode with a traced base (and, at depth 1,
    two bounces): the gradients of a random weighting of every map with
    respect to both pools' parameters and the four zeros hooks within
    GRAD_RTOL of JAX's. The chain: the env blend's ray gradients reach the
    traced base's depth and normal, whose own backward reaches the base
    surfels; the (P, 3) hook is a world-space shift of the base means."""
    (jb, je), (tb, te) = _pools()
    jcfg, tcfg = _cfgs("tiled", use_base_tracing=True, max_trace_depth=depth)
    rng = np.random.default_rng(5)
    shapes = {"rgb_map": 3, "spec_map": 1, "rough_map": 1, "acc_map": 1,
              "dpt_map": 1, "norm_map": 3, "dist_map": 1, "surf_norm_map": 3,
              "env_rgb_map": 3}
    wts = {k: rng.normal(size=(H, W, c)).astype(np.float32)
           for k, c in shapes.items()}
    jcam = make_camera(H, W, K, EYE, ZERO)

    def jloss(bp, ep, *hooks):
        out = jenv.forward_envgs(jb._replace(params=bp),
                                 je._replace(params=ep), jcam,
                                 jnp.asarray(10), jcfg, *hooks)
        return sum(jnp.sum(getattr(out, k) * w) for k, w in wts.items())

    hooks = [jnp.zeros((160, 3)), jnp.zeros((256, 3)), jnp.zeros(160),
             jnp.zeros(256)]
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        jb.params, je.params, *hooks)

    leaf = lambda x: x.detach().requires_grad_(True)  # noqa: E731
    bp = tg.map_params(leaf, tb.params)
    ep = tg.map_params(leaf, te.params)
    thooks = [torch.zeros(np.shape(h), requires_grad=True) for h in hooks]
    out = tenv.forward_envgs(tb._replace(params=bp), te._replace(params=ep),
                             tcam.make_camera(H, W, K, EYE, ZERO), 10, tcfg,
                             *thooks)
    loss = sum(torch.sum(getattr(out, k) * torch.tensor(w))
               for k, w in wts.items())
    leaves = [*tg.present(bp), *tg.present(ep), *thooks]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    fields = tg.STATIC_FIELDS  # the temporal ones are None
    want = ([getattr(jg[0], f) for f in fields]
            + [getattr(jg[1], f) for f in fields] + list(jg[2:]))
    names = ([f"base.{f}" for f in fields] + [f"env.{f}" for f in fields]
             + ["means3d", "env_means3d", "wet", "env_wet"])
    for name, g, w in zip(names, grads, want):
        g = np.zeros(np.shape(w)) if g is None else g.numpy()
        _close_rel(g, w, GRAD_RTOL, name)
    assert float(np.abs(np.asarray(jg[2])).max()) > 0  # the hook's gradient
    assert float(np.abs(np.asarray(jg[0].roughness)).max()) > 0


def test_train_step_with_traced_base_matches_jax():
    """One make_train_step with use_base_tracing from the same numpy state
    (fresh Adam moments): the hook is (P, 3); the stats carry no
    pair_overflow (the trace's dropped slots go unreported, as in JAX) and
    equal JAX's (loss terms within 1e-4); the gradients, read back from
    JAX's first moment, within GRAD_RTOL of the port's (`grads_out`); the
    densification statistics the step gathers within GRAD_RTOL, the visit
    counts equal."""
    (jb, je), _ = _pools()
    state = jtrain.init_train_state(jb, je, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    rgb, msk, nrm = (rng.random((H, W, 3)).astype(np.float32),
                     (rng.random((H, W, 1)) > 0.1).astype(np.float32),
                     rng.random((H, W, 3)).astype(np.float32))
    jcfg, tcfg = _cfgs("tiled", use_base_tracing=True)
    jcam = make_camera(H, W, K, EYE, ZERO)
    jstep = jtrain.make_train_step(
        jcam, jcfg, jsup.LossConfig(**LOSS_CFG), jopt.LRConfig(),
        jopt.LRConfig(), donate=False, has_norm=True)
    jnew, jstats = jstep(state, jtrain.Batch(*map(jnp.asarray,
                                                  (rgb, msk, nrm))),
                         jcam.K, jcam.R, jcam.T, jnp.asarray(25000))

    start = _jax_state_to_numpy(state)
    cam = tcam.make_camera(H, W, K, EYE, ZERO)
    tstep = ttrain.make_train_step(cam, tcfg, tsup.LossConfig(**LOSS_CFG),
                                   topt.LRConfig(), topt.LRConfig(),
                                   has_norm=True)
    grads = {}
    tnew, tstats = tstep(ttrain.state_from_numpy(start),
                         ttrain.Batch(*map(torch.tensor, (rgb, msk, nrm))),
                         cam.K, cam.R, cam.T, 25000, grads_out=grads)
    # the port's count of the env chunks its per-tile cap cut: none here
    assert set(tstats) == set(jstats) | {"trace_cut"}
    assert "pair_overflow" not in tstats
    assert int(tstats.pop("trace_cut")) == 0
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, err_msg=k)
    assert grads["means2d"].shape == (160, 3)
    got, want = ttrain.state_to_numpy(tnew), _jax_state_to_numpy(jnew)
    for pool in ("base", "env"):
        for k, mu in want[pool]["mu"].items():
            gj = np.asarray(mu, np.float64) / 0.1  # mu' = 0.1 g from mu = 0
            gt = getattr(grads[pool], k).numpy()
            _close_rel(gt, gj, GRAD_RTOL, f"{pool}.{k}")
        np.testing.assert_array_equal(got[pool]["stats"]["denom"],
                                      want[pool]["stats"]["denom"])
        for k in ("grad_accum", "weight_accum"):
            _close_rel(got[pool]["stats"][k], want[pool]["stats"][k],
                       GRAD_RTOL, f"{pool}.{k}")
    assert float(np.abs(want["base"]["mu"]["xyz"]).max()) > 0

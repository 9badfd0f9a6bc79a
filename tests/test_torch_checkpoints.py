"""Checkpoints and plys cross between the packages: a file written by the
JAX package loads in the port and renders the same image, and the
reverse; the port's own round trip keeps the camera state and the
generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.train import checkpoints as jckpt
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.train import checkpoints as tckpt
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam

H, W, f = 32, 48, 50.0
K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
EYE, ZERO = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
CAPS = (160, 256)
KW = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0,
          render_mode=True)
# two blends in a row and the reflected-ray chain between them, the bound
# the render parity tests hold
ATOL = 1e-5


def _jax_state(seed=0, P=150, Pe=200):
    """A train state with holes in both pools' active masks, a raised SH
    degree and non-zero moments, so that compaction, padding and every
    array of the file matter."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32),
                       cap=CAPS[0], sh_degree=2, init_opacity=0.6)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=CAPS[1],
                      sh_degree=2, init_opacity=0.6)

    def holes(pool):
        act = np.asarray(pool.stats.active) & (rng.random(pool.cap) > 0.2)
        rest = rng.normal(size=pool.params.features_rest.shape) * 0.1
        return pool._replace(
            params=pool.params._replace(
                features_rest=jnp.asarray(rest.astype(np.float32))),
            stats=pool.stats._replace(active=jnp.asarray(act),
                                      sh_degree=jnp.asarray(1, jnp.int32),
                                      denom=jnp.asarray(
                                          rng.integers(0, 3, pool.cap)
                                          .astype(np.float32))))

    state = jtrain.init_train_state(holes(base), holes(env),
                                    jax.random.PRNGKey(7))
    like = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), t)
    return state._replace(
        opt_base=state.opt_base._replace(mu=like(state.base.params),
                                         step=jnp.asarray(12, jnp.int32)),
        opt_env=state.opt_env._replace(nu=like(state.env.params)))


def _active_rows(pool):
    act = np.asarray(pool.stats.active)
    return {k: np.asarray(v)[act] for k, v in pool.params._asdict().items()
            if v is not None}


def _torch_rows(pool):
    act = pool.stats.active.numpy()
    return {k: v.numpy()[act] for k, v in pool.params._asdict().items()
            if v is not None}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """JAX writes -> the port loads: active rows, moments, steps, SH degree
    and iteration equal, and the port's render of the loaded state within
    ATOL of JAX's render of the saved one. The port writes -> JAX loads:
    the same arrays back, and JAX renders the same image again."""
    state = _jax_state()
    jpath = str(tmp_path / "jax" / "latest.npz")
    jckpt.save_checkpoint(jpath, state, 321)

    jcam = make_camera(H, W, K, EYE, ZERO)
    jcfg = jenv.EnvGSConfig(raster_backend="pallas_interp",
                            tracer_backend="tiled_interp", **KW)
    jrender = jax.jit(lambda b, e: jenv.forward_envgs(
        b, e, jcam, jnp.asarray(10), jcfg).rgb_map)
    want = np.asarray(jrender(state.base, state.env))
    assert want.std() > 0.05

    tstate, it = tckpt.load_checkpoint(jpath, *CAPS, device="cpu")
    assert it == 321 and int(tstate.opt_base.step) == 12
    assert tstate.gen is not None  # seeded from the JAX key
    for name in ("base", "env"):
        jp, tp = getattr(state, name), getattr(tstate, name)
        assert int(tp.stats.sh_degree) == 1 and tp.max_sh_degree == 2
        assert int(tp.stats.active.sum()) == int(jp.stats.active.sum())
        for k, v in _active_rows(jp).items():
            np.testing.assert_array_equal(_torch_rows(tp)[k], v, err_msg=k)
        act = np.asarray(jp.stats.active)
        np.testing.assert_array_equal(
            tp.stats.denom.numpy()[tp.stats.active.numpy()],
            np.asarray(jp.stats.denom)[act])
    np.testing.assert_array_equal(
        tstate.opt_base.mu.xyz.numpy()[tstate.base.stats.active.numpy()],
        np.asarray(state.opt_base.mu.xyz)[np.asarray(state.base.stats.active)])
    cam = tcam.make_camera(H, W, K, EYE, ZERO)
    got = tenv.forward_envgs(tstate.base, tstate.env, cam, 10,
                             tenv.EnvGSConfig(**KW)).rgb_map.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

    tpath = str(tmp_path / "torch" / "latest.npz")
    tckpt.save_checkpoint(tpath, tstate, 654)
    back, it = jckpt.load_checkpoint(tpath, *CAPS)
    assert it == 654 and int(back.opt_base.step) == 12
    for name in ("base", "env"):
        for k, v in _active_rows(getattr(state, name)).items():
            np.testing.assert_array_equal(
                _active_rows(getattr(back, name))[k], v, err_msg=k)
    np.testing.assert_allclose(np.asarray(jrender(back.base, back.env)), got,
                               atol=ATOL)


def test_plys_cross_between_the_packages(tmp_path):
    """export_ply of either package imports in the other with the same
    active rows of the six ply fields; the port's import fills the rest as
    create_pool does."""
    state = _jax_state(seed=1)
    tstate = ttrain.state_from_numpy(
        {"base": _bridge(state.base, state.opt_base),
         "env": _bridge(state.env, state.opt_env)})
    jply, tply = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jckpt.export_ply(state.base, jply)
    tckpt.export_ply(tstate.base, tply)
    with open(jply, "rb") as a, open(tply, "rb") as b:
        assert a.read() == b.read()
    n = int(np.asarray(state.base.stats.active).sum())
    tpool = tckpt.import_ply(jply, CAPS[0], sh_degree=2, device="cpu")
    jpool = jckpt.import_ply(tply, CAPS[0], sh_degree=2)
    assert int(tpool.stats.active.sum()) == n
    assert tpool.stats.active[:n].all() and int(tpool.stats.sh_degree) == 2
    want = _active_rows(state.base)
    for k in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation"):
        np.testing.assert_array_equal(_torch_rows(tpool)[k], want[k])
        np.testing.assert_array_equal(_active_rows(jpool)[k], want[k])
    for k in ("specular", "roughness"):
        np.testing.assert_array_equal(getattr(tpool.params, k).numpy(),
                                      np.asarray(getattr(jpool.params, k)))


def _bridge(pool, opt):
    arrays = lambda t: {k: np.asarray(v)  # noqa: E731
                        for k, v in t._asdict().items() if v is not None}
    return dict(params=arrays(pool.params), stats=arrays(pool.stats),
                mu=arrays(opt.mu), nu=arrays(opt.nu), step=int(opt.step),
                max_sh_degree=pool.max_sh_degree)


def test_port_round_trip_keeps_camera_state_and_generator(tmp_path):
    """The port's own files: the camera residuals and their moments come
    back for a matching view count only; the generator resumes where it
    was (the next draws are the same), or from its seed when the state
    comes from another device type; find_latest prefers latest.npz, then
    the highest number; old numbered files rotate out."""
    state = _jax_state(seed=2)
    tstate = ttrain.state_from_numpy(
        {"base": _bridge(state.base, state.opt_base),
         "env": _bridge(state.env, state.opt_env)})
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)  # mid-stream
    tstate = tstate._replace(gen=gen)
    cam_state = ttrain.init_cam_opt(4)
    cam_state = cam_state._replace(res=cam_state.res._replace(
        se3=torch.arange(24, dtype=torch.float32).reshape(4, 6)))
    d = tmp_path / "exp"
    assert tckpt.find_latest(str(d)) is None
    for it in (10, 20, 30, 40):
        tckpt.save_checkpoint(str(d / f"{it}.npz"), tstate, it,
                              cam_state=cam_state)
    assert sorted(p.name for p in d.iterdir()) == ["20.npz", "30.npz",
                                                   "40.npz"]
    assert tckpt.find_latest(str(d)).endswith("40.npz")
    tckpt.save_checkpoint(str(d / "latest.npz"), tstate, 41)
    assert tckpt.find_latest(str(d)).endswith("latest.npz")

    back, it, cs = tckpt.load_checkpoint(str(d / "40.npz"), *CAPS, n_views=4,
                                         device="cpu")
    assert it == 40
    assert torch.equal(cs.res.se3, cam_state.res.se3)
    assert cs.opt.step.dtype == torch.int32
    assert torch.equal(torch.rand(5, generator=back.gen),
                       torch.rand(5, generator=gen))
    # a state saved on another device type cannot resume: the stream
    # restarts from the saved seed
    foreign = dict(ttrain.generator_to_numpy(gen),
                   gen_device=np.asarray("cuda"))
    restarted = ttrain.generator_from_numpy(foreign, "cpu")
    assert torch.equal(torch.rand(3, generator=restarted),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
    assert tckpt.load_checkpoint(str(d / "40.npz"), *CAPS, n_views=3,
                                 device="cpu")[2] is None
    assert tckpt.load_checkpoint(str(d / "latest.npz"), *CAPS, n_views=4,
                                 device="cpu")[2] is None
    with pytest.raises(ValueError, match="capacity"):
        tckpt.load_checkpoint(str(d / "40.npz"), 8, 8, device="cpu")

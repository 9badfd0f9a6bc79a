"""Parity of the port's camera optimisation with the JAX package: the
residual maps (`so3_exp`, `apply_residual`) with their gradients, and one
train step with `cam_opt.enabled`."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from envgs_tpu.models import camera_opt as jco
from envgs_tpu.models import envgs as jenv
from envgs_tpu.models.gaussians import create_pool
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera
from envgs_tpu_torch.models import camera_opt as tco
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.utils import camera as tcam

H, W, f = 32, 48, 50.0
K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
R0 = np.array([[0.8, 0.6, 0], [-0.6, 0.8, 0], [0, 0, 1]], np.float32)
T0 = np.array([0.1, -0.2, 0.3], np.float32)


def test_apply_residual_matches_jax():
    """K, R, T of a view under a residual (one beyond the intrinsic clip)
    within 1e-6, and the gradient of a weighted sum of them with respect
    to the residuals within 1e-5; at the zero residual the rotation is the
    identity and its gradient is finite (the Taylor branch)."""
    rng = np.random.default_rng(0)
    se3 = (rng.normal(size=(3, 6)) * 0.05).astype(np.float32)
    intr = (rng.normal(size=(3, 4)) * 0.04).astype(np.float32)
    se3[2], intr[2], intr[1, 0] = 0.0, 0.0, 0.2  # view 2: zero; past the clip
    wk, wr, wt = (rng.normal(size=s).astype(np.float32)
                  for s in ((3, 3), (3, 3), (3,)))
    jcam = make_camera(H, W, K, R0, T0)
    cam = tcam.make_camera(H, W, K, R0, T0)
    for view in range(3):
        def jloss(se3_, intr_):
            c = jco.apply_residual(jcam, jco.CameraResiduals(se3_, intr_),
                                   view)
            return (jnp.sum(c.K * wk) + jnp.sum(c.R * wr)
                    + jnp.sum(c.T * wt)), c

        (_, jc), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(se3), jnp.asarray(intr))
        tres = tco.CameraResiduals(torch.tensor(se3, requires_grad=True),
                                   torch.tensor(intr, requires_grad=True))
        c = tco.apply_residual(cam, tres, view)
        for k in ("K", "R", "T"):
            np.testing.assert_allclose(getattr(c, k).detach().numpy(),
                                       np.asarray(getattr(jc, k)), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        loss = (torch.sum(c.K * torch.tensor(wk))
                + torch.sum(c.R * torch.tensor(wr))
                + torch.sum(c.T * torch.tensor(wt)))
        for got, want in zip(torch.autograd.grad(loss, tres), jg):
            assert torch.isfinite(got).all()
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c.R.detach().numpy(), R0)  # view 2: zero
    assert float(c.K.detach()[0, 0]) == f  # and its intrinsics untouched
    assert (H, W) == (c.H, c.W)


def _scene(rng, P=120, Pe=160):
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.6,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    dirs = rng.normal(size=(Pe, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    base = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=128,
                       sh_degree=1, init_opacity=0.6)
    env = create_pool((dirs * 8).astype(np.float32),
                      rng.random((Pe, 3)).astype(np.float32), cap=192,
                      sh_degree=1, init_opacity=0.6)
    return jtrain.init_train_state(base, env, jax.random.PRNGKey(0))


def _to_numpy(state):
    def pool(p, opt):
        arrays = lambda t: {k: np.asarray(v)  # noqa: E731
                            for k, v in t._asdict().items() if v is not None}
        return dict(params=arrays(p.params), stats=arrays(p.stats),
                    mu=arrays(opt.mu), nu=arrays(opt.nu), step=int(opt.step),
                    max_sh_degree=p.max_sh_degree)
    return {"base": pool(state.base, state.opt_base),
            "env": pool(state.env, state.opt_env)}


def test_cam_opt_step_matches_jax():
    """One train step with camera optimisation on view 1 of 3, from one
    numpy state and mid-run camera moments: the loss within 1e-4, the
    camera gradient (read back from the first moment) and the new residuals
    (their change) within 5e-4 of each array's max, the untouched views'
    rows unchanged; intrinsics frozen by `freeze_intri` on both sides."""
    rng = np.random.default_rng(2)
    state = _scene(rng)
    rgb = rng.random((H, W, 3)).astype(np.float32)
    msk = np.ones((H, W, 1), np.float32)
    nrm = np.zeros((H, W, 3), np.float32)
    res = dict(se3=(rng.normal(size=(3, 6)) * 1e-3).astype(np.float32),
               intr=(rng.normal(size=(3, 4)) * 1e-3).astype(np.float32))
    mu = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
          for k, v in res.items()}
    nu = {k: (rng.random(v.shape) * 1e-5 + 1e-6).astype(np.float32)
          for k, v in res.items()}
    kw = dict(pair_cap=2 ** 12, env_pair_cap=2 ** 13, reflection_start_iter=0)
    loss_kw = dict(perc_loss_weight=0.0)
    co = dict(enabled=True, extri_lr=1e-3, intri_lr=1e-4, freeze_intri=True)

    jcam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))
    jres = lambda d: jco.CameraResiduals(  # noqa: E731
        jnp.asarray(d["se3"]), jnp.asarray(d["intr"]))
    jcs = jtrain.CamOptState(jres(res), jopt.AdamState(
        jres(mu), jres(nu), jnp.asarray(10, jnp.int32)))
    jstep = jtrain.make_train_step(
        jcam, jenv.EnvGSConfig(raster_backend="pallas_interp",
                               tracer_backend="tiled_interp", **kw),
        jsup.LossConfig(**loss_kw), jopt.LRConfig(), jopt.LRConfig(),
        donate=False, cam_opt=jtrain.CamOptConfig(**co))
    _, jnew, jstats = jstep(
        state, jcs, jtrain.Batch(*map(jnp.asarray, (rgb, msk, nrm))), jcam.K,
        jcam.R, jcam.T, jnp.asarray(1), jnp.asarray(25000))

    cam = tcam.make_camera(H, W, K, np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
    tres = lambda d: tco.CameraResiduals(  # noqa: E731
        torch.tensor(d["se3"]), torch.tensor(d["intr"]))
    tcs = ttrain.CamOptState(tres(res), topt.AdamState(
        tres(mu), tres(nu), torch.tensor(10, dtype=torch.int32)))
    tstep = ttrain.make_train_step(
        cam, tenv.EnvGSConfig(**kw), tsup.LossConfig(**loss_kw),
        topt.LRConfig(), topt.LRConfig(),
        cam_opt=ttrain.CamOptConfig(**co))
    grads = {}
    _, tnew, tstats = tstep(
        ttrain.state_from_numpy(_to_numpy(state)), tcs,
        ttrain.Batch(*map(torch.tensor, (rgb, msk, nrm))), cam.K, cam.R,
        cam.T, 1, 25000, grads_out=grads)

    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                               rtol=1e-4)
    assert int(tnew.opt.step) == int(jnew.opt.step) == 11

    def close(got, want, name):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 5e-4 * scale, (
            name, np.abs(got - want).max(), scale)

    # the gradient, recovered from JAX's first moment: mu' = .9 mu + .1 g
    jgrad = (np.asarray(jnew.opt.mu.se3) - 0.9 * mu["se3"]) / 0.1
    close(grads["cam"].se3.numpy()[1], jgrad[1], "se3 gradient")
    assert np.abs(jgrad[1]).max() > 0
    close(tnew.res.se3.numpy() - res["se3"],
          np.asarray(jnew.res.se3) - res["se3"], "se3 update")
    close(tnew.opt.nu.se3.numpy() - nu["se3"],
          np.asarray(jnew.opt.nu.se3) - nu["se3"], "se3 second moment")
    for got, want, start in ((tnew.res, jnew.res, res),
                             (tnew.opt.mu, jnew.opt.mu, mu)):
        np.testing.assert_array_equal(got.se3.numpy()[[0, 2]],
                                      start["se3"][[0, 2]])
        np.testing.assert_array_equal(np.asarray(want.se3)[[0, 2]],
                                      start["se3"][[0, 2]])
        np.testing.assert_array_equal(got.intr.numpy(), start["intr"])
        np.testing.assert_array_equal(np.asarray(want.intr), start["intr"])
    assert not grads["cam"].intr.any()

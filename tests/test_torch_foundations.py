"""Parity of the port's foundations (envgs_tpu_torch.utils, the pool, and
prepare_splats) with the JAX package on the same seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussians as jg
from envgs_tpu.ops import common as jcommon
from envgs_tpu.utils import camera as jcam
from envgs_tpu.utils import sh as jsh
from envgs_tpu.utils import transforms as jtr
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.ops import common as tcommon
from envgs_tpu_torch.utils import camera as tcam
from envgs_tpu_torch.utils import sh as tsh
from envgs_tpu_torch.utils import transforms as ttr


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def _cams(H=40, W=56, yaw=0.3):
    """The same camera in both packages: off-center principal point, a
    rotation and a translation."""
    K = np.array([[60.0, 0, W / 2 + 3.5], [0, 58.0, H / 2 - 2.0], [0, 0, 1]],
                 np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T = np.array([0.1, -0.2, 0.3], np.float32)
    return jcam.make_camera(H, W, K, R, T), tcam.make_camera(H, W, K, R, T)


def test_transforms():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    _close(ttr.quat_to_rotmat(torch.tensor(q)), jtr.quat_to_rotmat(q), 1e-6)
    _close(ttr.normalize(torch.tensor(n)), jtr.normalize(n), 1e-6)
    nn = np.asarray(jtr.normalize(n))
    _close(ttr.reflect(torch.tensor(d), torch.tensor(nn)),
           jtr.reflect(d, nn), 1e-6)


def test_camera_and_get_rays():
    jc, tc = _cams()
    _close(tc.pix_from_world, jc.pix_from_world, 1e-5, 1e-6)
    _close(tc.center, jc.center, 1e-6)
    jo, jd = jcam.get_rays(jc, z_depth=True)
    to, td = tcam.get_rays(tc, z_depth=True)
    _close(to, jo, 1e-6)
    _close(td, jd, 1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_color(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, 16)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tsh.eval_sh_color(deg, torch.tensor(sh), torch.tensor(d)),
           jsh.eval_sh_color(deg, sh, d), 1e-6)
    _close(tsh.sh_basis(deg, torch.tensor(d)), jsh.sh_basis(deg, d), 1e-6)


def test_create_pool_and_round_trip():
    """Same draws and layout; params equal to 1e-6 (logit and rgb2sh0 round
    in f32 in both); stats exact; the numpy bridge round-trips."""
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    rgb = rng.random((40, 3)).astype(np.float32)
    jp = jg.create_pool(xyz, rgb, cap=48, sh_degree=3, init_opacity=0.7,
                        seed=5)
    tp = tg.create_pool(xyz, rgb, cap=48, sh_degree=3, init_opacity=0.7,
                        seed=5)
    for k, v in jp.params._asdict().items():
        if v is not None:
            _close(getattr(tp.params, k), v, 1e-6)
    for k, v in jp.stats._asdict().items():
        np.testing.assert_array_equal(getattr(tp.stats, k).numpy(),
                                      np.asarray(v))
    params = {k: np.asarray(v) for k, v in jp.params._asdict().items()
              if v is not None}
    stats = {k: np.asarray(v) for k, v in jp.stats._asdict().items()}
    back_p, back_s = tg.pool_to_numpy(
        tg.pool_from_numpy(params, stats, jp.max_sh_degree))
    for k in params:
        np.testing.assert_array_equal(back_p[k], params[k])
    for k in stats:
        np.testing.assert_array_equal(back_s[k], stats[k])
    _close(tp.get_opacity, jp.get_opacity, 1e-6)


def test_prepare_splats():
    """Every field at atol/rtol 1e-5, valid exactly. The rowcull conic is
    compared from the same screen transforms: for thin edge-on surfels it
    is ill-conditioned, and the last-bit differences of the two packages'
    (P, 3) @ (3, 3) products (summation order) move it by up to ~1e-3
    relative, which its +1 pixel pad absorbs."""
    rng = np.random.default_rng(2)
    P = 200
    means = np.concatenate([rng.normal(size=(P, 2)) * 0.8,
                            rng.random((P, 1)) * 4.0 + 0.5],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    scales = (rng.random((P, 2)) * 0.25 + 0.02).astype(np.float32)
    opac = (rng.random(P) * 0.9 + 0.05).astype(np.float32)
    colors = rng.random((P, 5)).astype(np.float32)
    active = rng.random(P) > 0.1
    jc, tc = _cams()
    jp = jcommon.prepare_splats(means, quats, scales, opac, colors, jc,
                                active=jnp.asarray(active))
    tp = tcommon.prepare_splats(*map(torch.tensor, (means, quats, scales,
                                                    opac, colors)), tc,
                                active=torch.tensor(active))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert 0 < int(tp.valid.sum()) < P
    for k in jp._fields:
        if k not in ("valid", "rowcull"):
            _close(getattr(tp, k), getattr(jp, k), 1e-5, 1e-5)
    center, radius, valid, ext, rowcull = tcommon.screen_footprint(
        torch.tensor(np.asarray(jp.tmat)), tc)
    valid = valid & torch.tensor(active)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jp.valid))
    _close(rowcull, jp.rowcull, 1e-5, 1e-5)
    _close(center, jp.center_pix, 1e-5, 1e-5)
    _close(ext * valid[:, None], jp.ext, 1e-5, 1e-5)

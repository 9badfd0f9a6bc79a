"""The port's mesh export against the JAX package's: TSDF fusion, marching
tetrahedra, the visual hull, the mesh ply in both directions, the aux
datasets (GeometryDataset with carving, NoopDataset) item by item, and
Runner.extract_mesh on the same tiny scene.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fusion.py
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.data import aux_datasets as jds
from envgs_tpu.utils import fusion as jf
from envgs_tpu.utils.camera import make_camera as jcamera
from envgs_tpu_torch.data import aux_datasets as tds
from envgs_tpu_torch.utils import fusion as tf
from envgs_tpu_torch.utils.camera import make_camera as tcamera
from tests.test_fusion import R_SPHERE, _cams, _sphere_depth
from torch_threads import one_thread  # noqa: F401

BOUNDS = ((-0.7, -0.7, -0.7), (0.7, 0.7, 0.7))
VERT_ATOL = 1e-5  # world units; the interpolation is float64 in both


def _port_cams(cams):
    return [tcamera(c.H, c.W, np.asarray(c.K), np.asarray(c.R),
                    np.asarray(c.T), c.znear, c.zfar) for c in cams]


@pytest.fixture(scope="module")
def sphere():
    """Six 64x64 views of a sphere of radius 0.4 (tests/test_fusion.py),
    depth maps and masks, in both packages' cameras."""
    cams = _cams()
    depths = np.stack([_sphere_depth(c) for c in cams])
    return cams, _port_cams(cams), depths


@pytest.mark.parametrize("res", [24, 32])
def test_tsdf_fuse_matches_jax(sphere, res):
    """The TSDF within 1e-5 and the weights equal; the sign structure of
    the sphere (inside negative, corners positive)."""
    jcams, tcams, depths = sphere
    jt, jw = jf.tsdf_fuse(jnp.asarray(depths), jcams, BOUNDS, res=res)
    tt, tw = tf.tsdf_fuse(torch.tensor(depths), tcams, BOUNDS, res=res)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tt[res // 2, res // 2, res // 2]) < -0.5 and float(tt[1, 1, 1]) > 0.5


def _random_grid(res, seed):
    """A smooth random field with many crossings of 0 (every tetrahedron
    case) and an observed mask with holes."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(res, res, res)).astype(np.float32)
    for ax in range(3):  # a little smoothing: surfaces, not salt
        g = (g + np.roll(g, 1, ax) + np.roll(g, -1, ax)) / 3
    obs = rng.random((res, res, res)) > 0.05
    return g.astype(np.float32), obs


@pytest.mark.parametrize("which", ["sphere", "random", "random_observed",
                                   "random_level"])
def test_marching_tetrahedra_matches_jax(sphere, which):
    """The same grid through both: faces integer-equal, vertices (in the
    same order) within VERT_ATOL, with and without `observed` and bounds,
    at a non-zero level."""
    if which == "sphere":
        jcams, _, depths = sphere
        t, w = jf.tsdf_fuse(jnp.asarray(depths), jcams, BOUNDS, res=32)
        grid, obs, level, bounds = np.asarray(t), np.asarray(w) > 0, 0.0, BOUNDS
    else:
        grid, obs = _random_grid(20, seed=len(which))
        level, bounds = (0.1 if which == "random_level" else 0.0), None
        if which == "random":
            obs = None
    jv, jfaces = jf.marching_tetrahedra(grid, level, bounds=bounds,
                                        observed=obs)
    tv, tfaces = tf.marching_tetrahedra(
        torch.tensor(grid), level, bounds=bounds,
        observed=None if obs is None else torch.tensor(obs))
    assert len(jv) > 300
    np.testing.assert_array_equal(tfaces.numpy(), jfaces)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=VERT_ATOL)
    if which == "sphere":
        r = np.linalg.norm(tv.numpy(), axis=-1)
        assert abs(float(np.median(r)) - R_SPHERE) < 0.05


def test_marching_tetrahedra_of_a_flat_grid_is_empty():
    v, f = tf.marching_tetrahedra(torch.ones((8, 8, 8)))
    jv, jfaces = jf.marching_tetrahedra(np.ones((8, 8, 8), np.float32))
    assert v.shape == jv.shape == (0, 3) and f.shape == jfaces.shape == (0, 3)


@pytest.mark.parametrize("min_votes", [None, 4])
def test_visual_hull_matches_jax(sphere, min_votes):
    jcams, tcams, depths = sphere
    masks = (depths > 0).astype(np.float32)
    want = jf.visual_hull(jnp.asarray(masks), jcams, BOUNDS, res=40,
                          min_votes=min_votes)
    got = tf.visual_hull(torch.tensor(masks), tcams, BOUNDS, res=40,
                         min_votes=min_votes)
    assert len(want) > 100
    np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_ply_crosses_between_the_packages(tmp_path):
    """A ply written by either package reads back equal in the other (the
    writers print 6 decimals: the values compared are those)."""
    grid, obs = _random_grid(12, seed=9)
    v, f = jf.marching_tetrahedra(grid, 0.0, bounds=BOUNDS, observed=obs)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jf.save_mesh_ply(jpath, v, f)
    tf.save_mesh_ply(tpath, torch.tensor(v), torch.tensor(f))
    assert open(jpath).read() == open(tpath).read()
    for a, b in ((jf.load_mesh_ply(tpath), tf.load_mesh_ply(jpath)),
                 (tf.load_mesh_ply(tpath), jf.load_mesh_ply(jpath))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(tf.load_mesh_ply(tpath)[0], v, atol=5e-7)
    empty = str(tmp_path / "e.ply")
    tf.save_mesh_ply(empty, np.zeros((0, 3)), np.zeros((0, 3), np.int32))
    for got in (tf.load_mesh_ply(empty), jf.load_mesh_ply(empty)):
        assert got[0].shape == (0, 3) and got[1].shape == (0, 3)


def _items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_geometry_dataset_matches_jax():
    kw = dict(bounds=((-1, -1, -1), (1, 1, 1)), voxel_size=0.5, n_frames=3,
              duration=1.0, pad_to=200)
    got, want = tds.GeometryDataset(**kw), jds.GeometryDataset(**kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        _items_equal(got[i], want[i])
    np.testing.assert_array_equal(tds.create_meshgrid_3d(kw["bounds"], 0.3),
                                  jds.create_meshgrid_3d(kw["bounds"], 0.3))


def test_geometry_dataset_carving_matches_jax():
    """Space carving through visual_hull (tests/test_aux_datasets.py's two
    orthogonal views of a ball), padded and cut to pad_to."""
    H = W = 48
    f = 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    jc, masks = [], []
    for R, C in [(np.eye(3, dtype=np.float32), np.array([0, 0, -3.0])),
                 (np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32),
                  np.array([-3.0, 0, 0]))]:
        jc.append(jcamera(H, W, K, R, (-R @ C).astype(np.float32)))
        yy, xx = np.mgrid[0:H, 0:W]
        masks.append((np.hypot(xx - W / 2, yy - H / 2) < 10).astype(
            np.float32))
    for pad_to in (None, 64):
        kw = dict(bounds=((-1, -1, -1), (1, 1, 1)), voxel_size=0.1,
                  n_frames=2, use_space_carving_initialization=True,
                  masks=[masks, masks], pad_to=pad_to)
        want = jds.GeometryDataset(cameras=jc, **kw)
        got = tds.GeometryDataset(cameras=_port_cams(jc), **kw)
        for i in range(2):
            _items_equal(got[i], want[i])
        assert got[0]["valid"].sum() > 0


@pytest.mark.parametrize("kw", [
    dict(H=64, W=96, n_frames=4, orbit_n=8, duration=2.0),
    dict(cameras=[(np.eye(3), np.eye(3), np.ones(3))], n_frames=2)])
def test_noop_dataset_matches_jax(kw):
    got, want = tds.NoopDataset(**kw), jds.NoopDataset(**kw)
    assert len(got) == len(want)
    for i in range(len(want)):
        _items_equal(got[i], want[i])


def test_aux_datasets_are_registered():
    from envgs_tpu_torch.engine import DATASETS

    assert "GeometryDataset" in DATASETS and "NoopDataset" in DATASETS
    ds = DATASETS.build({"type": "NoopDataset", "H": 8, "W": 8, "orbit_n": 2})
    assert len(ds) == 2


def test_extract_mesh_matches_jax(tmp_path, one_thread):
    """Runner.extract_mesh of both packages on the synthetic scene's
    ground-truth pools (the same draws), three 32x32 views, the `ref`
    renderers, res 32: the same default bounds, equal faces, vertices
    within 1e-4 (the depths agree to float32 rounding: a vertex moves by
    the TSDF's difference over its slope), a ply each."""
    from envgs_tpu.data import synthetic as jsyn
    from envgs_tpu.models.envgs import EnvGSConfig as JCfg
    from envgs_tpu.models.gaussians import DensifyConfig as JDens
    from envgs_tpu.train.optimizer import LRConfig as JLR
    from envgs_tpu.train.runner import Runner as JRunner
    from envgs_tpu.train.supervisor import LossConfig as JLoss
    from envgs_tpu.train.trainer import ScheduleConfig as JSched
    from envgs_tpu_torch.data import synthetic as tsyn
    from envgs_tpu_torch.models.envgs import EnvGSConfig
    from envgs_tpu_torch.models.gaussians import DensifyConfig
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.runner import Runner
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.train.trainer import ScheduleConfig

    rgb = np.zeros((32, 32, 3), np.float32)
    cfg = dict(raster_backend="ref", tracer_backend="ref", pair_cap=2 ** 14,
               reflection_start_iter=0)
    jb, je = jsyn.make_gt_pools()
    jr = JRunner([dict(rgb=rgb, camera=c) for c in jsyn.make_cameras(3, 32, 32)],
                 jb, je, JCfg(**cfg), JLoss(), JSched(), JDens(), JDens(),
                 JLR(), JLR(), out_root=str(tmp_path / "j"), resume=False,
                 record=False)
    tb, te = tsyn.make_gt_pools(device="cpu")
    tr = Runner([dict(rgb=rgb, camera=c)
                 for c in tsyn.make_cameras(3, 32, 32, device="cpu")],
                tb, te, EnvGSConfig(**cfg), LossConfig(), ScheduleConfig(),
                DensifyConfig(), DensifyConfig(), LRConfig(), LRConfig(),
                out_root=str(tmp_path / "t"), resume=False, record=False)
    paths = [r.extract_mesh(res=32) for r in (jr, tr)]
    assert all(os.path.exists(p) for p in paths)
    (jv, jfaces), (tv, tfaces) = (tf.load_mesh_ply(p) for p in paths)
    assert len(jv) > 100
    np.testing.assert_array_equal(tfaces, jfaces)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)

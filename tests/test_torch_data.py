"""The port's real-data source against the JAX package's, on captures
written into tmp_path: the COLMAP readers (binary and text), the native
loader (the port builds its own library from native/loader.cpp),
MultiViewDataset item by item, the three branches of load_sfm and the
multiview branch of cli._load_views.

    python -m pytest tests/test_torch_data.py

`write_capture` is shared with tests/test_torch_moderators.py and
tests/test_torch_real_configs.py.
"""
import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

from envgs_tpu import cli as jcli
from envgs_tpu.data import dataset as jds
from envgs_tpu.data import native_loader as jnative
from envgs_tpu.engine import Config as JConfig
from envgs_tpu.utils import colmap as jcolmap
from envgs_tpu_torch import cli
from envgs_tpu_torch.data import dataset as tds
from envgs_tpu_torch.data import native_loader as tnative
from envgs_tpu_torch.data import synthetic
from envgs_tpu_torch.engine import Config
from envgs_tpu_torch.utils import colmap as tcolmap
from envgs_tpu_torch.utils.easycam import write_cameras
from envgs_tpu_torch.utils.ply import save_sfm_ply
from torch_threads import on_one_thread

CAM_ATOL = 1e-6
DISTORTION = np.array([0.05, -0.02, 0.001, -0.002, 0.003])


def _u8(a):
    return (np.clip(np.asarray(a), 0, 1) * 255 + 0.5).astype(np.uint8)


def write_colmap(sparse_dir, xyz, rgb, binary=True, cams=None):
    """A COLMAP model of the points (and, given `cams` as (K, R, T, H, W),
    one PINHOLE camera and image per view) in binary or text form."""
    os.makedirs(sparse_dir, exist_ok=True)
    C, I = tcolmap.ColmapCamera, tcolmap.ColmapImage
    ccams, ims = {}, {}
    for i, (K, R, T, H, W) in enumerate(cams or []):
        K = np.asarray(K, np.float64)
        ccams[i + 1] = C(i + 1, "PINHOLE", W, H,
                         np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
        ims[i + 1] = I(i + 1, tcolmap.rotmat_to_qvec(R),
                       np.asarray(T, np.float64).reshape(3), i + 1,
                       f"{i:02d}.png", np.array([[1.5, 2.5]]),
                       np.array([1], np.int64))
    err = np.linspace(0.1, 0.9, len(xyz))
    if binary:
        tcolmap.write_cameras_binary(os.path.join(sparse_dir, "cameras.bin"),
                                     ccams)
        tcolmap.write_images_binary(os.path.join(sparse_dir, "images.bin"),
                                    ims)
        tcolmap.write_points3D_binary(
            os.path.join(sparse_dir, "points3D.bin"), xyz, rgb, err)
        return
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for c in ccams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        for im in ims.values():
            f.write(f"{im.id} " + " ".join(repr(float(q)) for q in im.qvec)
                    + " " + " ".join(repr(float(t)) for t in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(f"{x!r} {y!r} {p}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3D_ids)) + "\n")
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as f:
        for j, (p, c, e) in enumerate(zip(xyz.tolist(), rgb.tolist(),
                                          err.tolist())):
            f.write(f"{j + 1} {p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} "
                    f"{c[2]} {e!r}\n")


@functools.lru_cache(maxsize=None)
def _scene(n_views, H, W, seed):
    """The synthetic scene's capture, rendered once per process and size,
    on one thread (tests/torch_threads.py)."""
    with on_one_thread():
        return synthetic.make_scene(n_views=n_views, H=H, W=W, seed=seed,
                                    device="cpu")


def write_capture(root, n_views=6, H=40, W=56, seed=0, ext=".png",
                  masks=False, normals=True, depths=False, distort=False,
                  sfm="colmap"):
    """A capture of the synthetic reflective scene in easyvolcap layout:
    images/<cam>/000000<ext> (the port's renders), intri.yml / extri.yml,
    optional masks/, normals/ (png) and depths/ (.npy), camera "01" with
    OpenCV distortion when `distort`, the base points (the scene's surfel
    centres, perturbed) as a binary COLMAP model under sparse/0 (`sfm`
    "colmap"), a sparse/0/points3D.ply ("ply") or a metadata.json box
    ("metadata"), and envs/points3D.ply (the dome). -> the scene."""
    rng = np.random.default_rng(seed)
    scene = _scene(n_views, H, W, seed)
    cams = {}
    for i, cam in enumerate(scene.cams):
        name = f"{i:02d}"
        D = DISTORTION if (distort and i == 1) else np.zeros(5)
        cams[name] = dict(K=cam.K.numpy(), R=cam.R.numpy(),
                          T=cam.T.numpy().reshape(3, 1), H=H, W=W,
                          D=D.reshape(5, 1))
        maps = [("images", scene.images[i], ext)]
        if masks:
            maps.append(("masks", scene.masks[i][..., 0], ".png"))
        if normals:
            maps.append(("normals", scene.normals[i], ".png"))
        for sub, arr, e in maps:
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
            Image.fromarray(_u8(arr)).save(
                os.path.join(root, sub, name, "000000" + e), quality=95)
        if depths:
            os.makedirs(os.path.join(root, "depths", name), exist_ok=True)
            np.save(os.path.join(root, "depths", name, "000000.npy"),
                    rng.uniform(1, 5, (H, W)).astype(np.float32))
    write_cameras(cams, root)
    act = scene.gt_base.stats.active.numpy()
    xyz = scene.gt_base.params.xyz.numpy()[act]
    xyz = xyz + rng.normal(scale=0.03, size=xyz.shape)
    rgb = rng.integers(0, 256, xyz.shape).astype(np.uint8)
    sparse = os.path.join(root, "sparse", "0")
    if sfm == "colmap":
        write_colmap(sparse, xyz, rgb)
    elif sfm == "ply":
        os.makedirs(sparse, exist_ok=True)
        save_sfm_ply(os.path.join(sparse, "points3D.ply"), xyz, rgb)
    else:
        import json

        with open(os.path.join(root, "metadata.json"), "w") as f:
            json.dump({"bounds": [[-2, -2, 0], [2, 2, 1]]}, f)
    os.makedirs(os.path.join(root, "envs"), exist_ok=True)
    save_sfm_ply(os.path.join(root, "envs", "points3D.ply"),
                 scene.gt_env.params.xyz.numpy(),
                 rng.integers(0, 256, (scene.gt_env.cap, 3)).astype(np.uint8))
    return scene


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """6 views of 40x56 (jpg images, masks, normals, .npy depths, camera 01
    distorted, a binary COLMAP model)."""
    root = str(tmp_path_factory.mktemp("capture"))
    write_capture(root, ext=".jpg", masks=True, depths=True, distort=True)
    return root


# ---------------------------------------------------------------- COLMAP


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_colmap_models_read_equal(tmp_path, binary):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    cams = []
    for _ in range(3):
        q = rng.normal(size=4)
        cams.append((np.array([[60.0, 0, 28.5], [0, 61.0, 20.5], [0, 0, 1]]),
                     jcolmap.qvec_to_rotmat(q), rng.normal(size=3), 40, 56))
    write_colmap(str(tmp_path), xyz, rgb, binary=binary, cams=cams)
    got = tcolmap.load_colmap_model(str(tmp_path))
    want = jcolmap.load_colmap_model(str(tmp_path))
    assert got[0].keys() == want[0].keys() and got[1].keys() == want[1].keys()
    for k, c in want[0].items():
        g = got[0][k]
        assert (g.id, g.model, g.width, g.height) == (c.id, c.model, c.width,
                                                      c.height)
        np.testing.assert_array_equal(g.params, c.params)
    for k, im in want[1].items():
        g = got[1][k]
        assert (g.id, g.camera_id, g.name) == (im.id, im.camera_id, im.name)
        for a, b in ((g.qvec, im.qvec), (g.tvec, im.tvec), (g.xys, im.xys),
                     (g.point3D_ids, im.point3D_ids)):
            np.testing.assert_array_equal(a, b)
        # the written rotation comes back through the quaternion
        np.testing.assert_allclose(tcolmap.qvec_to_rotmat(g.qvec),
                                   cams[k - 1][1], atol=1e-12)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][0], xyz)
    np.testing.assert_array_equal(got[2][1], rgb)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_PINHOLE", [50.0, 20.0, 15.0]),
    ("PINHOLE", [50.0, 51.0, 20.0, 15.0]),
    ("SIMPLE_RADIAL", [50.0, 20.0, 15.0, 0.01]),
    ("RADIAL", [50.0, 20.0, 15.0, 0.01, -0.002]),
    ("OPENCV", [50.0, 51.0, 20.0, 15.0, 0.01, -0.002, 1e-3, 2e-3]),
])
def test_colmap_intrinsics_equal(model, params):
    q = np.array([0.9, 0.1, -0.3, 0.2])
    np.testing.assert_array_equal(tcolmap.qvec_to_rotmat(q),
                                  jcolmap.qvec_to_rotmat(q))
    args = (1, model, 40, 30, np.asarray(params))
    tc, jc = tcolmap.ColmapCamera(*args), jcolmap.ColmapCamera(*args)
    np.testing.assert_array_equal(tcolmap.camera_K(tc), jcolmap.camera_K(jc))
    np.testing.assert_array_equal(tcolmap.camera_dist(tc),
                                  jcolmap.camera_dist(jc))


# ---------------------------------------------------------- native loader


def _native_image(tmp_path):
    x = np.linspace(0, 4 * np.pi, 96)
    img = np.stack([np.outer(np.sin(x), np.cos(x)),
                    np.outer(np.cos(x / 2), np.sin(x / 3)),
                    np.outer(np.sin(x / 4), np.ones_like(x))], -1) * .5 + .5
    paths = {}
    for ext in ("jpg", "png"):
        paths[ext] = str(tmp_path / f"a.{ext}")
        Image.fromarray(_u8(img)).save(paths[ext], quality=98)
    return paths


@pytest.mark.parametrize("ext,size,distort", [
    ("png", 96, False), ("jpg", 96, False), ("png", 48, False),
    ("jpg", 40, True)], ids=["png", "jpeg", "resize", "undistort"])
def test_native_loader_bit_equal(tmp_path, ext, size, distort):
    # decided here, not at import: the first call builds the library
    if not (tnative.available() and jnative.available()):
        pytest.skip("native loader not built (no compiler or library)")
    path = _native_image(tmp_path)[ext]
    K = np.array([[80.0, 0, 47.5], [0, 80.0, 47.5], [0, 0, 1]])
    kd = (K, DISTORTION) if distort else ()
    got = tnative.NativeLoader(2).load(path, size, size, *kd)
    want = jnative.NativeLoader(2).load(path, size, size, *kd)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if distort:  # the undistortion moved pixels
        plain = tnative.NativeLoader(2).load(path, size, size)
        assert np.abs(plain - got).max() > 0.01


def test_native_library_builds_into_the_port(tmp_path):
    """The port's library lives under envgs_tpu_torch/_build, named by a
    hash of the source and the command; native/ is left as it is."""
    path = tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "envgs_tpu_torch"
    if tnative.available():
        assert path.exists()


# ------------------------------------------------------- MultiViewDataset


def _assert_items_equal(tds_, jds_):
    assert len(tds_) == len(jds_) > 0
    assert [v.name for v in tds_.views] == [v.name for v in jds_.views]
    for i in range(len(jds_)):
        g, w = tds_[i], jds_[i]
        assert set(g) == set(w), (set(g), set(w))
        assert g["name"] == w["name"] and g["index"] == w["index"]
        for k in ("rgb", "msk", "norm", "dpt"):
            if k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        gc, wc = g["camera"], w["camera"]
        assert (gc.H, gc.W, gc.znear, gc.zfar) == (wc.H, wc.W, wc.znear,
                                                   wc.zfar)
        assert gc.K.device.type == "cpu"
        for a, b in ((gc.K, wc.K), (gc.R, wc.R), (gc.T, wc.T),
                     (gc.center, wc.center)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=CAM_ATOL, rtol=0)
    np.testing.assert_allclose(tds_.spatial_scale, jds_.spatial_scale,
                               rtol=1e-6)
    np.testing.assert_allclose(tds_.center, jds_.center, atol=CAM_ATOL)


@pytest.mark.parametrize("kw", [
    dict(split="train"),
    dict(split="val", eval_every=4),
    dict(split="train", eval_every=4, view_sample=[0, None, 2]),
    dict(split="train", eval_every=0, view_sample=[5, 1, 3, 0]),
    dict(split="train", ratio=0.5, use_masks=True, use_normals=True,
         use_depths=True),
    dict(split="val", eval_every=2, ratio=0.5, use_masks=True,
         use_normals=True, use_depths=True),
], ids=["train", "val", "begin-end-step", "explicit", "ratio-maps",
        "val-ratio-maps"])
def test_multiview_dataset_items_equal(capture, kw):
    got = tds.MultiViewDataset(capture, device="cpu", **kw)
    want = jds.MultiViewDataset(capture, **kw)
    _assert_items_equal(got, want)
    assert sum(got.decoders.values()) == len(got)
    if "01" in [v.name for v in got.views] and tnative.available():
        # the distorted camera: undistortion by the native loader
        assert np.abs(got.views[[v.name for v in got.views].index(
            "01")].D).max() > 0


@pytest.mark.parametrize("sfm", ["ply", "colmap", "metadata"])
def test_load_sfm_branches_equal(tmp_path, sfm):
    write_capture(str(tmp_path), n_views=6, H=24, W=32, sfm=sfm)
    got = tds.MultiViewDataset(str(tmp_path), device="cpu").load_sfm()
    want = jds.MultiViewDataset(str(tmp_path)).load_sfm()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == (4096 if sfm == "metadata" else 900)
    env = tds.MultiViewDataset(str(tmp_path), device="cpu").load_sfm(
        os.path.join(str(tmp_path), "envs", "points3D.ply"))
    assert len(env[0]) == 512  # an explicit ply wins


def _views_config(root, **sampler):
    return {
        "dataset_cfg": {"source": "multiview", "data_root": root,
                        "eval_every": 0, "use_normals": True, "ratio": 0.5,
                        "view_sample": [1, 2, 3, 5]},
        "val_dataset_cfg": {"view_sample": [0, 4]},
        "model_cfg": {"sampler_cfg": {
            "preload_gs": os.path.join(root, "sparse", "0", "points3D.ply"),
            "env_bounds": [[-3, -3, -3], [3, 3, 3]], **sampler}},
    }


@pytest.mark.parametrize("pinned", [False, True], ids=["sphere", "pinned"])
def test_load_views_multiview_equal(tmp_path, pinned):
    """cli._load_views' multiview branch: the val_dataset_cfg overlay,
    preload_gs (a missing ply falls through to the COLMAP model),
    env_bounds, the pinned or the camera sphere's spatial_scale."""
    root = str(tmp_path)
    write_capture(root, n_views=6, H=24, W=32)
    raw = _views_config(root, **({"spatial_scale": 4.25} if pinned else {}))
    got = cli._load_views(Config.wrap(raw), device="cpu")
    want = jcli._load_views(JConfig.wrap(raw))
    gv, wv = got[:2], want[:2]
    for g, w in zip(gv, wv):
        assert [v["name"] for v in g] == [v["name"] for v in w]
        for a, b in zip(g, w):
            for k in ("rgb", "msk", "norm"):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a["camera"].K.numpy(),
                                       np.asarray(b["camera"].K),
                                       atol=CAM_ATOL)
    assert [v["name"] for v in got[0]] == ["01", "02", "03", "05"]
    assert [v["name"] for v in got[1]] == ["00", "04"]
    assert got[0][0]["camera"].H == 12
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] == [[-3, -3, -3], [3, 3, 3]]
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6)
    if pinned:
        assert got[5] == 4.25


def test_dataset_cameras_on_the_requested_device(tmp_path):
    root = str(tmp_path)
    write_capture(root, n_views=6, H=24, W=32)
    ds = tds.MultiViewDataset(root, device="cpu")
    assert ds[0]["camera"].K.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tds.MultiViewDataset(root)  # the card by default

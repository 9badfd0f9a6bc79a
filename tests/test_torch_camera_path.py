"""The host-side pieces of the port's `render` mode and recorder against the
JAX package: camera paths of every kind from the same numpy cameras, the
OpenCV-YAML camera files written by one package and read by the other, and
the tensorboard recorder's smoothed values and files."""
import numpy as np
import pytest
import torch
import yaml

from envgs_tpu.train import recorder as jrec
from envgs_tpu.utils import camera as jcam
from envgs_tpu.utils import easycam as jeasy
from envgs_tpu_torch.train import recorder as trec
from envgs_tpu_torch.utils import camera as tcam
from envgs_tpu_torch.utils import easycam as teasy

H, W = 24, 40


def _ring(n=5, seed=0):
    """n cameras (numpy K, R, T) on a jittered ring about a point, each
    looking at it, y down (as a capture ring is)."""
    rng = np.random.default_rng(seed)
    look = np.array([0.1, -0.2, 0.3])
    out = []
    for i in range(n):
        t = 2 * np.pi * i / n + rng.normal(scale=0.1)
        c = look + np.array([3 * np.cos(t), -0.8 + rng.normal(scale=0.1),
                             3 * np.sin(t)])
        fwd = (look - c) / np.linalg.norm(look - c)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd]).astype(np.float32)
        f = 30.0 + i
        K = np.array([[f, 0, W / 2 + i], [0, f + 1, H / 2], [0, 0, 1]],
                     np.float32)
        out.append((K, R, (-R @ c).astype(np.float32)))
    return out


@pytest.mark.parametrize("kind", ["orbit", "spiral", "linear", "cubic"])
def test_camera_path_matches_jax(kind):
    cams = _ring()
    want = jcam.camera_path_interpolate(
        [jcam.make_camera(H, W, K, R, T, 0.02, 50.0) for K, R, T in cams], 7,
        kind=kind)
    got = tcam.camera_path_interpolate(
        [tcam.make_camera(H, W, K, R, T, 0.02, 50.0, device="cpu")
         for K, R, T in cams], 7, kind=kind)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert (g.H, g.W, g.znear, g.zfar) == (w.H, w.W, w.znear, w.zfar)
        for name in ("K", "R", "T"):
            x = getattr(g, name)
            assert x.dtype == torch.float32 and x.device.type == "cpu"
            np.testing.assert_allclose(
                x.numpy(), np.asarray(getattr(w, name)), rtol=1e-5, atol=1e-5,
                err_msg=name)
        R = g.R.numpy().astype(np.float64)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(R) > 0.99
    if kind in ("orbit", "spiral"):  # every frame faces the ring's centre
        centers = np.stack([-R.T @ T for _, R, T in cams])
        c0 = centers.mean(0)
        for g in got:
            c = -g.R.numpy().T @ g.T.numpy()
            d = (c0 - c) / np.linalg.norm(c0 - c)
            assert float(d @ g.R.numpy()[2]) > 0.9999
    else:  # through the first and the last camera
        for g, (K, R, T) in ((got[0], cams[0]), (got[-1], cams[-1])):
            np.testing.assert_allclose(g.R.numpy(), R, atol=1e-5)
            np.testing.assert_allclose(g.T.numpy(), T, atol=1e-5)


def test_camera_path_lands_on_the_cameras_device():
    cams = [tcam.make_camera(H, W, K, R, T, device="cpu")
            for K, R, T in _ring(3)]
    for kind in ("orbit", "cubic"):
        path = tcam.camera_path_interpolate(cams, 2, kind=kind)
        assert all(c.K.device == c.R.device == c.T.device == cams[0].K.device
                   for c in path)


def _cam_dict(seed):
    out = {}
    for i, (K, R, T) in enumerate(_ring(3, seed)):
        out[f"{i:02d}"] = {"K": K.astype(np.float64),
                           "R": R.astype(np.float64),
                           "T": T.astype(np.float64).reshape(3, 1),
                           "H": H, "W": W, "n": 0.1 + i, "f": 9.0, "t": 0.5}
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_camera_files_cross_between_the_packages(tmp_path, writer):
    """Files written by one package's write_cameras read back equal by both
    packages' read_cameras (names, K, R from Rot, T, sizes, planes,
    timestamp)."""
    cams = _cam_dict(1)
    (jeasy if writer == "jax" else teasy).write_cameras(cams, str(tmp_path))
    got = teasy.read_cameras(str(tmp_path))
    want = jeasy.read_cameras(str(tmp_path))
    assert list(got) == list(want) == list(cams)
    for name, cam in cams.items():
        g, w = got[name], want[name]
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
        np.testing.assert_allclose(g["K"], cam["K"], rtol=1e-12)
        np.testing.assert_allclose(g["R"], cam["R"], atol=1e-12)
        np.testing.assert_allclose(g["T"], cam["T"], atol=1e-12)
        assert (g["H"], g["W"], g["n"], g["f"], g["t"]) == (H, W, cam["n"],
                                                            9.0, 0.5)


def test_rodrigues_vectors_match_jax(tmp_path):
    """A camera file with only the Rodrigues vector R_ (no Rot_) reads as
    the same rotation; both directions of the conversion equal JAX's, also
    near 180 degrees."""
    rng = np.random.default_rng(2)
    for theta in (0.0, 0.3, 2.0, np.pi - 1e-7):
        axis = rng.normal(size=3)
        rvec = axis / np.linalg.norm(axis) * theta
        R = teasy.rodrigues(rvec)
        np.testing.assert_array_equal(R, jeasy.rodrigues(rvec))
        np.testing.assert_array_equal(teasy.rodrigues_inv(R),
                                      jeasy.rodrigues_inv(R))
        np.testing.assert_allclose(teasy.rodrigues(teasy.rodrigues_inv(R)),
                                   R, atol=1e-6)
    cams = _cam_dict(3)
    teasy.write_cameras(cams, str(tmp_path))
    text = (tmp_path / "extri.yml").read_text()
    lines = text.splitlines()
    keep, skip = [], 0
    for line in lines:  # drop every Rot_ matrix (its header and 4 lines)
        if line.startswith("Rot_"):
            skip = 4
            continue
        if skip:
            skip -= 1
            continue
        keep.append(line)
    (tmp_path / "extri.yml").write_text("\n".join(keep) + "\n")
    got = teasy.read_cameras(str(tmp_path))
    want = jeasy.read_cameras(str(tmp_path))
    for name, cam in cams.items():
        np.testing.assert_array_equal(got[name]["R"], want[name]["R"])
        np.testing.assert_allclose(got[name]["R"], cam["R"], atol=1e-6)


def test_smoothed_values_match_jax():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=37).tolist() + [float("inf"), 3.0]
    for window in (1, 5, 20):
        a, b = trec.SmoothedValue(window), jrec.SmoothedValue(window)
        assert a.median == b.median == 0.0 and a.avg == b.avg == 0.0
        for v in vals:
            a.update(v)
            b.update(v)
            assert a.median == b.median
            assert a.avg == b.avg or (np.isnan(a.avg) and np.isnan(b.avg))
        assert a.count == b.count == len(vals)


def test_recorder_writes_events_and_config(tmp_path):
    cfg = {"exp_name": "rec", "runner_cfg": {"epochs": 2},
           "model_cfg": {"sampler_cfg": {"pool_cap": 1280}}}
    rec = trec.Recorder(str(tmp_path / "rec"), resolved_config=cfg)
    assert rec.writer is not None
    for it in range(3):
        rec.record("TRAIN", {"loss": 1.0 / (it + 1), "psnr": 10.0 + it},
                   it=it)
    rec.record("VAL", {"psnr_mean": 21.5},
               image_stats={"RENDER": torch.rand(H, W, 3)})
    assert rec.iter == 2 and rec.state_dict() == {"iter": 2}
    assert rec.scalars["loss"].median == float(np.median([1, 0.5, 1 / 3]))
    rec.close()
    with open(tmp_path / "rec" / "config.yaml") as f:
        assert yaml.safe_load(f) == cfg
    events = list((tmp_path / "rec").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0
    again = trec.Recorder(str(tmp_path / "other"), enabled=False,
                          resolved_config=cfg)
    again.load_state_dict(rec.state_dict())
    assert again.iter == 2 and again.writer is None
    again.record("TRAIN", {"loss": 2.0})
    assert again.iter == 2 and not (tmp_path / "other").exists()

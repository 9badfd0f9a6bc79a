"""Parity of the port's video dataset and index samplers
(data/video_dataset.py) with the JAX package, on captures written into
tmp_path (`images/<cam>/<frame>.jpg` and the cameras, as
tests/test_video_dataset.py writes them): the (view, frame) items and
their t / frame_index / latent_index, frame sharding with global time, the
samplers' index sequences, the image-based datasets' source stacks.
"""
import os

import numpy as np
import torch
from PIL import Image

from envgs_tpu.data import video_dataset as jvd
from envgs_tpu.utils.camera import make_camera
from envgs_tpu.utils.easycam import write_cameras
from envgs_tpu_torch.data import video_dataset as tvd
from envgs_tpu_torch.utils import camera as tcam


def _make_capture(root, n_views=3, n_frames=5, H=16, W=20):
    rng = np.random.default_rng(0)
    cams = {}
    for v in range(n_views):
        name = f"{v:02d}"
        cams[name] = dict(
            K=np.array([[25.0, 0, W / 2], [0, 25.0, H / 2], [0, 0, 1]]),
            D=np.zeros((5, 1)), R=np.eye(3),
            T=np.array([[0.3 * v], [0.0], [0.0]]), H=H, W=W)
        d = os.path.join(root, "images", name)
        os.makedirs(d)
        for f in range(n_frames):
            arr = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{f:06d}.jpg"))
    write_cameras(cams, root)
    return cams


def _both(cls, root, **kw):
    return (getattr(jvd, cls)(root, cache_images=False, **kw),
            getattr(tvd, cls)(root, cache_images=False, device="cpu", **kw))


def _same_items(jds, tds):
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        for k in ("t", "frame_index", "latent_index", "name"):
            assert b[k] == a[k], (i, k)
        np.testing.assert_array_equal(b["rgb"], np.asarray(a["rgb"]))
        np.testing.assert_allclose(b["camera"].K.numpy(),
                                   np.asarray(a["camera"].K))
    assert list(tds.frame_ids) == list(jds.frame_ids)


def test_video_items_and_t(tmp_path):
    _make_capture(str(tmp_path))
    jds, tds = _both("MultiViewVideoDataset", str(tmp_path),
                     frame_sample=[0, None, 2], eval_every=0)
    assert len(tds) == 9 and tds.n_frames == jds.n_frames == 3
    assert tds.n_views == jds.n_views == 3
    assert sorted({round(tds[i]["t"], 3) for i in range(9)}) == [0.0, 0.5,
                                                                1.0]
    _same_items(jds, tds)


def test_frame_sharding(tmp_path):
    _make_capture(str(tmp_path), n_frames=6)
    shards = []
    for rank in range(2):
        jds, tds = _both("MultiViewVideoDataset", str(tmp_path),
                         frame_shard=(rank, 2), eval_every=0)
        _same_items(jds, tds)
        shards.append({os.path.basename(v.image_path) for v in tds.views})
    assert shards[0] & shards[1] == set()
    assert len(shards[0] | shards[1]) == 6


def test_frame_sharding_keeps_global_time(tmp_path):
    _make_capture(str(tmp_path), n_views=1, n_frames=6)
    by_file = {}
    for rank in range(2):
        jds, tds = _both("MultiViewVideoDataset", str(tmp_path),
                         frame_shard=(rank, 2), eval_every=0)
        assert tds.n_frames == 6
        _same_items(jds, tds)
        for i in range(len(tds)):
            fname = os.path.basename(tds.views[i].image_path)
            by_file.setdefault(fname, []).append(
                (tds[i]["frame_index"], round(tds[i]["t"], 4)))
    assert by_file["000002.jpg"] == [(2, 0.4)]
    assert by_file["000005.jpg"] == [(5, 1.0)]


def test_samplers_match_jax(tmp_path):
    """Every sampler's index sequence equal to JAX's from the same seeds
    (the registry names are the reference's)."""
    from envgs_tpu_torch.engine import DATASAMPLERS

    _make_capture(str(tmp_path), n_views=2, n_frames=4)
    jds, tds = _both("MultiViewVideoDataset", str(tmp_path), eval_every=0)
    n = len(tds)
    assert list(tvd.SequentialSampler(n)) == list(jvd.SequentialSampler(n))
    for seed in (0, 3):
        assert list(tvd.RandomSampler(n, seed)) == list(
            jvd.RandomSampler(n, seed))
    got = list(tvd.IterationBasedBatchSampler(tvd.RandomSampler(n),
                                              batch_size=3, max_iter=7))
    want = list(jvd.IterationBasedBatchSampler(jvd.RandomSampler(n),
                                               batch_size=3, max_iter=7))
    assert got == want and len(got) == 7
    ts, js = (tvd.SameFrameBatchSampler(tds, 2, seed=1),
              jvd.SameFrameBatchSampler(jds, 2, seed=1))
    for _ in range(2):  # a second pass draws on
        assert list(ts) == list(js)
    for b in tvd.SameFrameBatchSampler(tds, batch_size=2):
        assert len({tds[i]["frame_index"] for i in b}) == 1
    stream = list(tvd.StreamSampler(tds, seed=2))
    assert stream == list(jvd.StreamSampler(jds, seed=2))
    frames = [tds[i]["frame_index"] for i in stream]
    assert frames == sorted(frames) and len(frames) == 4
    assert {"SequentialSampler", "RandomSampler",
            "IterationBasedBatchSampler", "SameFrameBatchSampler",
            "StreamSampler"} <= set(DATASAMPLERS._modules)


def test_iteration_sampler_smaller_than_batch():
    batches = list(tvd.IterationBasedBatchSampler(
        tvd.SequentialSampler(3), batch_size=4, max_iter=3))
    assert batches == list(jvd.IterationBasedBatchSampler(
        jvd.SequentialSampler(3), batch_size=4, max_iter=3))
    assert [i for b in batches for i in b] == [0, 1, 2] * 4


def test_image_based_dataset(tmp_path):
    """Source stacks by camera distance (the capture's centres differ), the
    target left out, with and without the jittered pool, as JAX's."""
    _make_capture(str(tmp_path), n_views=5, n_frames=1)
    for extra in (0, 2):
        jds, tds = _both("ImageBasedDataset", str(tmp_path), n_srcs=2,
                         extra_src_pool=extra, eval_every=0)
        for i in range(5):
            a, b = jds[i], tds[i]
            assert b["src_indices"] == a["src_indices"] and i not in (
                b["src_indices"])
            assert b["src_inps"].shape == (2, 16, 20, 3)
            np.testing.assert_array_equal(b["src_inps"], a["src_inps"])
            assert len(b["src_cams"]) == 2
        if not extra:
            assert sorted(tds.src_indices_for(0)) == [1, 2]


def test_image_based_streaming_dataset():
    """Live source stacks: a fresh frame per item, the nearest views of a
    target, no ground truth; the registry name is the reference's."""
    from envgs_tpu_torch.engine import DATASETS

    Kc = np.array([[50, 0, 16], [0, 50, 16], [0, 0, 1]], np.float32)
    jc = [make_camera(32, 32, Kc, np.eye(3, dtype=np.float32),
                      np.array([i * 1.0, 0, 0], np.float32)) for i in range(4)]
    tc = [tcam.make_camera(32, 32, Kc, np.eye(3, dtype=np.float32),
                           np.array([i * 1.0, 0, 0], np.float32))
          for i in range(4)]
    counter = [0]

    def src():
        counter[0] += 1
        return np.full((4, 32, 32, 3), counter[0], np.float32)

    jds = jvd.ImageBasedStreamingDataset(jc, src, n_srcs=2)
    tds = tvd.ImageBasedStreamingDataset(tc, src, n_srcs=2)
    for i in range(6):
        a, b = jds[i], tds[i]
        assert b["src_indices"] == a["src_indices"]
        assert b["src_inps"].max() == a["src_inps"].max() + 1  # fresh
        assert (b["view_index"], b["frame_index"]) == (a["view_index"],
                                                       a["frame_index"])
        assert b["stream"] and "rgb" not in b
    assert tds.get_sources(tc[3])["src_indices"] == jds.get_sources(
        jc[3])["src_indices"] == [2, 1]
    assert len(tds) > 10 ** 8 and "ImageBasedStreamingDataset" in DATASETS
    assert torch.equal(tds[0]["camera"].K, tc[0].K)

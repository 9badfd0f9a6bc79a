"""Volumetric-video dataset: the frame axis and the index samplers (port of
envgs_tpu/data/video_dataset.py, host-side numpy).

- `MultiViewVideoDataset`: one item per (view, frame) of a capture in
  easymocap layout (`images/<cam>/<frame>.jpg`); `frame_sample=[begin,
  end, step]` selects frames; items carry `t` (normalized time),
  `frame_index` and `latent_index`; `frame_shard=(rank, world_size)`
  splits the frames as the reference's `ims[:, rank::world_size]`, the
  time of a frame its global position.
- The index samplers (registered in `engine.DATASAMPLERS`):
  `SequentialSampler`, `RandomSampler`, `IterationBasedBatchSampler`
  (epoch-free batches up to max_iter), `SameFrameBatchSampler` (a batch's
  items share one frame), `StreamSampler` (frames in order, a random view
  within each).
- `ImageBasedDataset` (a target view and its nearest source views, the
  image-based families' items) and `ImageBasedStreamingDataset` (live
  source stacks from a frame callable).
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from envgs_tpu_torch.data.dataset import MultiViewDataset, View
from envgs_tpu_torch.engine import DATASAMPLERS, DATASETS


def _center(cam) -> np.ndarray:
    """A camera's (3,) center on the host, float32."""
    return cam.center.detach().cpu().numpy()


@DATASETS.register
class MultiViewVideoDataset(MultiViewDataset):
    """Multi-view and multi-frame dataset (one item per (view, frame))."""

    def __init__(self, data_root: str, frame_sample: list | None = None,
                 frame_shard: tuple | None = None, **kwargs):
        super().__init__(data_root, **kwargs)
        b, e, s = ((frame_sample or [0, None, 1]) + [None, None, None])[:3]
        # every view's frames again (the base class keeps one frame a view)
        masks_dir = kwargs.get("masks_dir", "masks")
        normals_dir = kwargs.get("normals_dir", "normals")
        vf: list[View] = []
        frame_ids: list[int] = []
        n_frames = 0
        for v in self.views:
            img_dir = os.path.dirname(v.image_path)
            frames = sorted(os.listdir(img_dir))
            e_v = len(frames) if e in (None, -1) else min(e, len(frames))
            sel_all = list(range(b or 0, e_v, s or 1))
            pairs = list(enumerate(sel_all))
            if frame_shard is not None:
                # global frame positions survive the split: t and
                # latent_index name the same frame on every rank
                rank, world = frame_shard
                pairs = pairs[rank::world]
            n_frames = max(n_frames, len(sel_all))
            for fi, fidx in pairs:
                fname = frames[fidx]
                mp = os.path.join(self.data_root, masks_dir, v.name, fname)
                np_ = os.path.join(self.data_root, normals_dir, v.name, fname)
                vf.append(View(
                    v.name, v.camera, os.path.join(img_dir, fname),
                    self._fuzzy(mp) if self.use_masks else None,
                    self._fuzzy(np_) if self.use_normals else None,
                    v.K_orig, v.D, v.H, v.W))
                frame_ids.append(fi)
        self.views = vf
        self.frame_ids = np.asarray(frame_ids, np.int32)
        self.n_frames = max(n_frames, 1)
        self.n_views = len({v.name for v in vf})

    def __getitem__(self, i: int) -> dict:
        item = dict(super().__getitem__(i))
        fi = int(self.frame_ids[i])
        item["frame_index"] = fi
        item["latent_index"] = fi
        item["t"] = fi / max(self.n_frames - 1, 1)
        return item


# ---------------------------------------------------------------------------
# index samplers (the reference's datasamplers.py)
# ---------------------------------------------------------------------------

@DATASAMPLERS.register
class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.n))

    def __len__(self):
        return self.n


@DATASAMPLERS.register
class RandomSampler:
    def __init__(self, n: int, seed: int = 0):
        self.n, self.rng = n, np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


@DATASAMPLERS.register
class IterationBasedBatchSampler:
    """Batches of `batch_size` from a sampler, pass after pass, up to
    `max_iter` batches: epoch-free training."""

    def __init__(self, sampler, batch_size: int = 1,
                 max_iter: int = 10 ** 9, start_iter: int = 0):
        self.sampler, self.batch_size = sampler, batch_size
        self.max_iter, self.start_iter = max_iter, start_iter

    def __iter__(self):
        it = self.start_iter
        batch = []  # kept across passes: a sampler shorter than a batch
        while it < self.max_iter:  # fills it over several
            for idx in self.sampler:
                batch.append(idx)
                if len(batch) == self.batch_size:
                    yield batch
                    batch = []
                    it += 1
                    if it >= self.max_iter:
                        return

    def __len__(self):
        return self.max_iter - self.start_iter


def _by_frame(dataset) -> dict[int, list[int]]:
    by_frame: dict[int, list[int]] = {}
    for i, fi in enumerate(np.asarray(dataset.frame_ids)):
        by_frame.setdefault(int(fi), []).append(i)
    return by_frame


@DATASAMPLERS.register
class SameFrameBatchSampler:
    """Batches whose items all share one frame, the frames shuffled."""

    def __init__(self, dataset: MultiViewVideoDataset, batch_size: int = 1,
                 seed: int = 0):
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.by_frame = _by_frame(dataset)

    def __iter__(self):
        frames = list(self.by_frame)
        self.rng.shuffle(frames)
        for f in frames:
            idxs = self.by_frame[f]
            sel = self.rng.choice(idxs, size=min(self.batch_size, len(idxs)),
                                  replace=False)
            yield [int(x) for x in sel]

    def __len__(self):
        return len(self.by_frame)


@DATASAMPLERS.register
class StreamSampler:
    """Frames strictly in order, a random view within each (the online
    streaming regime)."""

    def __init__(self, dataset: MultiViewVideoDataset, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.by_frame = _by_frame(dataset)

    def __iter__(self):
        for f in sorted(self.by_frame):
            yield int(self.rng.choice(self.by_frame[f]))

    def __len__(self):
        return len(self.by_frame)


@DATASETS.register
class ImageBasedDataset(MultiViewDataset):
    """A target view and its `n_srcs` nearest views (by camera center, the
    target left out): items add `src_inps` (S, H, W, 3), `src_cams` and
    `src_indices`. With `extra_src_pool` the sources are drawn from the
    n_srcs + extra_src_pool nearest."""

    def __init__(self, data_root: str, n_srcs: int = 3,
                 extra_src_pool: int = 0, seed: int = 0, **kwargs):
        super().__init__(data_root, **kwargs)
        self.n_srcs = n_srcs
        self.extra_src_pool = extra_src_pool
        self._rng = np.random.default_rng(seed)
        self._centers = np.stack([_center(v.camera) for v in self.views])

    def src_indices_for(self, i: int) -> list[int]:
        d = np.linalg.norm(self._centers - self._centers[i], axis=-1)
        d[i] = np.inf
        pool = np.argsort(d)[: self.n_srcs + self.extra_src_pool]
        if self.extra_src_pool > 0:
            pool = self._rng.choice(pool, size=self.n_srcs, replace=False)
        return [int(x) for x in pool[: self.n_srcs]]

    def __getitem__(self, i: int) -> dict:
        item = dict(super().__getitem__(i))
        src = self.src_indices_for(i)
        item["src_indices"] = src
        item["src_inps"] = np.stack(
            [super(ImageBasedDataset, self).__getitem__(j)["rgb"]
             for j in src])
        item["src_cams"] = [self.views[j].camera for j in src]
        return item


@DATASETS.register
class ImageBasedStreamingDataset:
    """Live source-view stacks for image-based rendering without ground
    truth. `frame_source` () -> (V, H, W, 3) float32 is the latest frame of
    every calibrated view (a socket receiver, a directory poller, a
    generator); the calibration (`cameras`, one per view) is fixed; items
    never run out (`max_len`) and stack the `n_srcs` views nearest the
    target camera."""

    def __init__(self, cameras: list, frame_source, n_srcs: int = 3,
                 max_len: int = 1_000_000_000):
        assert len(cameras) >= n_srcs
        self.cameras = cameras
        self.frame_source = frame_source
        self.n_srcs = n_srcs
        self.max_len = max_len
        self._centers = np.stack([_center(c) for c in cameras])

    def __len__(self):
        return self.max_len

    def src_indices_for(self, target_center: np.ndarray) -> list[int]:
        d = np.linalg.norm(self._centers - np.asarray(target_center),
                           axis=-1)
        if len(d) > self.n_srcs:
            # a view at the target's center is the target: not its source
            d = np.where(d < 1e-6, np.inf, d)
        return [int(x) for x in np.argsort(d)[: self.n_srcs]]

    def get_sources(self, target_cam) -> dict:
        """The latest frames of the n_srcs views nearest `target_cam`."""
        frames = np.asarray(self.frame_source(), np.float32)
        src = self.src_indices_for(_center(target_cam))
        return dict(src_inps=np.stack([frames[j] for j in src]),
                    src_cams=[self.cameras[j] for j in src],
                    src_indices=src, stream=True)

    def __getitem__(self, i: int) -> dict:
        # the target goes round the calibrated views (a viewer hands its
        # own camera to get_sources)
        cam = self.cameras[i % len(self.cameras)]
        item = self.get_sources(cam)
        item["camera"] = cam
        item["view_index"] = i % len(self.cameras)
        item["frame_index"] = i // len(self.cameras)
        return item

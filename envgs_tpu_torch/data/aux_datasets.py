"""Auxiliary datasets (port of envgs_tpu/data/aux_datasets.py):
GeometryDataset (per-frame voxel-grid batches for geometry extraction,
optionally carved to the visual hull) and NoopDataset (camera and metadata
batches with no image IO, the feed of inference and GUI rendering).

Items are plain numpy dicts, as the JAX package's are; the grids are
padded to a fixed row count with a `valid` mask.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from envgs_tpu_torch.engine import DATASETS


def create_meshgrid_3d(bounds, voxel_size: float) -> np.ndarray:
    """(X, Y, Z, 3) world-space grid covering `bounds` at `voxel_size`."""
    lo = np.asarray(bounds[0], np.float64)
    hi = np.asarray(bounds[1], np.float64)
    axes = [np.arange(lo[i], hi[i] + 1e-9, voxel_size, dtype=np.float32)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1)


@DATASETS.register
class GeometryDataset:
    """Per-frame voxel-grid batches: dict(xyz (P, 3), dir (P, 3) towards
    the origin, dist (P, 1), valid (P,), bounds (2, 3), voxel_size,
    frame_index, t). With `use_space_carving_initialization`, cameras (port
    Cameras) and per-frame masks, each frame's grid is the visual hull
    (utils/fusion.py) at the voxel size, carved on the cameras' device."""

    def __init__(
        self,
        bounds: Sequence[Sequence[float]] = ((-1, -1, -1), (1, 1, 1)),
        voxel_size: float = 0.05,
        n_frames: int = 1,
        duration: float = 1.0,
        use_space_carving_initialization: bool = False,
        cameras: list | None = None,  # Cameras, for carving
        masks: list | None = None,  # per frame, a list of (H, W) fg masks
        pad_to: int | None = None,
    ):
        self.bounds = np.asarray(bounds, np.float32)
        self.voxel_size = float(voxel_size)
        self.n_frames = int(n_frames)
        self.duration = float(duration)
        self.pad_to = pad_to

        flat = create_meshgrid_3d(self.bounds, self.voxel_size).reshape(-1, 3)
        self._items = []
        for f in range(self.n_frames):
            xyz = flat
            if use_space_carving_initialization and cameras:
                from envgs_tpu_torch.utils.fusion import visual_hull

                res = max(2, int(round(
                    float((self.bounds[1] - self.bounds[0]).max())
                    / self.voxel_size)))
                m = torch.as_tensor(np.stack(masks[f]),
                                    device=cameras[0].K.device)
                hull = visual_hull(m, cameras,
                                   (self.bounds[0], self.bounds[1]), res=res)
                if len(hull):
                    xyz = hull.cpu().numpy()
            self._items.append(np.asarray(xyz, np.float32))

    def __len__(self):
        return self.n_frames

    def __getitem__(self, i: int) -> dict:
        xyz = self._items[i]
        P = xyz.shape[0]
        n = self.pad_to or P
        valid = np.zeros((n,), bool)
        valid[:min(P, n)] = True
        xyz = np.pad(xyz, ((0, n - P), (0, 0))) if P < n else xyz[:n]
        nrm = np.linalg.norm(xyz, axis=-1, keepdims=True)
        dirs = -xyz / np.maximum(nrm, 1e-8)  # inward, to the origin
        return dict(
            xyz=xyz,
            dir=dirs.astype(np.float32),
            dist=np.full((n, 1), self.voxel_size, np.float32),
            valid=valid,
            bounds=self.bounds,
            voxel_size=np.float32(self.voxel_size),
            frame_index=i,
            t=np.float32(i / max(self.n_frames - 1, 1) * self.duration),
        )


@DATASETS.register
class NoopDataset:
    """Camera and metadata batches with no image IO: H, W, K, R, T per
    (view, frame) from the given (K, R, T) cameras or, without them, an
    orbit of `orbit_n` views about the origin; near / far / bounds and the
    normalized time."""

    def __init__(
        self,
        cameras: list | None = None,  # [(K, R, T)]
        H: int = 512,
        W: int = 512,
        n_frames: int = 1,
        near: float = 0.02,
        far: float = 100.0,
        bounds: Sequence[Sequence[float]] = ((-5, -5, -5), (5, 5, 5)),
        duration: float = 1.0,
        orbit_radius: float | None = None,
        orbit_n: int = 30,
        focal_ratio: float = 1.0,
    ):
        self.H, self.W = int(H), int(W)
        self.near, self.far = float(near), float(far)
        self.bounds = np.asarray(bounds, np.float32)
        self.duration = float(duration)
        self.n_frames = int(n_frames)
        if cameras is None:
            r = orbit_radius if orbit_radius is not None else float(
                np.linalg.norm(self.bounds[1] - self.bounds[0])) * 0.75
            f = focal_ratio * self.W
            K = np.array([[f, 0, self.W / 2], [0, f, self.H / 2],
                          [0, 0, 1]], np.float32)
            cameras = []
            for a in np.linspace(0, 2 * np.pi, orbit_n, endpoint=False):
                fwd = np.array([-np.sin(a), 0.0, -np.cos(a)], np.float32)
                up = np.array([0.0, -1.0, 0.0], np.float32)
                right = np.cross(up, fwd)
                up2 = np.cross(fwd, right)
                R = np.stack([right, up2, fwd]).astype(np.float32)
                T = (-R @ (-fwd * r)).astype(np.float32)
                cameras.append((K, R, T))
        self.cameras = cameras

    @property
    def n_views(self):
        return len(self.cameras)

    def __len__(self):
        return self.n_views * self.n_frames

    def __getitem__(self, i: int) -> dict:
        view, frame = i % self.n_views, i // self.n_views
        K, R, T = self.cameras[view]
        return dict(
            H=self.H, W=self.W,
            K=np.asarray(K, np.float32), R=np.asarray(R, np.float32),
            T=np.asarray(T, np.float32),
            near=np.float32(self.near), far=np.float32(self.far),
            bounds=self.bounds,
            view_index=view, frame_index=frame,
            t=np.float32(frame / max(self.n_frames - 1, 1) * self.duration),
        )

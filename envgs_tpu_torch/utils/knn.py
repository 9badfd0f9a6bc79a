"""Nearest-neighbor scale initialization (port of envgs_tpu/utils/knn.py,
host-side numpy/scipy: it runs once when a pool is created)."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def mean_sq_dist3(xyz: np.ndarray) -> np.ndarray:
    """(P, 3) -> (P,) mean squared distance to the 3 nearest neighbors."""
    d, _ = cKDTree(xyz).query(xyz, k=4)
    return (d[:, 1:] ** 2).mean(axis=-1)


def init_scales_from_dist(xyz: np.ndarray) -> np.ndarray:
    """Initial log-scales (P, 2) = log(sqrt(clamp(d2, 1e-7))) on both axes."""
    d2 = np.clip(mean_sq_dist3(np.asarray(xyz, np.float32)), 1e-7, None)
    s = np.log(np.sqrt(d2))
    return np.repeat(s[:, None], 2, axis=-1).astype(np.float32)

"""Point-sampling grids for environment-Gaussian initialization (the
port's own copy of envgs_tpu/utils/grid.py; numpy only): N random points
in each cell of an S^3 grid over the environment bounds, or uniformly in
the box.
"""
from __future__ import annotations

import numpy as np


def sample_points_subgrid(bounds: np.ndarray, S: int = 16, N: int = 2,
                          seed: int = 0) -> np.ndarray:
    """(2, 3) bounds -> (S^3 * N, 3) jittered grid points."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    edges = [np.linspace(lo[i], hi[i], S + 1) for i in range(3)]
    cell = (hi - lo) / S
    base = np.stack(
        np.meshgrid(*[e[:-1] for e in edges], indexing="ij"), -1
    ).reshape(-1, 3)
    pts = base[:, None, :] + rng.random((base.shape[0], N, 3)) * cell
    return pts.reshape(-1, 3).astype(np.float32)


def sample_points_bbox(bounds: np.ndarray, N: int = 100000,
                       seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    return (lo + rng.random((N, 3)) * (hi - lo)).astype(np.float32)

"""EnvGS's inputs with the reflection on: `envgs.py`'s scene, views,
targets and normal priors, drawn in the same order from the seed, with the
base surfels turned to a smooth normal field, as a trained reflective
scene has (the recipe trains its base against 2DGS's normal consistency
and a monocular normal prior): each base surfel at (x, y, z) takes the
rotation q = (1, 0.18 sin 2x, 0.18 cos 2y, 0.10 sin(x + y)), the field of
the repository's bench scene (`envgs_tpu_torch/bench.py`)."""
from __future__ import annotations

import torch

from benchmark.families import envgs


def smooth_rotations(xyz: torch.Tensor) -> torch.Tensor:
    """(P, 3) centres -> (P, 4) quaternions w, x, y, z of the normal
    field."""
    x, y = xyz[:, 0], xyz[:, 1]
    return torch.stack([torch.ones_like(x), 0.18 * torch.sin(2.0 * x),
                        0.18 * torch.cos(2.0 * y), 0.10 * torch.sin(x + y)],
                       -1)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    inputs = envgs.make_inputs(cfg, traffic, seed, device)
    base = inputs.scene["base"]
    base["rotation"] = smooth_rotations(base["xyz"])
    return inputs
